#!/bin/bash
# Runs C (perturbed init) and D (cuDNN deterministic) of the flagship
# accuracy preset at seed 0, side by side on one card, and brings back
# their result files and train logs under $OUT (default build/p24/results).
set -u
export PYTHONPATH=$PWD PYTHONUNBUFFERED=1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
out=${OUT:-build/p24/results}; mkdir -p $out
args="--preset flagship --bn_mode flax"
pids=""
for v in ${VARIANTS:-perturb cudnn_det}; do
  python build/p24/accuracy_variants.py --variant $v -- $args --output_dir build/p24/out/$v > $out/$v.log 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait $p || rc=$?; done
for v in ${VARIANTS:-perturb cudnn_det}; do
  cp build/p24/out/$v/accuracy_loop.json $out/$v.json 2>/dev/null
  cp build/p24/out/$v/log/train_logs.txt $out/${v}_train_logs.txt 2>/dev/null
  tail -5 $out/$v.log
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit 0
