#!/bin/bash
# A (seed 0 as it is) and B (seed 0, the plain versions of K1-K8) of the flagship
# accuracy preset side by side on one card; then bf16_drift with its k2 and
# bn_reestimate reports on A's final and earliest kept snapshots.
# Everything is written under $OUT (default build/p24/results).
set -u
export PYTHONPATH=$PWD PYTHONUNBUFFERED=1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
out=${OUT:-build/p24/results}; mkdir -p $out
args="--preset flagship --bn_mode flax"
t0=$(date +%s)
python build/p24/accuracy_variants.py --variant base -- $args --output_dir build/p24/out/base > $out/base.log 2>&1 &
pa=$!
python build/p24/accuracy_variants.py --variant off -- $args --output_dir build/p24/out/off > $out/off.log 2>&1 &
pb=$!

wait $pa; echo "A rc $? at $(( $(date +%s) - t0 )) s"
cp build/p24/out/base/accuracy_loop.json $out/base.json
cp build/p24/out/base/log/train_logs.txt $out/base_train_logs.txt
ls build/p24/out/base/model_dump
for e in latest earliest; do
  python -m ihpr_tpu_torch.tools.bf16_drift --preset flagship --bn_mode flax \
    --output_dir build/p24/out/base --epoch $e > $out/drift_$e.log 2>&1
  echo "bf16_drift $e rc $? at $(( $(date +%s) - t0 )) s"
done
cp build/p24/out/base/bf16_drift*.json $out/
wait $pb; echo "B rc $? at $(( $(date +%s) - t0 )) s"
cp build/p24/out/off/accuracy_loop.json $out/off.json
cp build/p24/out/off/log/train_logs.txt $out/off_train_logs.txt
for f in base off; do tail -4 $out/$f.log; done
tail -3 $out/drift_latest.log $out/drift_earliest.log
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit 0
