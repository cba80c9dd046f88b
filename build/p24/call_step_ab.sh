#!/bin/bash
# The flagship train step (h36m3d_r50, bf16, lean BN, batch 128, two
# resident batches; tools/bwd_experiments, variant baseline: step ms by
# CUDA events, busy ms by torch.profiler, idle share) in the parent tree and
# in this one, in turns: parent, change, change, parent. Then the smoke's
# phase 7q alone and the poisoned-shared-memory check of K1/K2. The parent
# tree is unpacked beforehand into build/parent (git archive of the parent
# commit). Everything is written under $OUT (default build/p24/results).
set -u
export PYTHONUNBUFFERED=1
out=$PWD/${OUT:-build/p24/results}; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
root=$PWD
i=0
for tree in parent change change parent; do
  i=$((i + 1)); dir=$root; [ $tree = parent ] && dir=$root/build/parent
  t0=$(date +%s)
  (cd $dir && PYTHONPATH=$dir python -m ihpr_tpu_torch.tools.bwd_experiments --variants baseline \
     --steps 20 > $out/step_ab_${i}_$tree.log 2>&1)
  echo "$i $tree rc $? in $(( $(date +%s) - t0 )) s: $(grep '^{' $out/step_ab_${i}_$tree.log | tail -1)"
done
t0=$(date +%s)
python3 chip_smoke.py --only kernels-off > $out/kernels_off.log 2>&1
echo "kernels-off rc $? in $(( $(date +%s) - t0 )) s"; grep -E "^kernels-off" $out/kernels_off.log; tail -3 $out/kernels_off.log | cut -c1-300
t0=$(date +%s)
PYTHONPATH=$PWD python build/p24/poison_check.py > $out/poison.log 2>&1
echo "poison_check rc $? in $(( $(date +%s) - t0 )) s"; tail -2 $out/poison.log | cut -c1-300
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
