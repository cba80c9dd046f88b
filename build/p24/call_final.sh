#!/bin/bash
# From a git archive of the tree (build/arch, made beforehand): the
# smoke's refusal under IHPR_PALLAS=off, the smoke, then the card tests.
set -u
out=$PWD/${OUT:-build/p24/results}; mkdir -p $out
cd build/arch
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
IHPR_PALLAS=off python3 chip_smoke.py > $out/refuse.log 2>&1; echo "refusal under IHPR_PALLAS=off: rc $?"
t0=$(date +%s)
python3 chip_smoke.py > $out/smoke.log 2> $out/smoke.err; rc=$?
echo "chip_smoke rc $rc in $(( $(date +%s) - t0 )) s"
tail -3 $out/smoke.log | cut -c1-400
tail -5 $out/smoke.err
grep -E "^kernels-off" $out/smoke.log
t0=$(date +%s)
python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py tests/test_torch_jpeg.py > $out/cardtests.log 2>&1
echo "card tests rc $? in $(( $(date +%s) - t0 )) s"; tail -3 $out/cardtests.log
