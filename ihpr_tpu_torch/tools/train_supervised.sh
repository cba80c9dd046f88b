#!/bin/bash
# Supervised training: relaunch the port's train CLI with --continue
# whenever it exits 75 (EX_TEMPFAIL), the code of the host-RSS watchdog's
# self-preemption (ihpr_tpu_torch/engine/trainer.py: it snapshots, mid-epoch
# included, and exits before the OOM killer can kill it). The relaunch
# resumes bitwise: the data stream is deterministic and the snapshot holds
# the whole train state.
#
# Usage: ihpr_tpu_torch/tools/train_supervised.sh [python -m ihpr_tpu_torch.train args...]
#   e.g. ihpr_tpu_torch/tools/train_supervised.sh --config h36m3d_r50 --data_root /data
#
# Any exit code other than 75 (success, an error, SIGTERM's 143) ends the
# loop with that code. PYTHON names the interpreter (default python).
set -u
cd "$(dirname "$0")/../.."

attempt=0
extra=()
while :; do
  "${PYTHON:-python}" -m ihpr_tpu_torch.train "$@" "${extra[@]}"
  rc=$?
  if [ "$rc" -ne 75 ]; then
    exit "$rc"
  fi
  attempt=$((attempt + 1))
  echo "train_supervised: preempt #$attempt (exit 75) -> relaunching with --continue" >&2
  extra=(--continue)
done
