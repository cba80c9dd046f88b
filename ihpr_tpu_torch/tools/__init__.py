"""Tools of the port: the counterparts of the JAX package's ``tools/``
probes that hold a TPU kernel, and of its export CLI (``tools/`` is a
directory of scripts there, not a package).

- ``exp_probe``: the exp-pass probe (P1). Does the integral's exp pass cost
  anything beyond one read of the (128, 4096, 1152) fp32 volume? Kernel
  ``ops/csrc/exp_probe.cu``.
- ``mxu_int8_probe``: the tiled int8/bf16 matmul probe (P2). How close does a
  hand-written tensor-core GEMM get to the card's peaks, next to cuBLAS?
  Kernel ``ops/csrc/probe_mm.cu``.

- ``export_artifact``: a snapshot as a ``torch.export`` serving artifact
  (``engine/export.py``) plus its JSON sidecar.
- ``serving_bench``: ``PoseServer``'s request latency and sustained rate
  (patch stream, native warp, exported artifact, ``predict_stream``).
- ``accuracy_loop``, ``mpii2d_probe``, ``coco_probe``: accuracy evidence.
  Each trains a preset from scratch on synthetic JPEGs, scores unseen
  frames through the Tester (MPJPE, PCKh@0.5, OKS AP) against JAX's bar,
  writes a JSON result and exits 0 or 1 by it; ``accuracy_loop`` also runs
  the trained weights on the CPU as an oracle. ``_accuracy`` holds what
  they share. ``bf16_drift`` scores an ``accuracy_loop`` run's snapshot in
  bf16 lean and flax BN, fp32 and the two mixes, and reports where per
  layer bf16 departs from fp32.
- ``validate_data``: the preflight of a dataset root against the loaders'
  schema (exit 0 or 1); ``dress_rehearsal``: a tree in the upstream
  layout, validated, then the train and test CLIs on it.
Each runs on the card by default and on the CPU (plain versions, host
clock) with ``--device cpu``:

    python -m ihpr_tpu_torch.tools.exp_probe [--iters 30] [--device cuda]
    python -m ihpr_tpu_torch.tools.mxu_int8_probe [--iters 30] [--device cuda] [--check]
    python -m ihpr_tpu_torch.tools.export_artifact --config C --snapshot_dir D --out F [--device cuda]
    python -m ihpr_tpu_torch.tools.serving_bench [--config h36m3d_r50] [--max_batch 32] [--chunks 24] [--device cuda]
    python -m ihpr_tpu_torch.tools.accuracy_loop [--preset tiny|flagship|r152] [--device cuda] [--output_dir D]
    python -m ihpr_tpu_torch.tools.mpii2d_probe [--device cuda] [--output_dir D]
    python -m ihpr_tpu_torch.tools.coco_probe [--device cuda] [--output_dir D]
    python -m ihpr_tpu_torch.tools.bf16_drift --preset flagship --output_dir D [--device cuda]
    python -m ihpr_tpu_torch.tools.validate_data --dataset Human36M --data_root R
    python -m ihpr_tpu_torch.tools.dress_rehearsal --root T [--run] [--device cuda]

``train_supervised.sh`` relaunches ``python -m ihpr_tpu_torch.train`` with
``--continue`` after each exit 75 (the RSS watchdog's) and ends on any
other code.

``synthetic_root`` has no command line: its functions write a dataset root
in the reference's file layouts (Human3.6M, MPII) from synthetic samples,
its JPEGs encoded on the device, and a seeded torchvision ResNet ``.pth``,
for runs of the real-data path without a dataset or ImageNet weights.

Importing a tool touches no CUDA state and parses no arguments.
"""

from __future__ import annotations

import subprocess
import time

import torch


def device_line(device) -> str:
    """Where the numbers come from: on a CUDA device the card's name and
    power limit as ``nvidia-smi`` reports them, else the host clock."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type}: plain versions, host clock (not a device time)"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, iters: int, device) -> float:
    """ms per call of ``fn``: one warm-up call, then ``iters`` calls back to
    back, timed with CUDA events on a CUDA device and with the host clock on
    the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
