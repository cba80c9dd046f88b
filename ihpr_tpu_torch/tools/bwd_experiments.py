"""Backbone-backward variants of the flagship train step, measured in situ:
the port of the JAX package's ``tools/bwd_experiments.py``.

Each variant of JAX's ``VARIANTS`` table changes ``h36m3d_r50`` (bf16,
lean BN, batch 128) in one way: the BN mode (``lean16``, ``frozen``, the
subsampled, stop-gradient modes), ``block_remat`` with either policy,
``fp32_logits``, ``fused_1x1``, the batch (``_batch``: 96, 160, 192) or the
fused head's exp modes (``_env``: ``IHPR_EXP2``, ``IHPR_BEXP``, set for
the variant and restored after it). ``baseline`` is the config as it
stands (lean BN, as ``lean_bn``). For each, a fresh model from the
config's seed trains on two resident batches of synthetic frames (the
loader's host warp, staged on the device once) in turns:

- ``--warmup`` steps (kernel builds, cuDNN plans), then ``--steps`` steps
  back to back, timed with CUDA events and one wait at the end:
  ``step_ms`` and ``img_per_s``;
- one more step under torch.profiler: ``busy_ms``, the device's kernel
  time, and ``idle_share`` = 1 - busy / step;
- ``peak_gib``: the most memory allocated over the timed steps;
- ``steps_run``: every step the variant took, the first one included.

Each variant prints one JSON line (and appends it to ``--output``). A
variant that fails raises: nothing is skipped. On the CPU (``--device
cpu``: plain versions, host clock) busy and peak are None and
``--batch_scale`` shrinks every batch for a small run:

    python -m ihpr_tpu_torch.tools.bwd_experiments [--variants a,b] [--steps 10] [--output F]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import torch

# JAX's table (tools/bwd_experiments.py), unchanged: name -> ModelConfig
# fields, with "_batch" (per-device batch) and "_env" (environment).
VARIANTS = {
    "baseline": {},
    "lean_bn": dict(bn_mode="lean"),
    "remat": dict(block_remat=True),
    "lean_remat": dict(bn_mode="lean", block_remat=True),
    "bf16_logits": dict(fp32_logits=False),
    "all": dict(bn_mode="lean", block_remat=True, fp32_logits=False),
    "conv_outs": dict(block_remat=True, remat_policy="conv_outs"),
    "lean_conv_outs": dict(bn_mode="lean", block_remat=True, remat_policy="conv_outs"),
    "lean16": dict(bn_mode="lean16"),
    "frozen_bn": dict(bn_mode="frozen"),
    "lean_sub4": dict(bn_mode="lean_sub4"),
    "lean_sub8": dict(bn_mode="lean_sub8"),
    "lean_sg": dict(bn_mode="lean_sg"),
    "lean_sgv": dict(bn_mode="lean_sgv"),
    "fused_1x1": dict(bn_mode="lean", fused_1x1=True),
    "lean_b96": dict(bn_mode="lean", _batch=96),
    "lean_b160": dict(bn_mode="lean", _batch=160),
    "lean_b192": dict(bn_mode="lean", _batch=192),
    "exp2": dict(_env={"IHPR_EXP2": "1"}),
    "bexp": dict(_env={"IHPR_BEXP": "1"}),
    "exp2_bexp": dict(_env={"IHPR_EXP2": "1", "IHPR_BEXP": "1"}),
}


def base_config():
    """The config every variant changes: ``h36m3d_r50``."""
    from ihpr_tpu_torch.config import get_config

    return get_config("h36m3d_r50")


def variant(base, name: str, batch_scale: float = 1.0):
    """(config, batch, environment) of variant ``name`` of ``base``."""
    kw = dict(VARIANTS[name])
    env = kw.pop("_env", {})
    batch = max(1, round(kw.pop("_batch", base.optim.batch_size_per_device) * batch_scale))
    cfg = base.replace(name=f"exp_{name}", model=dataclasses.replace(base.model, **kw),
                       optim=dataclasses.replace(base.optim, batch_size_per_device=batch))
    return cfg, batch, env


@contextlib.contextmanager
def environ(env: dict):
    """``env`` set in ``os.environ`` while the block runs, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resident_batches(cfg, batch: int, device, num_workers: int = 8) -> list:
    """Two train batches of synthetic H36M frames (320 pixels, seed 0, as
    JAX's tool makes them), warped on the host and staged on ``device``."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.datasets import PoseDataset, make_synthetic
    from ihpr_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device

    skel = skeletons.H36M
    ds = PoseDataset("Human36M", skel, make_synthetic(skel, 3 * batch, seed=0, img_size=320), True)
    loader = BatchLoader([ds], cfg, batch, num_workers=num_workers, device=device, host_warp=True)
    try:
        return [b for b, _ in prefetch_to_device(loader.epoch(0), device)][:2]
    finally:
        loader.close()


def measure(cfg, batches: list, device, steps: int, warmup: int) -> dict:
    """One variant's numbers (module docstring) on a fresh model of ``cfg``."""
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    device = torch.device(device)
    cuda = device.type == "cuda"
    model = build_pose_net(cfg, device=device, trainable=True)
    opt, sched = make_optimizer(model, cfg, 100)
    step = make_train_step(model, opt, cfg, lean=True, scheduler=sched)
    first = float(step(batches[0])["loss"])
    for i in range(warmup):
        step(batches[i % 2])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = step(batches[i % 2])
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        ms = (time.perf_counter() - t0) * 1e3 / steps
    loss = float(metrics["loss"])
    busy = peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(batches[0])
            torch.cuda.synchronize(device)
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise FloatingPointError(f"{cfg.name}: loss {first} then {loss}")
    del model, opt, step
    if cuda:
        torch.cuda.empty_cache()
    return {"step_ms": ms, "busy_ms": busy, "idle_share": None if busy is None else 1 - busy / ms,
            "peak_gib": peak, "first_loss": first, "loss": loss, "steps_run": 1 + warmup + steps + int(cuda)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names of VARIANTS")
    ap.add_argument("--steps", type=int, default=10, help="timed steps a variant")
    ap.add_argument("--warmup", type=int, default=3, help="untimed steps before them")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch_scale", type=float, default=1.0, help="scale every batch (small CPU runs)")
    ap.add_argument("--output", default=None, help="append each JSON line to this file")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants.split(",") if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    return args


def main(argv=None) -> int:
    from ihpr_tpu_torch.tools import device_line
    from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

    install_graceful_shutdown()
    args = parse_args(argv)
    device = torch.device(args.device)
    gpu = device_line(device)
    base = base_config()
    print(f"bwd_experiments: {base.name} on {device} [{gpu}]", flush=True)
    staged = {}
    for name in args.variants.split(","):
        cfg, batch, env = variant(base, name, args.batch_scale)
        if batch not in staged:
            staged[batch] = resident_batches(cfg, batch, device)
        with environ(env):
            res = measure(cfg, staged[batch], device, args.steps, args.warmup)
        line = json.dumps({"variant": name, "batch": batch, **res, "img_per_s": batch / res["step_ms"] * 1e3,
                           "steps": args.steps, "device": gpu})
        print(line, flush=True)
        if args.output:
            with open(args.output, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
