"""Where K1-fp32 and K2-fp32 spend their time: each kernel built as it is
and stripped of one part of its work, timed at the fp32 flagship head.

    python -m ihpr_tpu_torch.tools.f32_breakdown [--batch 32 128] [--reps 3]

Builds ``fused_head_integral_fwd_f32`` and ``_bwd_f32`` once per variant
(``-D`` macros of ``csrc/fused_head_f32.cuh``; a stripped build's results
are wrong, its time is the point):

- ``full``: as shipped;
- ``no_split``: A's raw bits as hi and zero as lo, so no value is split in
  registers (the three TF32 passes still run);
- ``no_exp``: the softmax's and dv's ``ex2`` taken out;
- ``products``: both (the products, the loads and the pipeline alone);
- ``one_pass``: the hi*hi pass alone (what one TF32 pass would cost);
- ``one_part``: K1-fp32 with whole samples a CTA, no row parts (right
  results; K2-fp32 as shipped).

For each it prints, at each ``--batch`` B on (B, 4096, 256) x (256, 1152)
(J = 18, D = 64), K1-fp32's and K2-fp32's milliseconds a call (CUDA
events, the median of ``--reps`` runs of 5 calls) and each launch's device
milliseconds (torch.profiler), then one JSON line with every number. CUDA
only: the variants are timings of the card's kernels.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import subprocess
import sys
import types

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops import fused_head_integral as fhi

VARIANTS = {
    "full": (),
    "no_split": ("IHPR_F32_NO_SPLIT",),
    "no_exp": ("IHPR_F32_NO_EXP",),
    "products": ("IHPR_F32_NO_SPLIT", "IHPR_F32_NO_EXP"),
    "one_pass": ("IHPR_F32_ONE_PASS",),
    "one_part": ("IHPR_F32_ONE_PART",),
}
HW, WIDTH, C, J, D = 64 * 64, 64, 256, 18, 64


def _use(defines: tuple) -> None:
    """Point fhi's kernel libraries at the build with ``defines``."""
    fhi._lib.cache_clear()
    fhi._bwd_lib.cache_clear()
    fhi._build = types.SimpleNamespace(load=lambda n: ctypes.CDLL(str(_build.build(n, defines))))


def _ms(fn, calls: int = 5, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _launches(fn, calls: int = 3) -> dict:
    """{kernel: device ms a launch} of fn's CUDA kernels (torch.profiler),
    taken again (at most six times) until it caught dfeat_kernel or
    fwd_f32_kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = {e.key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]:
              round(e.self_device_time_total / e.count / 1e3, 4)
              for e in prof.key_averages() if e.self_device_time_total > 0 and "at::" not in e.key}
        if any(k in name for name in ms for k in ("dfeat_kernel", "fwd_f32_kernel")):
            break
    return ms


def _inputs(b: int):
    gen = torch.Generator().manual_seed(b)
    feat = (torch.randn(b, HW, C, generator=gen) * 0.5).cuda()
    kernel = (torch.randn(C, J * D, generator=gen) * (10.0 / C**0.5)).cuda()
    bias = (torch.randn(J * D, generator=gen) * 0.1).cuda()
    coords, m, s = fhi.plain(feat, kernel, bias, J, D, WIDTH)
    g = torch.randn(b, J, 3, generator=gen).cuda()
    return (feat, kernel, bias), (m.contiguous(), s.contiguous(), coords.contiguous(), g)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, nargs="+", default=[32])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # every variant's two libraries at once
        list(pool.map(lambda a: _build.build(*a), [(n, VARIANTS[v]) for v in args.variants
                                                    for n in (fhi._F32_LIB, fhi._F32_BWD_LIB)]))
    results = {}
    for b in args.batch:
        head, saved = _inputs(b)
        for name in args.variants:
            _use(VARIANTS[name])
            k1 = _ms(lambda: fhi.kernel_stats(*head, J, D, WIDTH), reps=args.reps)
            k2 = _ms(lambda: fhi.kernel_bwd(*head, *saved, J, D, WIDTH), reps=args.reps)
            parts = {**{f"K1 {k}": v for k, v in _launches(lambda: fhi.kernel_stats(*head, J, D, WIDTH)).items()},
                     **{f"K2 {k}": v for k, v in _launches(lambda: fhi.kernel_bwd(*head, *saved, J, D, WIDTH)).items()}}
            results[f"{name}/B={b}"] = {"k1_ms": round(k1, 4), "k2_ms": round(k2, 4), "launches": parts}
            print(f"{name:9s} B={b}: K1-fp32 {k1:.4f} ms, K2-fp32 {k2:.4f} ms; launches "
                  + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"  [{gpu}]")
        del head, saved
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "shape": [HW, C, J, D], "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
