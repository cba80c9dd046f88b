"""Where K1-fp32 and K2-fp32, K5-fp32 and K6-fp32, or K7-fp32 and K8-fp32
spend their time: each kernel built as it is and stripped of one part of
its work, timed at the fp32 flagship head, at every shape of a fp32
fused_1x1 step, or at the conv3 route's fp32 shapes.

    python -m ihpr_tpu_torch.tools.f32_breakdown [--batch 32 128] [--reps 3]
    python -m ihpr_tpu_torch.tools.f32_breakdown --kernels bn
    python -m ihpr_tpu_torch.tools.f32_breakdown --kernels conv

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
milliseconds (torch.profiler), then one JSON line with every number.
With ``--kernels bn`` it times K5-fp32 and K6-fp32 (``matmul_bn_fwd`` /
``_bwd``, whose ``csrc/matmul_bn_f32.cuh`` takes the split and the three
passes from ``fused_head_f32.cuh``) in the variants that touch them
(``full``, ``no_split``, ``one_pass``): each launch's device milliseconds
(torch.profiler) at every shape of ``BN_STEP`` and their sums over the
step's 16 launches. With ``--kernels conv`` it times K7-fp32 and K8-fp32
(``conv_bn_fwd`` / ``_bwd``, ``csrc/conv3_f32.cuh``) in ``full``,
``no_split`` and ``one_pass`` at ``CONV_SHAPES``: each
call's milliseconds (CUDA events) and each launch's device milliseconds.
CUDA only: the variants are timings of the card's kernels.
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
from ihpr_tpu_torch.ops import conv_bn as cb
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import matmul_bn as mm

VARIANTS = {
    "full": (),
    "no_split": ("IHPR_F32_NO_SPLIT",),
    "no_exp": ("IHPR_F32_NO_EXP",),
    "products": ("IHPR_F32_NO_SPLIT", "IHPR_F32_NO_EXP"),
    "one_pass": ("IHPR_F32_ONE_PASS",),
    "one_part": ("IHPR_F32_ONE_PART",),
}
HW, WIDTH, C, J, D = 64 * 64, 64, 256, 18, 64
BN_VARIANTS = ("full", "no_split", "one_pass")  # the variants whose macros K5-K8-fp32 read
# (B, H, W, C, N, launches a step) of K7-fp32 / K8-fp32: layer3_1 ... layer3_5
# conv2 of h36m3d_r50_fp32 with both fused flags at 128x128 (chip_smoke.py's
# 7n), and the same conv at 256x256, which no step runs (5c times it).
CONV_SHAPES = ((32, 8, 8, 256, 256, 5), (32, 16, 16, 256, 256, 0))
# One fused_1x1 step of h36m3d_r50_fp32 with lean BN (ResNet-50, 256x256,
# batch 32): the (M, K, N, prologue, launches) of K5-fp32 / K6-fp32, layer1_0
# ... layer3_0's conv1 and conv3 (chip_smoke.py's 5c and 7m run them too).
BN_STEP = (
    (131072, 64, 64, False, 1),    # layer1_0 conv1
    (131072, 256, 64, False, 2),   # layer1_1, layer1_2 conv1
    (131072, 256, 128, False, 1),  # layer2_0 conv1
    (32768, 512, 128, False, 3),   # layer2_1 ... layer2_3 conv1
    (32768, 512, 256, False, 1),   # layer3_0 conv1
    (131072, 64, 256, True, 3),    # layer1_* conv3 (bn2 prologue)
    (32768, 128, 512, True, 4),    # layer2_* conv3
    (8192, 256, 1024, True, 1),    # layer3_0 conv3
)


def _use(defines: tuple, mod=fhi) -> None:
    """Point ``mod``'s kernel libraries (fhi's, mm's or cb's) at the build
    with ``defines``."""
    for lib in (mod._lib if mod is fhi else mod._fwd_lib, mod._bwd_lib):
        lib.cache_clear()
    mod._build = types.SimpleNamespace(load=lambda n: ctypes.CDLL(str(_build.build(n, defines))))


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
    taken again (at most six times) until it caught dfeat_kernel,
    fwd_f32_kernel or one of K5-K8-fp32's."""
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
        if any(k in name for name in ms for k in ("dfeat_kernel", "fwd_f32_kernel", "mbf::", "c3f::")):
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


def _bn_step(variants, gpu: str) -> dict:
    """K5-fp32 / K6-fp32's device ms a launch at every BN_STEP shape in each
    variant, and each kernel's sum over the step."""
    results = {}
    for name in variants:
        _use(VARIANTS[name], mm)
        step = {}
        for i, (m, k, n, prologue, launches) in enumerate(BN_STEP):
            gen = torch.Generator().manual_seed(i)
            x = torch.randn(m, k, generator=gen).cuda()
            w = (torch.randn(k, n, generator=gen) / k**0.5).cuda()
            mul = (torch.rand(k, generator=gen) + 0.5).cuda() if prologue else None
            add = (torch.randn(k, generator=gen) * 0.2).cuda() if prologue else None
            dy = torch.randn(m, n, generator=gen).cuda()
            ds1, ds2 = (torch.randn(n, generator=gen) * 0.1).cuda(), (torch.randn(n, generator=gen) * 0.01).cuda()
            y = mm.kernel_fwd(x, w, mul, add)[0]
            parts = {**_launches(lambda: mm.kernel_fwd(x, w, mul, add)),
                     **_launches(lambda: mm.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2))}
            for kern, ms in parts.items():
                step[kern] = round(step.get(kern, 0.0) + launches * ms, 4)
            print(f"{name:9s} ({m}, {k}, {n}){' +p' if prologue else ''} x{launches}: "
                  + ", ".join(f"{kern} {ms:.4f}" for kern, ms in parts.items()) + f"  [{gpu}]")
            del x, w, mul, add, dy, ds1, ds2, y
        print(f"{name:9s} per step: " + ", ".join(f"{kern} {v:.4f}" for kern, v in step.items()) + f"  [{gpu}]")
        results[name] = step
        torch.cuda.empty_cache()
    return results


def _conv_shapes(variants, reps: int, gpu: str) -> dict:
    """K7-fp32 / K8-fp32 at every CONV_SHAPES shape in each variant: each
    call's ms and each launch's device ms."""
    results = {}
    for name in variants:
        _use(VARIANTS[name], cb)
        for i, (b, h, w, c, n, launches) in enumerate(CONV_SHAPES):
            gen = torch.Generator().manual_seed(70 + i)
            x = torch.randn(b, h, w, c, generator=gen).cuda()
            w9 = (torch.randn(9, c, n, generator=gen) / (9 * c) ** 0.5).cuda()
            mul, add = (torch.rand(c, generator=gen) + 0.5).cuda(), (torch.randn(c, generator=gen) * 0.2).cuda()
            dy = torch.randn(b, h, w, n, generator=gen).cuda()
            ds1, ds2 = (torch.randn(n, generator=gen) * 0.1).cuda(), (torch.randn(n, generator=gen) * 0.01).cuda()
            y = cb.kernel_fwd(x, w9, mul, add)[0]
            fwd, bwd = lambda: cb.kernel_fwd(x, w9, mul, add), lambda: cb.kernel_bwd(x, w9, mul, add, y, dy, ds1, ds2)
            k7, k8 = _ms(fwd, reps=reps), _ms(bwd, reps=reps)
            parts = {**{f"K7 {k}": v for k, v in _launches(fwd).items()},
                     **{f"K8 {k}": v for k, v in _launches(bwd).items()}}
            results[f"{name}/{b}x{h}x{w}x{c}"] = {"k7_ms": round(k7, 4), "k8_ms": round(k8, 4), "launches": parts}
            print(f"{name:9s} ({b}, {h}, {w}, {c}) x (9, {c}, {n}) x{launches}/step: K7-fp32 {k7:.4f} ms, K8-fp32 "
                  f"{k8:.4f} ms; launches " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"  [{gpu}]")
            del x, w9, mul, add, dy, ds1, ds2, y
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, nargs="+", default=[32])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--kernels", choices=("head", "bn", "conv"), default="head",
                        help="head: K1/K2-fp32 at the flagship head; bn: K5/K6-fp32 at BN_STEP; "
                             "conv: K7/K8-fp32 at CONV_SHAPES")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.kernels == "conv":
        variants = [v for v in args.variants if v in BN_VARIANTS]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda a: _build.build(*a), [(n, VARIANTS[v]) for v in variants
                                                        for n in (cb._FWD_LIB, cb._BWD_LIB)]))
        print(json.dumps({"gpu": gpu, "shapes": CONV_SHAPES, "results": _conv_shapes(variants, args.reps, gpu)}))
        return 0
    if args.kernels == "bn":
        variants = [v for v in args.variants if v in BN_VARIANTS]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda a: _build.build(*a), [(n, VARIANTS[v]) for v in variants
                                                        for n in (mm._FWD_LIB, mm._BWD_LIB)]))
        print(json.dumps({"gpu": gpu, "step": BN_STEP, "results": _bn_step(variants, gpu)}))
        return 0
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
