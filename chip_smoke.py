"""Smoke run of the PyTorch/CUDA port (ihpr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the environment: torch, CUDA, nvcc, the card's name and power limit.
2. Builds every CUDA kernel (K1-K8 of the serving, training, fused-train,
   heatmap and eval paths; P1/P2 of the probe tools) from
   ihpr_tpu_torch/ops/csrc, one nvcc per source, all at once.
3. K1 (fused head forward, bf16): holds it against its plain PyTorch
   version on the card, at the serving shapes and at edge cases (J=17,
   H*W=96*72, D=1, all-equal logits, a one-hot peak), and times both with
   CUDA events (median of repeated launches, in turns) at the
   serving dispatch (B=64) and at the train batch (B=128).
4. K2 (fused head backward, bf16): holds it against plain_bwd at a
   training shape, at J=17, H*W=96*72, D=1, all-equal logits and a soft
   peak (checked against float64 on the host), checks that two runs give
   bitwise-equal dfeat, dW and db, and times both at the train batch, with
   each of its four launches' device time (torch.profiler).
5. K3/K4 (integral over a logits volume, forward and backward): hold them
   against plain / plain_bwd in bf16 and fp32 at J=18/D=64, J=17, D=1,
   H*W=96*72, all-equal logits (the centre), a one-hot peak and a soft peak
   (against float64), on an fp32 volume past 2^31 bytes, and two runs
   bitwise equal; time both at (128, 4096, 1152) in bf16 and fp32.
5b. K1/K2's library composition (cuBLAS final conv + K3/K4), a yardstick,
   at K1's two batches and K2's.
5c. K5/K6 (fused 1x1 conv + BN statistics) and K7/K8 (fused 3x3 conv + BN
   statistics), forward and backward: against plain / plain_bwd at every
   shape of the flagship fused step (bf16) and at edge cases (fp32, M = 1,
   K = N = 8, a 24x18 and a 5x3 plane; for K7/K8's tiles C = 200, N = 136,
   the flagship plane at B = 1 and a 3x5 plane), two runs bitwise equal;
   kernel, plain and library (cuBLAS / cuDNN in bf16 + sums) times, summed
   over one step's launches beside the step's bound; K6 at each shape with
   its bytes, its share of the bound and its sub-launches (torch.profiler);
   each sub-launch of one bf16 K7 and one K8 call beside its own bound.
6. Serves the flagship config h36m3d_r50 (ResNet-50, 256x256, 18 joints,
   64 depth bins, bf16, flip-test) at max_batch 32 with seeded random
   weights: predict_patches, predict (native warp) and predict_stream.
7. Trains h36m3d_r50 at full width and depth (batch 128, lean BN in train
   mode) through the Trainer on synthetic H36M+MPII: a few warm-up steps,
   then a counted epoch of TRAIN_STEPS steps; the head gradients of one
   step against plain_bwd on the same saved inputs; the loss falling over
   10 steps on one repeated batch; device ms per step (CUDA events),
   host-clock img/s and the loader's host ms per batch.
7b. Trains h36m3d_r50 with fused_1x1 and fused_conv3 through the Trainer
   (batch 128): K5/K6 16 and K7/K8 5 launches per step, K1/K2 one; one
   launch of each of K5-K8 in those steps against plain on its saved
   inputs; a fused_1x1-alone step (K5/K6 26 each); device ms per step and
   peak memory with both flags, fused_1x1 alone and unfused (the H100 A/B,
   in turns, medians of three rounds), and each one's device-busy time and
   K5-K8 share (torch.profiler); the loss falling over 10 steps on one
   repeated batch.
8. The heatmap-logits path: h36m3d_r50 at batch 128 takes an optimizer
   step through model(x) -> soft_argmax_from_heatmap -> loss (K3 forward,
   K4 backward), coords and dv against plain on the same logits, device ms
   per step; again with fp32_logits at batch 32.
9. The fused op on heads K1/K2 do not take (C=72, D=80, and fp32 heads,
   the flagship's C=256, D=64 included): fp32 logits and K3/K4, forward
   and backward, against the plain fused op; the fp32 flagship head's
   forward (B=64) and backward (B=128) times on this route.
10. Evaluates h36m3d_r50 through the Tester (300 synthetic H36M test
    samples, batch 128, the last batch padded, flip-test): MPJPE and the
    result files; one batch's coords against plain; host-clock img/s and
    the loader's ms per batch. Then mpii2d_r50 (D=1, PCKh, an fp32 head:
    logits + K3) on 64 samples.
11. P1, the exp-pass probe (ihpr_tpu_torch.tools.exp_probe): its main
    times all six modes on the (128, 4096, 1152) fp32 volume and checks the
    read floor (0.721 ms at 3.35 TB/s); every mode's partials and token
    against plain (read bitwise, bexpsum 1e-2, the others 1e-5 relative),
    two runs bitwise equal; plain expsum and torch.sum over the blocks.
12. P2, the tiled matmul probe (ihpr_tpu_torch.tools.mxu_int8_probe): its
    main times cuBLAS bf16 / torch._int_mm, every tile of the kernel in bf16
    and int8 at 4096^3 and the conv9 / cuDNN pair; every tile against
    plain_mm at 4096^3 (int8 bitwise, bf16 1e-4 of max|plain|), its rate,
    share of the bound and ratio to the library; the int8 transpose's share
    of one call (torch.profiler).

In 6-12 the kernels' launch counters are set to 0 just before the path
runs and read just after (in 11-12 the path is the tool's main); each kernel of the path must have launched as
often as the path dispatched it, and the others not at all. Outputs are
checked for shape and finiteness and against the plain versions.

Prints one JSON line of kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; so does a host without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL_VOXEL = 5e-4  # kernel vs plain coords: same operands, fp32 accumulation
# Backward kernels vs plain_bwd, relative to each result's largest
# magnitude: bf16 rounds dv before the contractions and every result once
# (2^-8), after fp32 sums taken in another order; fp32 (K4, K6, K8) differs
# only in sum order and, in K4, ex2.approx.
TOL_BWD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The no-plan route's fp32 gradients against autograd through the plain
# fused op: dW and db sum dv over 8 x 4096 rows and cancel to near 0, so
# the sum order alone moves them by ~6e-5 of their largest (two fp32
# orders on a CPU).
TOL_NOPLAN_GRAD = 3e-4
MAX_BATCH = 32
TRAIN_BATCH = 128  # h36m3d_r50's batch_size_per_device
TRAIN_STEPS = 5  # counted steps of the train phase
EVAL_SAMPLES = 300  # not a multiple of the eval batch (128): the last is padded
SEED = 0


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int, reps: int = 5) -> float:
    """Device time of one call of fn, in ms: CUDA events around n calls
    back to back, median over reps."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _head_inputs(b, hw, c, jd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, hw, c, generator=g) * 0.5
    kernel = torch.randn(c, jd, generator=g) * (10.0 / c**0.5)  # logits std ~5
    bias = torch.randn(jd, generator=g) * 0.1
    return tuple(t.to("cuda", dtype) for t in (feat, kernel, bias))


def check_kernel(fhi, feat, kernel, bias, j, d, w, expect=None):
    """Kernel vs plain on the card; returns max |coords diff| in voxels."""
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    want = fhi.plain(feat, kernel, bias, j, d, w)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    if not (err <= TOL_VOXEL and torch.isfinite(got[0]).all()):
        raise AssertionError(f"coords differ from plain by {err} voxel (> {TOL_VOXEL})")
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)
    if expect is not None:
        e = float((got[0] - expect).abs().max())
        if e > 1e-3:
            raise AssertionError(f"coords {e} voxel from the analytic answer")
    return err


def kernel_phase(fhi, gpu: str):
    """K1 vs plain at the serving shapes and edge cases; kernel and plain
    times at the flagship dispatch (2 x 32 flip-test samples, 64x64
    heatmap, C=256) and at the train batch (128), bf16, with TFLOP/s and
    the share of the bound. Returns the largest |coords diff| and, per
    batch, (kernel ms, plain ms)."""
    b, hw, w, c, d = 2 * MAX_BATCH, 64 * 64, 64, 256, 64
    errs = []
    timing = {}
    for bsz in (b, TRAIN_BATCH):
        args = _head_inputs(bsz, hw, c, 18 * d, torch.bfloat16, SEED)
        errs.append(check_kernel(fhi, *args, 18, d, w))
        runs = {"plain": (lambda: fhi.plain(*args, 18, d, w), []),
                "kernel": (lambda: fhi.kernel_stats(*args, 18, d, w), [])}
        for name in ("plain", "kernel", "kernel", "plain") * 2:  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 10 if name == "kernel" else 3, reps=3))
        plain_ms, kernel_ms = runs["plain"][1], runs["kernel"][1]
        timing[bsz] = (statistics.median(kernel_ms), statistics.median(plain_ms))
        flops = 2 * bsz * hw * c * 18 * d
        bound = k1_bound(bsz)[0]
        print(
            f"K1 bf16 ({bsz}, {hw}, {c}) x ({c}, {18 * d}): kernel {timing[bsz][0]:.4f} ms "
            f"({flops / timing[bsz][0] / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms, "
            f"{bound / timing[bsz][0]:.3f} of it), plain {timing[bsz][1]:.4f} ms, "
            f"max|dcoords| {errs[-1]:.3g} voxel  [{gpu}]"
        )
        del args, runs
    torch.cuda.empty_cache()
    errs.append(check_kernel(fhi, *_head_inputs(b, hw, c, 17 * d, torch.bfloat16, 1), 17, d, w))
    print(f"K1 J=17 (COCO skeleton): max|dcoords| {errs[-1]:.3g} voxel")
    errs.append(check_kernel(fhi, *_head_inputs(b, 96 * 72, c, 18 * d, torch.bfloat16, 2), 18, d, 72))
    print(f"K1 H*W = 96*72: max|dcoords| {errs[-1]:.3g} voxel")
    errs.append(check_kernel(fhi, *_head_inputs(b, hw, c, 16, torch.bfloat16, 4), 16, 1, w))
    print(f"K1 D=1, J=16 (a 2D config's head in bf16): max|dcoords| {errs[-1]:.3g} voxel")
    # All-equal logits: every coordinate is the volume centre.
    feat, kernel, bias = (torch.zeros_like(t) for t in _head_inputs(4, hw, c, 18 * d, torch.bfloat16, 3))
    centre = torch.tensor([(w - 1) / 2, (hw // w - 1) / 2, (d - 1) / 2], device="cuda")
    errs.append(check_kernel(fhi, feat, kernel, bias, 18, d, w, expect=centre.expand(4, 18, 3)))
    print(f"K1 all-equal logits -> centre: max|dcoords| {errs[-1]:.3g} voxel")
    # One-hot peak: logit 100 at (row r0, bin z0) of joint 5, 0 elsewhere.
    r0, z0, j0 = 1234, 17, 5
    feat[:, r0, 0] = 1.0
    kernel[0, j0 * d + z0] = 100.0
    expect = centre.expand(4, 18, 3).clone()
    expect[:, j0] = torch.tensor([r0 % w, r0 // w, z0], dtype=torch.float32, device="cuda")
    errs.append(check_kernel(fhi, feat, kernel, bias, 18, d, w, expect=expect))
    print(f"K1 one-hot peak -> its voxel: max|dcoords| {errs[-1]:.3g} voxel")
    return max(errs), timing


def _bwd_inputs(fhi, b, hw, c, j, d, w, dtype, seed):
    """Head inputs, K1's m and s, coords and a random cotangent g."""
    feat, kernel, bias = _head_inputs(b, hw, c, j * d, dtype, seed)
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(seed)).cuda()
    return feat, kernel, bias, m, s, coords, g


def check_bwd(fhi, args, j, d, w, tol, label, want=None):
    """K2 vs plain_bwd (or ``want``) on the card, each result relative to
    its largest magnitude; db may also differ by 1e-4 of its summands'
    bound, sum_b |gx| (w-1) + |gy| (h-1) + |gz| (d-1), since it can cancel
    to ~0. Returns the largest absolute difference."""
    got = fhi.kernel_bwd(*args, j, d, w)
    want = fhi.plain_bwd(*args, j, d, w) if want is None else want
    torch.cuda.synchronize()
    g, h = args[-1], args[0].shape[1] // w
    ext = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32, device=g.device)
    db_atol = 1e-4 * float((g.abs() * ext).sum(-1).sum(0).max())
    worst, rel = 0.0, []
    for name, a, b in zip(("dfeat", "dW", "db"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"K2 {label} {name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        if err > tol * scale + (db_atol if name == "db" else 0.0):
            raise AssertionError(f"K2 {label} {name}: max|diff| {err} > {tol} x max|plain| {scale}")
        worst = max(worst, err)
        rel.append(f"{name} {err / scale if scale else 0.0:.2e}")
    print(f"K2 {label}: |diff|/max|plain| " + ", ".join(rel))
    return worst, got


def _soft_peak_check(fhi):
    """A logit of 5 over a flat floor at one voxel (p spread over the whole
    volume, dv nonzero everywhere): dW's column for that voxel against
    float64 on the host from the same bf16-rounded inputs, within 2e-2 of
    its largest."""
    b, h, w, c, j, d = 2, 64, 64, 256, 18, 64
    dtype = torch.bfloat16
    r0, z0, j0 = 1234, 17, 5
    gen = torch.Generator().manual_seed(9)
    feat = (torch.randn(b, h * w, c, generator=gen) * 0.05).to(dtype)
    kernel = (torch.randn(c, j * d, generator=gen) * 0.05).to(dtype)
    feat[:, r0, 0] = 1.0
    kernel[0, j0 * d + z0] = 5.0
    g = torch.randn(b, j, 3, generator=gen)
    f64 = feat.double()
    v = (f64 @ kernel.double())[:, :, j0 * d : (j0 + 1) * d]  # joint j0 only: (B, HW, D)
    p = torch.softmax(v.reshape(b, -1), -1).view(b, h * w, d)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    cx, cy, cz = ((p.sum(-1) * x).sum(-1), (p.sum(-1) * y).sum(-1), (p.sum(1) * z).sum(-1))
    gj = g[:, j0].double()
    dv = p[:, :, z0] * (gj[:, 0, None] * (x - cx[:, None]) + gj[:, 1, None] * (y - cy[:, None])
                        + gj[:, 2, None] * (z0 - cz[:, None]))  # (B, HW)
    ref = (f64 * dv[..., None]).sum(dim=(0, 1))  # (C,)
    feat_c, kernel_c = feat.cuda(), kernel.cuda()
    bias_c = torch.zeros(j * d, dtype=dtype, device="cuda")
    coords, m, s = fhi.kernel_stats(feat_c, kernel_c, bias_c, j, d, w)
    _, dw, _ = fhi.kernel_bwd(feat_c, kernel_c, bias_c, m, s, coords, g.cuda(), j, d, w)
    col = dw[:, j0 * d + z0].double().cpu()
    err, scale = float((col - ref).abs().max()), float(ref.abs().max())
    if not (scale > 1e-3 and err <= 2e-2 * scale):
        raise AssertionError(f"K2 soft peak: dW column {err} from float64 (max {scale})")
    print(f"K2 soft peak (logit 5 over a flat floor), bf16: dW column vs float64 |diff|/max {err / scale:.2e}")
    return err


def k2_phase(fhi, gpu: str):
    """K2 vs plain_bwd at a training shape (B=16, 64x64, C=256, J=18, D=64)
    and edge cases; bitwise determinism of dfeat, dW and db; kernel and
    plain_bwd times at B=128 with TFLOP/s and the share of the bound."""
    hw, w, c, d = 64 * 64, 64, 256, 64
    bf16 = TOL_BWD[torch.bfloat16]
    args = _bwd_inputs(fhi, 16, hw, c, 18, d, w, torch.bfloat16, SEED)
    err, got = check_bwd(fhi, args, 18, d, w, bf16, "train shape bf16")
    errs = [err]
    again = fhi.kernel_bwd(*args, 18, d, w)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K2 is not deterministic: two runs differ")
    print("K2 two runs on the same inputs: dfeat, dW, db bitwise equal")
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, hw, c, 17, d, w, torch.bfloat16, 1), 17, d, w,
                          bf16, "J=17 (COCO skeleton)")[0])
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, 96 * 72, c, 18, d, 72, torch.bfloat16, 2),
                          18, d, 72, bf16, "H*W = 96*72")[0])
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, hw, c, 16, 1, w, torch.bfloat16, 5), 16, 1, w,
                          bf16, "D=1, J=16 (a 2D config's head in bf16)")[0])
    feat, kernel, bias, m, s, coords, g = _bwd_inputs(fhi, 4, hw, c, 18, d, w, torch.bfloat16, 3)
    feat, kernel, bias = (torch.zeros_like(t) for t in (feat, kernel, bias))
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, 18, d, w)
    errs.append(check_bwd(fhi, (feat, kernel, bias, m, s, coords, g), 18, d, w, bf16,
                          "all-equal logits (db only: feat = W = 0)",
                          want=(torch.zeros_like(feat), torch.zeros_like(kernel),
                                fhi.plain_bwd(feat, kernel, bias, m, s, coords, g, 18, d, w)[2]))[0])
    errs.append(_soft_peak_check(fhi))

    args = _bwd_inputs(fhi, TRAIN_BATCH, hw, c, 18, d, w, torch.bfloat16, 4)
    runs = {"plain": (lambda: fhi.plain_bwd(*args, 18, d, w), []),
            "kernel": (lambda: fhi.kernel_bwd(*args, 18, d, w), [])}
    for name in ("plain", "kernel", "kernel", "plain"):  # in turns
        fn, out = runs[name]
        out.append(_cuda_ms(fn, 5 if name == "kernel" else 1, reps=3))
    kernel_ms, plain_ms = statistics.median(runs["kernel"][1]), statistics.median(runs["plain"][1])
    flops = 4 * 2 * TRAIN_BATCH * hw * c * 18 * d
    bound = k2_bound(TRAIN_BATCH)[0]
    print(f"K2 bf16 ({TRAIN_BATCH}, {hw}, {c}) x ({c}, {18 * d}): kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s over its 4 products; bound {bound:.4f} ms, "
          f"{bound / kernel_ms:.3f} of it), plain_bwd {plain_ms:.4f} ms  [{gpu}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fhi.kernel_bwd(*args, 18, d, w)
        torch.cuda.synchronize()
    names = ("transpose_kernel", "dfeat_kernel", "dw_kernel", "reduce_kernel")  # one call's launches
    parts = [f"{k} {e.self_device_time_total / e.count / 1e3:.4f} ms"
             for e in prof.key_averages() for k in names if k in e.key]
    print(f"K2's launches per call (torch.profiler, 3 calls): {', '.join(parts) or 'not measured'}  [{gpu}]")
    del args, runs
    torch.cuda.empty_cache()
    return max(errs), (kernel_ms, plain_ms)


def _volume(b, hw, jd, dtype, seed, std=5.0):
    """Logits of std ~5: peaked heatmaps, coordinates away from the centre."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hw, jd, generator=g) * std).to("cuda", dtype)


def check_volume(iv, vol, j, d, w, label, expect=None):
    """K3 vs plain (coords within TOL_VOXEL, m exact, s to 1e-4) and K4 vs
    plain_bwd (dv within TOL_BWD of its largest magnitude) on the card.
    Returns the largest |coords diff| and |dv diff|."""
    coords, m, s = iv.kernel_stats(vol, j, d, w)
    want = iv.plain(vol, j, d, w)
    g = torch.randn(vol.shape[0], j, 3, generator=torch.Generator().manual_seed(7)).cuda()
    dv = iv.kernel_bwd(vol, m, s, coords, g, j, d, w)
    dv_ref = iv.plain_bwd(vol, m, s, coords, g, j, d, w)
    torch.cuda.synchronize()
    err = float((coords - want[0]).abs().max())
    if not (err <= TOL_VOXEL and torch.isfinite(coords).all()):
        raise AssertionError(f"K3 {label}: coords differ from plain by {err} voxel (> {TOL_VOXEL})")
    torch.testing.assert_close(m, want[1], atol=0, rtol=0)
    torch.testing.assert_close(s, want[2], atol=0, rtol=1e-4)
    if expect is not None and float((coords - expect).abs().max()) > 1e-3:
        raise AssertionError(f"K3 {label}: coords {float((coords - expect).abs().max())} from the answer")
    dv_err = float((dv.float() - dv_ref.float()).abs().max())
    scale = float(dv_ref.float().abs().max())
    if dv.dtype != vol.dtype or not (scale > 0 and dv_err <= TOL_BWD[vol.dtype] * scale):
        raise AssertionError(f"K4 {label}: {dv.dtype} dv {dv_err} from plain_bwd (max {scale})")
    print(f"K3/K4 {label}: max|dcoords| {err:.3g} voxel, max|ddv|/max|dv| {dv_err / scale:.2e}")
    return err, dv_err


def _volume_soft_peak(iv, dtype):
    """A logit of 5 over a flat floor at one voxel of joint 5: its coords
    and dv against float64 on the host."""
    b, h, w, j, d = 2, 64, 64, 18, 64
    r0, z0, j0 = 1234, 17, 5
    vol = torch.zeros(b, h * w, j * d, device="cuda", dtype=dtype)
    vol[:, r0, j0 * d + z0] = 5.0
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(8)).cuda()
    coords, m, s = iv.kernel_stats(vol, j, d, w)
    dv = iv.kernel_bwd(vol, m, s, coords, g, j, d, w)
    p = torch.softmax(vol.double().cpu().view(b, h * w, j, d)[:, :, j0].reshape(b, -1), -1).view(b, h * w, d)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    c64 = torch.stack([(p.sum(-1) * x).sum(-1), (p.sum(-1) * y).sum(-1), (p.sum(1) * z).sum(-1)], -1)
    gj = g[:, j0].double().cpu()
    dv64 = p * (gj[:, 0, None, None] * (x[:, None] - c64[:, 0, None, None])
                + gj[:, 1, None, None] * (y[:, None] - c64[:, 1, None, None])
                + gj[:, 2, None, None] * (z - c64[:, 2, None, None]))
    err = float((coords[:, j0].double().cpu() - c64).abs().max())
    dv_err = float((dv.double().cpu().view(b, h * w, j, d)[:, :, j0] - dv64).abs().max())
    scale = float(dv64.abs().max())
    # fp32 coords sum p * x over 262,144 near-equal p: 1e-3 voxel from
    # float64 (plain lands 9e-4 from it on a CPU), which enters dv through
    # x - cx: fp32 dv within 5e-4 of its largest (plain: 1.0e-4).
    dv_tol = {torch.bfloat16: TOL_BWD[torch.bfloat16], torch.float32: 5e-4}[dtype]
    if not (err <= 1e-3 and dv_err <= dv_tol * scale):
        raise AssertionError(f"K3/K4 soft peak {dtype}: coords {err}, dv {dv_err} (max {scale}) from float64")
    print(f"K3/K4 soft peak (logit 5 over a flat floor), {str(dtype)[6:]}: coords vs float64 "
          f"{err:.3g} voxel, dv |diff|/max {dv_err / scale:.2e}")
    return err


def volume_phase(iv, gpu: str):
    """K3/K4 vs plain at the heatmap path's shapes and edge cases, bitwise
    determinism, the fp32 flagship volume (2.42 GB, past 2^31 bytes), and
    both timed at (128, 4096, 1152) in bf16 and fp32."""
    hw, w, d = 64 * 64, 64, 64
    errs, dv_errs = [], []

    def add(res):
        errs.append(res[0])
        dv_errs.append(res[1])

    for dtype in (torch.bfloat16, torch.float32):
        add(check_volume(iv, _volume(16, hw, 18 * d, dtype, SEED), 18, d, w, f"J=18 D=64 {str(dtype)[6:]}"))
    add(check_volume(iv, _volume(16, hw, 17 * d, torch.bfloat16, 1), 17, d, w, "J=17 (COCO skeleton)"))
    add(check_volume(iv, _volume(16, hw, 16, torch.bfloat16, 2), 16, 1, w, "D=1, J=16 (2D configs)"))
    add(check_volume(iv, _volume(16, hw, 17, torch.float32, 2), 17, 1, w, "D=1, J=17 fp32 (one-lane loads)"))
    add(check_volume(iv, _volume(16, 96 * 72, 18 * d, torch.bfloat16, 3), 18, d, 72, "H*W = 96*72"))
    centre = torch.tensor([(w - 1) / 2, (hw // w - 1) / 2, (d - 1) / 2], device="cuda").expand(4, 18, 3)
    flat = torch.zeros(4, hw, 18 * d, device="cuda", dtype=torch.bfloat16)
    add(check_volume(iv, flat, 18, d, w, "all-equal logits -> centre", expect=centre))
    r0, z0, j0 = 1234, 17, 5
    flat[:, r0, j0 * d + z0] = 100.0
    expect = centre.clone()
    expect[:, j0] = torch.tensor([r0 % w, r0 // w, z0], dtype=torch.float32, device="cuda")
    add(check_volume(iv, flat, 18, d, w, "one-hot peak -> its voxel", expect=expect))
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(_volume_soft_peak(iv, dtype))
    vol = _volume(16, hw, 18 * d, torch.bfloat16, 4)
    first, again = iv.kernel_stats(vol, 18, d, w), iv.kernel_stats(vol, 18, d, w)
    g = torch.randn(16, 18, 3, generator=torch.Generator().manual_seed(9)).cuda()
    args = (vol, first[1], first[2], first[0], g, 18, d, w)
    if not (all(torch.equal(a, b) for a, b in zip(first, again))
            and torch.equal(iv.kernel_bwd(*args), iv.kernel_bwd(*args))):
        raise AssertionError("K3/K4 are not deterministic: two runs differ")
    print("K3/K4 two runs on the same inputs: coords, m, s and dv bitwise equal")

    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        vol = _volume(TRAIN_BATCH, hw, 18 * d, dtype, 10)
        size = vol.numel() * vol.element_size()
        if dtype == torch.float32:
            if size <= 2**31:
                raise AssertionError(f"the fp32 flagship volume is {size} bytes")
            add(check_volume(iv, vol, 18, d, w, f"fp32 flagship volume, {size} bytes (> 2^31)"))
        coords, m, s = iv.kernel_stats(vol, 18, d, w)
        g = torch.randn(TRAIN_BATCH, 18, 3, generator=torch.Generator().manual_seed(11)).cuda()
        bwd = (vol, m, s, coords, g, 18, d, w)
        runs = {"k3": (lambda: iv.kernel_stats(vol, 18, d, w), []),
                "plain": (lambda: iv.plain(vol, 18, d, w), []),
                "k4": (lambda: iv.kernel_bwd(*bwd), []),
                "plain_bwd": (lambda: iv.plain_bwd(*bwd), [])}
        for name in ("plain", "k3", "k3", "plain", "plain_bwd", "k4", "k4", "plain_bwd"):  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 20 if name.startswith("k") else 2, reps=3))
        timing[dtype] = {k: statistics.median(v[1]) for k, v in runs.items()}
        t = timing[dtype]
        print(f"K3 {str(dtype)[6:]} ({TRAIN_BATCH}, {hw}, {18 * d}): kernel {t['k3']:.4f} ms "
              f"({size / t["k3"] / 1e6:.1f} GB/s read), plain {t['plain']:.4f} ms  [{gpu}]")
        print(f"K4 {str(dtype)[6:]} ({TRAIN_BATCH}, {hw}, {18 * d}): kernel {t['k4']:.4f} ms "
              f"({2 * size / t["k4"] / 1e6:.1f} GB/s read+write), plain_bwd {t['plain_bwd']:.4f} ms  [{gpu}]")
        del vol, runs, bwd, coords, m, s
        torch.cuda.empty_cache()
    t = timing[torch.bfloat16]
    return max(errs), max(dv_errs), (t["k3"], t["plain"]), (t["k4"], t["plain_bwd"])


def _peak_heatmaps(model, image: torch.Tensor, gen: torch.Generator):
    """Redraw the final conv so the heatmap logits have std ~4: the random
    init's head gives near-flat heatmaps, whose coordinates all sit at the
    volume centre and would make any comparison pass."""
    with torch.inference_mode():
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2)))
        rms = float(feat.float().pow(2).mean().sqrt())
        w = model.head.final.weight
        std = 4.0 / (rms * math.sqrt(w.shape[0]))
        w.copy_(torch.randn(w.shape, generator=gen) * std)


def _reference_coords(cfg, model, flip_perm, patches: np.ndarray, fhi) -> np.ndarray:
    """Flip-test coords of a batch of uint8 patches, recomputed on the card
    with the fused op's plain version on the same head features."""
    from ihpr_tpu_torch.data.augment import finalize_patch

    n = len(patches)
    with torch.inference_mode():
        image = finalize_patch(
            torch.from_numpy(patches).cuda(), torch.ones(n, 3, device="cuda"), cfg.data
        )
        both = torch.cat([image, image.flip(2)])
        feat = model.head.features(model.backbone(both.permute(0, 3, 1, 2)))
        bb, h, w, c = feat.shape
        coords = fhi.plain(
            feat.reshape(bb, h * w, c), model.head.final.weight, model.head.final.bias,
            model.joint_num, model.depth_dim, w,
        )[0]
        cf = coords[n:].clone()
        cf[..., 0] = cfg.data.output_shape[1] - 1.0 - cf[..., 0]
        out = (coords[:n] + cf[:, flip_perm]) * 0.5
    return out.cpu().numpy()


def serve_phase(fhi, gpu: str):
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    cfg = get_config("h36m3d_r50")
    in_h, in_w = cfg.data.input_shape
    gen = torch.Generator().manual_seed(SEED)
    model = build_pose_net(cfg, device="cuda", generator=gen)
    rng = np.random.RandomState(SEED)
    patches = rng.randint(0, 256, (80, in_h, in_w, 3)).astype(np.uint8)
    with torch.inference_mode():
        image = finalize_patch(
            torch.from_numpy(patches[:MAX_BATCH]).cuda(),
            torch.ones(MAX_BATCH, 3, device="cuda"), cfg.data,
        )
    _peak_heatmaps(model, image, gen)
    server = PoseServer(cfg, model, max_batch=MAX_BATCH, flip_test=True, device="cuda")
    images = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
              rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8)]
    bboxes = np.array([[100, 80, 200, 300], [300, 50, 180, 360], [10, 10, 400, 450],
                       [500, 100, 300, 500], [900, 200, 250, 480]], np.float32)
    requests = [
        ([images[k % 2]] * (1 + k % 3), bboxes[: 1 + k % 3], np.full(1 + k % 3, 4000.0))
        for k in range(4)
    ]
    server.predict_patches(patches[:MAX_BATCH])  # warm-up: cuDNN setup, kernel load
    torch.cuda.synchronize()

    # --- the main path, counted ---
    fhi.launches = 0
    t0 = time.perf_counter()
    voxels = server.predict_patches(patches)
    t_patches = time.perf_counter() - t0
    results = server.predict([images[0]] * 2 + [images[1]] * 3, bboxes, root_z=np.full(5, 4500.0))
    stream = list(server.predict_stream(requests, depth=2))
    launches = fhi.launches
    # --------------------------------

    dispatches = math.ceil(80 / MAX_BATCH) + 1 + len(requests)
    if launches != dispatches:
        raise AssertionError(f"K1 launched {launches} times for {dispatches} dispatches")
    if voxels.shape != (80, 18, 3) or not np.isfinite(voxels).all():
        raise AssertionError(f"predict_patches gave {voxels.shape}, finite={np.isfinite(voxels).all()}")
    for r in results + [r for res in stream for r in res]:
        if r.coords_img.shape != (18, 3) or not np.isfinite(r.coords_img).all():
            raise AssertionError("predict / predict_stream gave a malformed result")
    if [len(s) for s in stream] != [1 + k % 3 for k in range(4)]:
        raise AssertionError("predict_stream lost or reordered results")
    tail = patches[64:]  # the last dispatch, padded as the server pads it
    chunk = np.concatenate([tail, np.repeat(tail[-1:], MAX_BATCH - len(tail), 0)])
    ref = _reference_coords(cfg, server.model, server.flip_perm, chunk, fhi)[: len(tail)]
    serve_err = float(np.abs(voxels[64:] - ref).max())
    spread = float(np.abs(voxels - voxels.mean()).max())
    if not (serve_err <= 2 * TOL_VOXEL and spread > 1.0):
        raise AssertionError(f"served coords {serve_err} voxel from plain (spread {spread})")
    print(f"serve: predict_patches(80) -> {voxels.shape}, predict 5 people, stream 4 requests; "
          f"K1 launches {launches} = dispatches {dispatches}; coords vs plain {serve_err:.3g} voxel "
          f"(coord spread {spread:.3g})")

    n_disp = math.ceil(80 / MAX_BATCH)
    print(f"serve: predict_patches 80 patches in {n_disp} dispatches: "
          f"{t_patches * 1e3 / n_disp:.3f} ms/dispatch, {80 / t_patches:.1f} img/s (host clock)  [{gpu}]")
    chunk = patches[:MAX_BATCH]
    steady = _cuda_ms(lambda: server.submit_patches(chunk), 10)
    print(f"serve: {MAX_BATCH}-patch flip-test dispatches back to back: {steady:.3f} ms each, "
          f"{MAX_BATCH / steady * 1e3:.1f} img/s (CUDA events)  [{gpu}]")
    return launches


def _head_grad_check(fhi, trainer, batch):
    """One training forward on ``batch`` through the model's head features,
    then the fused op (K1) and the loss's backward (K2) on those saved
    inputs, against plain_bwd on the same inputs."""
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.ops.loss import joint_location_loss

    cfg, model = trainer.cfg, trainer.model
    j, d = model.joint_num, model.depth_dim
    labels = (batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"])
    with torch.no_grad():
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2))).contiguous()
    b, h, w, c = feat.shape
    leaves = [feat.requires_grad_(),
              model.head.final.weight.detach().to(model.head.dtype).requires_grad_(),
              model.head.final.bias.detach().to(model.head.dtype).requires_grad_()]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)  # K1
    joint_location_loss(coords, *labels).backward()  # K2
    cot = coords.detach().requires_grad_()
    (g,) = torch.autograd.grad(joint_location_loss(cot, *labels), cot)
    flat, kernel, bias = feat.detach().view(b, h * w, c), leaves[1].detach(), leaves[2].detach()
    _, m, s = fhi.kernel_stats(flat, kernel, bias, j, d, w)
    args = (flat, kernel, bias, m, s, coords.detach(), g)
    got = (leaves[0].grad.view(b, h * w, c), leaves[1].grad, leaves[2].grad)
    if not all(torch.equal(x, y) for x, y in zip(got, fhi.kernel_bwd(*args, j, d, w))):
        raise AssertionError("autograd's head gradients are not K2's output on the saved inputs")
    return check_bwd(fhi, args, j, d, w, TOL_BWD[torch.bfloat16],
                     f"one train step's head gradients (B={b})")[0]


def train_phase(fhi, gpu: str):
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer

    cfg = get_config("h36m3d_r50")
    if cfg.optim.batch_size_per_device != TRAIN_BATCH:
        raise AssertionError(f"h36m3d_r50 trains at batch {cfg.optim.batch_size_per_device}")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=384, num_workers=8, device="cuda")
    try:
        print(f"train: Trainer built in {time.perf_counter() - t0:.2f} s "
              f"({len(trainer.loader.index)} samples, {'+'.join(cfg.data.trainset)})")
        host = trainer.loader.epoch(99, 3)
        t0 = time.perf_counter()
        host_batches = list(host)
        loader_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        batch, _ = next(prefetch_to_device(iter(host_batches[:1]), "cuda"))
        for _ in range(2):  # warm-up: cuDNN plans, kernel load
            trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        head_err = _head_grad_check(fhi, trainer, batch)

        # --- the main path, counted: one epoch of TRAIN_STEPS steps ---
        trainer.cap_steps_per_epoch(TRAIN_STEPS)
        fhi.launches = fhi.bwd_launches = 0
        t0 = time.perf_counter()
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        k1, k2 = fhi.launches, fhi.bwd_launches
        # ---------------------------------------------------------------
        losses = [float(x) for x in trainer.losses]  # the epoch's losses
        if (k1, k2) != (TRAIN_STEPS, TRAIN_STEPS):
            raise AssertionError(f"K1/K2 launched {k1}/{k2} times in {TRAIN_STEPS} train steps")
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train losses {losses}")
        print(f"train: {TRAIN_STEPS} steps through Trainer.train, K1 launches {k1}, K2 launches "
              f"{k2}; losses {', '.join(f'{x:.4f}' for x in losses)}")
        print(f"train: host clock {t_epoch * 1e3 / TRAIN_STEPS:.3f} ms/step, "
              f"{TRAIN_STEPS * TRAIN_BATCH / t_epoch:.1f} img/s (loader included)  [{gpu}]")
        print(f"train: loader host {loader_ms:.3f} ms per {TRAIN_BATCH}-image batch "
              f"(render + native warp, {len(host_batches)} batches)  [{gpu}]")

        step_ms = _cuda_ms(lambda: trainer.lean_step_fn(batch), 3, reps=1)
        print(f"train: device {step_ms:.3f} ms/step on one resident batch, "
              f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s (CUDA events)  [{gpu}]")
        falling = [float(trainer.lean_step_fn(batch)["loss"]) for _ in range(10)]
        if not (all(math.isfinite(x) for x in falling) and falling[-1] < falling[0]):
            raise AssertionError(f"loss does not fall on one repeated batch: {falling}")
        print(f"train: 10 steps on one repeated batch, loss {falling[0]:.4f} -> {falling[-1]:.4f}")
    finally:
        trainer.close()
    return k1, k2, head_err


def _counts(*mods):
    """(launches, bwd_launches) of each kernel module, in order."""
    return tuple(c for mod in mods for c in (mod.launches, mod.bwd_launches))


def _zero_counts(*mods):
    for mod in mods:
        mod.launches = mod.bwd_launches = 0


def heatmap_phase(fhi, iv, gpu: str):
    """The heatmap-logits path at full width: h36m3d_r50 (lean BN in train
    mode) takes optimizer steps through model(x) -> soft_argmax_from_heatmap
    -> loss. One counted step must launch K3 and K4 once each and K1/K2 not
    at all; its coords and the heatmap's gradient (K4's dv) are held
    against plain / plain_bwd on the same logits. Batch 128 with bf16
    logits, then batch 32 with fp32 logits. Returns (K3, K4) launches and
    the largest coords and dv differences."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader, WarpedHostBatch, prefetch_to_device
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.ops.loss import joint_location_loss
    from ihpr_tpu_torch.parallel.train_step import make_optimizer

    base = get_config("h36m3d_r50")
    loader = BatchLoader([build_dataset("Human36M", "train", base, "synthetic", TRAIN_BATCH)],
                         base, TRAIN_BATCH, num_workers=8, seed=SEED)
    try:
        host = next(loader.epoch(0))
    finally:
        loader.close()
    k3 = k4 = 0
    errs, dv_errs = [], []
    for fp32_logits, bsz in ((False, TRAIN_BATCH), (True, TRAIN_BATCH // 4)):
        cfg = base.replace(model=dataclasses.replace(base.model, fp32_logits=fp32_logits))
        gen = torch.Generator().manual_seed(SEED)
        model = build_pose_net(cfg, device="cuda", generator=gen, trainable=True)
        opt, _ = make_optimizer(model, cfg, steps_per_epoch=10)
        hb = WarpedHostBatch(**{f.name: getattr(host, f.name)[:bsz] for f in dataclasses.fields(host)})
        batch, _ = next(prefetch_to_device(iter([hb]), "cuda"))
        labels = (batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"])
        j, d = model.joint_num, model.depth_dim
        with torch.no_grad():
            _peak_heatmaps(model, finalize_patch(batch["patch"], batch["color_scale"], cfg.data), gen)

        def step(keep=None):
            image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
            opt.zero_grad(set_to_none=True)
            with model.precision():
                hm = model(image)
                if keep is not None:
                    hm.retain_grad()
                    keep.append(hm)
                coords = iv.soft_argmax_from_heatmap(hm, j, d)
                loss = joint_location_loss(coords, *labels)
                loss.backward()
            opt.step()
            return coords.detach(), loss.detach()

        step()  # warm-up: cuDNN plans, kernel load
        torch.cuda.synchronize()

        # --- the main path, counted: one heatmap-path train step ---
        _zero_counts(fhi, iv)
        keep = []
        coords, loss = step(keep)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv)
        # -----------------------------------------------------------
        if counts != (0, 0, 1, 1):
            raise AssertionError(f"heatmap step launched K1/K2/K3/K4 {counts} times, want (0, 0, 1, 1)")
        k3, k4 = k3 + counts[2], k4 + counts[3]
        hm = keep[0]
        vol = hm.detach().view(bsz, -1, j * d)
        if vol.dtype != (torch.float32 if fp32_logits else torch.bfloat16):
            raise AssertionError(f"heatmap is {vol.dtype} with fp32_logits={fp32_logits}")
        want, m, s = iv.plain(vol, j, d, hm.shape[2])
        err = float((coords - want).abs().max())
        spread = float((want - want.mean()).abs().max())
        cot = coords.clone().requires_grad_()
        (g,) = torch.autograd.grad(joint_location_loss(cot, *labels), cot)
        dv_ref = iv.plain_bwd(vol, m, s, coords, g, j, d, hm.shape[2])
        dv = hm.grad.view_as(vol)
        dv_err = float((dv.float() - dv_ref.float()).abs().max())
        scale = float(dv_ref.float().abs().max())
        if not (err <= TOL_VOXEL and spread > 1.0 and math.isfinite(float(loss))):
            raise AssertionError(f"heatmap step coords {err} voxel from plain (spread {spread}), loss {loss}")
        if dv.dtype != vol.dtype or not dv_err <= TOL_BWD[vol.dtype] * scale:
            raise AssertionError(f"heatmap step dv {dv_err} from plain_bwd (max {scale})")
        errs.append(err)
        dv_errs.append(dv_err)
        del keep, hm, vol, dv, dv_ref
        step_ms = _cuda_ms(step, 2, reps=1)
        print(f"heatmap path, h36m3d_r50 batch {bsz}, {'fp32' if fp32_logits else 'bf16'} logits: one step "
              f"launched K3 {counts[2]}, K4 {counts[3]}, K1/K2 0; coords vs plain {err:.3g} voxel "
              f"(spread {spread:.3g}), dv vs plain_bwd |diff|/max {dv_err / scale:.2e}; loss "
              f"{float(loss):.4f}; device {step_ms:.3f} ms/step, {bsz / step_ms * 1e3:.1f} img/s "
              f"(CUDA events)  [{gpu}]")
        del model, opt, batch
        torch.cuda.empty_cache()
    return k3, k4, max(errs), max(dv_errs)


def noplan_phase(fhi, iv, gpu: str):
    """fused_final_conv_integral on heads K1/K2 do not take (C=72, not a
    multiple of 16; D=80, more than 64 bins; the flagship head C=256, D=64
    in fp32): fp32 logits, then K3/K4, forward and backward, against
    autograd through the fused op's plain version. Then the fp32 flagship
    head's times on this route: the forward at (64, 4096, 256), the backward
    at (128, 4096, 256). Returns (K3, K4) launches and the largest coords
    difference."""
    b, h, w, j = 8, 64, 64, 18
    k3 = k4 = 0
    errs = []
    for c, d in ((72, 64), (256, 80), (256, 64)):
        feat, kernel, bias = _head_inputs(b, h * w, c, j * d, torch.float32, 12)
        if fhi.fused_supported(c, d, feat.dtype):
            raise AssertionError(f"C={c}, D={d} should have no K1/K2 plan")
        leaves = [feat.view(b, h, w, c).clone().requires_grad_(),
                  kernel.clone().requires_grad_(), bias.clone().requires_grad_()]
        g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(13)).cuda()
        # --- the main path, counted ---
        _zero_counts(fhi, iv)
        coords = fhi.fused_final_conv_integral(*leaves, j, d)
        coords.backward(g)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv)
        # ------------------------------
        if counts != (0, 0, 1, 1):
            raise AssertionError(f"no-plan C={c} D={d} launched K1/K2/K3/K4 {counts} times")
        k3, k4 = k3 + counts[2], k4 + counts[3]
        ref_leaves = [t.clone().requires_grad_() for t in (feat, kernel, bias)]
        ref = fhi.plain(*ref_leaves, j, d, w)[0]
        ref.backward(g)
        err = float((coords.detach() - ref.detach()).abs().max())
        if not (err <= TOL_VOXEL and float((ref.detach() - ref.detach().mean()).abs().max()) > 1.0):
            raise AssertionError(f"no-plan C={c} D={d}: coords {err} voxel from plain")
        rel = []
        for name, a, r in zip(("dfeat", "dW", "db"), leaves, ref_leaves):
            diff = float((a.grad.reshape(r.grad.shape) - r.grad).abs().max())
            scale = float(r.grad.abs().max())
            if not diff <= TOL_NOPLAN_GRAD * scale:
                raise AssertionError(f"no-plan C={c} D={d} {name}: {diff} from plain (max {scale})")
            rel.append(f"{name} {diff / scale:.2e}")
        errs.append(err)
        print(f"no-plan route C={c} D={d} (fp32, B={b}): K3 {counts[2]}, K4 {counts[3]}, K1/K2 0; "
              f"coords vs plain {err:.3g} voxel; grads |diff|/max " + ", ".join(rel))
    del feat, kernel, bias, leaves, ref_leaves, coords, ref

    c, d = 256, 64
    feat, kernel, bias = _head_inputs(2 * MAX_BATCH, h * w, c, j * d, torch.float32, SEED)
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: fhi.fused_final_conv_integral(feat.view(-1, h, w, c), kernel, bias, j, d),
                          5, reps=3)
    feat, kernel, bias = _head_inputs(TRAIN_BATCH, h * w, c, j * d, torch.float32, SEED)
    leaves = [feat.view(-1, h, w, c).requires_grad_(), kernel.requires_grad_(), bias.requires_grad_()]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    g = torch.randn(TRAIN_BATCH, j, 3, generator=torch.Generator().manual_seed(13)).cuda()
    bwd_ms = _cuda_ms(lambda: torch.autograd.grad(coords, leaves, g, retain_graph=True), 3, reps=3)
    print(f"fp32 flagship head on the no-plan route (fp32 cuBLAS, TF32 off, + K3/K4): forward "
          f"({2 * MAX_BATCH}, {h * w}, {c}) {fwd_ms:.4f} ms, backward ({TRAIN_BATCH}, {h * w}, {c}) "
          f"{bwd_ms:.4f} ms; the scalar fp32 K1/K2 this route replaces took 14.228 / 123.332 ms at "
          f"these shapes (NVIDIA H100 80GB HBM3, 700 W)  [{gpu}]")
    del feat, kernel, bias, leaves, coords
    torch.cuda.empty_cache()
    return k3, k4, max(errs)


def eval_phase(fhi, iv, gpu: str):
    """The Tester on h36m3d_r50 (EVAL_SAMPLES synthetic H36M test samples,
    batch 128, the last padded, flip-test; a bf16 head: K1) and on
    mpii2d_r50 (64 samples, D=1, PCKh; an fp32 head: logits + K3), seeded
    weights with peaked heatmaps: the head's kernel launches once per eval
    batch and nothing else launches; every row of the predictions that
    ``evaluate`` scored (the padded last batch's included) against the
    fused op's plain version on the loader's batches; metrics finite; the
    result files written. Returns K1 and K3 launches and the largest coords
    difference on each route (K1's, K3's)."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    k1 = k3 = 0
    errs = {"K1": [], "K3": []}
    with tempfile.TemporaryDirectory() as tmp:
        for name, route, n, key, files in (
            ("h36m3d_r50", "K1", EVAL_SAMPLES, "MPJPE total",
             ("metrics_Human36M.json", "preds_Human36M.npy", "bbox_root_pose_h36m_output.json")),
            ("mpii2d_r50", "K3", 64, "PCKh@0.5", ("metrics_MPII.json", "preds_MPII.npy", "pred.mat")),
        ):
            cfg = get_config(name).replace(output_dir=f"{tmp}/{name}")
            gen = torch.Generator().manual_seed(SEED)
            model = build_pose_net(cfg, device="cuda", generator=gen)
            dataset = build_dataset(cfg.data.testset, "test", cfg, "synthetic", n)
            tester = Tester(cfg, dataset=dataset, state=model, num_workers=8, device="cuda")
            try:
                host = list(tester.loader.epoch())
                batch, _ = next(prefetch_to_device(iter(host[:1]), "cuda"))
                with torch.inference_mode():
                    image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
                _peak_heatmaps(tester.model, image, gen)
                tester.eval_step(batch)  # warm-up: cuDNN plans
                torch.cuda.synchronize()
                scored = []

                def predict_and_keep(predict=tester.predict_voxels):
                    scored.append(predict())
                    return scored[-1]

                tester.predict_voxels = predict_and_keep  # keeps what evaluate scores

                # --- the main path, counted: Tester.evaluate ---
                _zero_counts(fhi, iv)
                t0 = time.perf_counter()
                metrics = tester.evaluate()
                t_eval = time.perf_counter() - t0
                counts = _counts(fhi, iv)
                # -----------------------------------------------
                batches = len(tester.loader)
                head = tester.model.head
                want = (batches, 0, 0, 0) if route == "K1" else (0, 0, batches, 0)
                if counts != want:
                    raise AssertionError(f"{name} eval launched K1/K2/K3/K4 {counts}, want {want}")
                k1, k3 = k1 + counts[0], k3 + counts[2]
                (vox,) = scored
                perm = torch.as_tensor(skeletons.get_skeleton(cfg.data.testset).flip_permutation(), device="cuda")
                ref = np.full_like(vox, np.nan)
                for hb in host:
                    ref[hb.sample_idx] = _reference_coords(cfg, tester.model, perm, hb.patch, fhi)
                err = float(np.abs(vox - ref).max())
                spread = float(np.abs(ref - ref.mean()).max())
                if not (vox.shape == (n, tester.dataset.joint_num, 3) and err <= 2 * TOL_VOXEL and spread > 1.0):
                    raise AssertionError(f"{name} eval coords {vox.shape}, {err} voxel from plain (spread {spread})")
                errs[route].append(err)
                missing = [f for f in files if not os.path.exists(f"{cfg.output_dir}/result/{f}")]
                if not math.isfinite(metrics[key]) or missing:
                    raise AssertionError(f"{name} eval: {key} {metrics[key]}, missing {missing}")
                print(f"eval {name}: {n} samples in {batches} batches of {cfg.eval.batch_size_per_device} "
                      f"(flip-test {cfg.eval.flip_test}), {str(head.dtype)[6:]} head, K1 launches "
                      f"{counts[0]}, K3 {counts[2]}; {key} "
                      f"{metrics[key]:.2f}; all {n} scored rows vs plain {err:.3g} voxel (spread {spread:.3g}); "
                      f"wrote {', '.join(files)}")
                wait = tester.loader_wait_s
                print(f"eval {name}: Tester.evaluate {t_eval:.3f} s, {n / t_eval:.1f} img/s (host clock, "
                      f"loader included); waiting on the loader {wait * 1e3 / batches:.3f} ms per batch, "
                      f"{wait / t_eval:.2f} of the evaluate wall time  [{gpu}]")
            finally:
                tester.close()
            del model, tester
            torch.cuda.empty_cache()
    return k1, k3, max(errs["K1"]), max(errs["K3"])


# --- K5-K8: the conv + BN-statistics kernels -----------------------------------

# One h36m3d_r50 train step at batch 128 with both fused flags (256x256 input,
# bf16): the 1x1 route's launches of K5/K6, (M, K, N, prologue, launches), and
# the conv3 route's K7/K8 shape (B, H, W, C, N) with its launches.
MM_STEP = (
    (524288, 64, 64, False, 1),    # layer1_0 conv1
    (524288, 256, 64, False, 2),   # layer1_1, layer1_2 conv1
    (524288, 64, 256, True, 3),    # layer1_* conv3 (bn2 prologue)
    (524288, 256, 128, False, 1),  # layer2_0 conv1
    (131072, 512, 128, False, 3),  # layer2_1 ... layer2_3 conv1
    (131072, 128, 512, True, 4),   # layer2_* conv3
    (131072, 512, 256, False, 1),  # layer3_0 conv1
    (32768, 256, 1024, True, 1),   # layer3_0 conv3
)
CONV_STEP = ((128, 16, 16, 256, 256), 5)  # layer3_1 ... layer3_5 conv2
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense) for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, dtype=torch.bfloat16):
    """(least ms, what bounds it) for work of ``flops`` operations in
    ``dtype`` moving ``nbytes`` bytes."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bn_work(x_shape, k, n, taps, item):
    """(fwd flops, fwd bytes, bwd flops, bwd bytes) of K5/K7 and K6/K8: each
    input read once and each output written once (mul/add and the (N,)
    statistics are noise); the backward's two products (dx and dw)."""
    m = math.prod(x_shape)
    prod = 2 * m * k * n * taps
    fwd_bytes = (m * k + taps * k * n + m * n) * item
    bwd_bytes = (m * k + taps * k * n + 2 * m * n + m * k) * item + taps * k * n * 4
    return prod, fwd_bytes, 2 * prod, bwd_bytes


def _bn_inputs(x_shape, k, n, taps, dtype, prologue, seed):
    """x, w ((K, N) or (9, K, N)), mul, add, dy, ds1, ds2 on the card, with
    the statistics' cotangents of the size a BN backward gives them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*x_shape, k, generator=g).to("cuda", dtype)
    w = (torch.randn(taps, k, n, generator=g) / (taps * k) ** 0.5).to("cuda", dtype)
    mul = (torch.rand(k, generator=g) + 0.5).cuda() if prologue else None
    add = (torch.randn(k, generator=g) * 0.2).cuda() if prologue else None
    dy = torch.randn(*x_shape, n, generator=g).to("cuda", dtype)
    ds1 = (torch.randn(n, generator=g) * 0.1).cuda()
    ds2 = (torch.randn(n, generator=g) * 0.01).cuda()
    return x, (w[0] if taps == 1 else w), mul, add, dy, ds1, ds2


def compare_bn(label, names, got, want, dtype, rows):
    """Kernel results against plain ones on the same inputs: y and dx
    within one bf16 step of |plain| (fp32: 1e-4 of the largest, since cuDNN
    may take a Winograd or FFT algorithm for the plain conv); s1 within
    1e-4 of its Cauchy-Schwarz bound sqrt(rows * s2) and s2 within 1e-4
    relative (fp32 sums of the same accumulator in another order); dw,
    dmul, dadd within TOL_BWD of their largest. Returns {name: max|diff|}."""
    plain = dict(zip(names, want))
    errs, rel = {}, []
    for name, a, b in zip(names, got, want):
        if b is None:
            if a is not None:
                raise AssertionError(f"{label} {name}: kernel gave a result where plain gives None")
            continue
        if a.dtype != b.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label} {name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs()
        scale = float(b.double().abs().max())
        if name in ("y", "dx") and dtype == torch.bfloat16:
            ok = bool((diff <= 2.0**-7 * b.double().abs() + 1e-6 * scale).all())
        elif name == "s1":
            scale = float((rows * plain["s2"].double()).sqrt().max())
            ok = float(diff.max()) <= 1e-4 * scale
        elif name == "s2":
            ok = float(diff.max()) <= 1e-4 * scale
        else:
            ok = float(diff.max()) <= TOL_BWD[dtype] * scale
        if not ok:
            raise AssertionError(f"{label} {name}: max|diff| {float(diff.max())} (scale {scale})")
        errs[name] = float(diff.max())
        rel.append(f"{name} {errs[name] / scale if scale else 0.0:.1e}")
    print(f"{label}: |diff|/scale " + ", ".join(rel))
    return errs


FWD_NAMES, BWD_NAMES = ("y", "s1", "s2"), ("dx", "dw", "dmul", "dadd")


def check_bn(mod, args, label):
    """Both kernels against the plain versions on the same inputs (the
    backward takes the plain forward's y). Returns max |y diff|, |dx diff|."""
    x, w, mul, add, dy, ds1, ds2 = args
    want = mod.plain(x, w, mul, add)
    bwd = (x, w, mul, add, want[0], dy, ds1, ds2)
    got = (*mod.kernel_fwd(x, w, mul, add), *mod.kernel_bwd(*bwd))
    torch.cuda.synchronize()
    rows = want[0].numel() // want[0].shape[-1]
    errs = compare_bn(label, FWD_NAMES + BWD_NAMES, got, (*want, *mod.plain_bwd(*bwd)), x.dtype, rows)
    return errs["y"], errs["dx"]


def _library_mm(x, w, mul, add, dy, ds1, ds2):
    """The same two functions through cuBLAS in x's dtype (torch.matmul)
    and elementwise PyTorch: a yardstick only, the port never calls it."""
    pre = x if mul is None else torch.addcmul(add.to(x.dtype), x, mul.to(x.dtype))
    a = x if mul is None else torch.relu(pre)
    y = a @ w

    def fwd():
        yf = (a @ w).float()
        return yf.sum(0), (yf * yf).sum(0)

    def bwd():
        gc = (dy.float() + ds1 + 2 * y.float() * ds2).to(x.dtype)
        da = gc @ w.t()
        if mul is not None:
            t = da * (pre > 0)
            return t * mul.to(x.dtype), a.t() @ gc, (t * x).float().sum(0), t.float().sum(0)
        return da, a.t() @ gc

    return fwd, bwd


def _library_conv(x, w9, mul, add, dy, ds1, ds2):
    """The same through cuDNN in x's dtype (conv2d and its two backward
    convolutions) and elementwise PyTorch: a yardstick only."""
    import torch.nn.functional as F

    c, n = w9.shape[1], w9.shape[2]
    wt = w9.reshape(3, 3, c, n).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 3, 1, 2)
    pre = xn if mul is None else torch.addcmul(add.to(x.dtype)[:, None, None], xn, mul.to(x.dtype)[:, None, None])
    a = xn if mul is None else torch.relu(pre)
    y = F.conv2d(a, wt, padding=1)
    gn = dy.permute(0, 3, 1, 2)

    def fwd():
        yf = F.conv2d(a, wt, padding=1).float()
        return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))

    def bwd():
        gc = (gn.float() + ds1[:, None, None] + 2 * y.float() * ds2[:, None, None]).to(x.dtype)
        da = torch.nn.grad.conv2d_input(a.shape, wt, gc, padding=1)
        dw = torch.nn.grad.conv2d_weight(a, wt.shape, gc, padding=1)
        if mul is not None:
            t = da * (pre > 0)
            return (t * mul.to(x.dtype)[:, None, None], dw, (t * xn).float().sum((0, 2, 3)),
                    t.float().sum((0, 2, 3)))
        return da, dw

    return fwd, bwd


def _time_bn(mod, args, library):
    """Device ms of the kernels, the plain versions and the library
    composition, forward and backward, on the same inputs, in turns."""
    x, w, mul, add, dy, ds1, ds2 = args
    y = mod.kernel_fwd(x, w, mul, add)[0]
    lib_fwd, lib_bwd = library(*args)
    runs = {
        "kernel_fwd": (lambda: mod.kernel_fwd(x, w, mul, add), 10, []),
        "kernel_bwd": (lambda: mod.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2), 10, []),
        "plain_fwd": (lambda: mod.plain(x, w, mul, add), 2, []),
        "plain_bwd": (lambda: mod.plain_bwd(x, w, mul, add, y, dy, ds1, ds2), 2, []),
        "library_fwd": (lib_fwd, 10, []),
        "library_bwd": (lib_bwd, 10, []),
    }
    for kind in ("fwd", "bwd"):
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):  # in turns
            fn, n, out = runs[f"{name}_{kind}"]
            out.append(_cuda_ms(fn, n, reps=2))
    return {k: statistics.median(v[2]) for k, v in runs.items()}


def _launch_ms(fn, calls: int = 3) -> dict:
    """{kernel name: device ms per launch} of the CUDA kernels fn launches,
    averaged over ``calls`` calls (torch.profiler's key_averages; fn runs
    once before, as a warm-up)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages() if e.self_device_time_total > 0}


def _kernel_label(name: str) -> str:
    """A profiler kernel name without its return type, anonymous namespace
    and arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def _host_us(fn, n: int = 50) -> float:
    """Host time to enqueue one call of fn, in us (median of 3 runs of n
    calls), with the card kept busy (torch.cuda._sleep) so that no call
    waits on it."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(5e8))
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def conv_breakdown(cb, args, gpu: str):
    """Where one bf16 K7 call and one K8 call spend their time: each
    sub-launch's device ms (torch.profiler, 3 calls) beside its own bound,
    with TFLOP/s for the products and GB/s for the passes over memory; their
    sum beside the wrapper's host time to enqueue one call."""
    x, w9, mul, add, dy, ds1, ds2 = args
    m, c, n = x.numel() // x.shape[-1], x.shape[-1], w9.shape[-1]
    conv = 2.0 * m * c * n * 9  # flops of one of the three products
    y = cb.kernel_fwd(x, w9, mul, add)[0]
    # (kernel name, label, launches per call, flops, bytes) in launch order.
    work = {
        "K7": [("prep_kernel", "prologue pass a", 1, 0, 4 * m * c),
               ("gemm_kernel<true", "y GEMM + s1/s2 partials", 1, conv, 2 * (m * c + m * n + 9 * c * n)),
               ("reduce_rows", "s1/s2 reduce", 1, 0, 0)],
        "K8": [("prep_kernel", "gc + prologue pass", 1, 0, 4 * m * c + 6 * m * n),
               ("gemm_kernel<false", "da GEMM + prologue backward", 1, conv, 2 * (m * n + 2 * m * c + 9 * c * n)),
               ("dw_kernel", "dw GEMM partials", 1, conv, 2 * (m * c + m * n)),
               ("reduce_rows", "dmul/dadd + dw reduces", 2, 0, 0)],
    }
    calls = {"K7": lambda: cb.kernel_fwd(x, w9, mul, add),
             "K8": lambda: cb.kernel_bwd(x, w9, mul, add, y, dy, ds1, ds2)}
    for key, fn in calls.items():
        per_launch = _launch_ms(fn)
        parts, device_ms = [], 0.0
        for frag, label, per_call, flops, nbytes in work[key]:
            hits = [t for name, t in per_launch.items() if frag in name]
            if len(hits) != 1:
                raise AssertionError(f"{key}: no single {frag} among the profiled kernels {sorted(per_launch)}")
            ms = hits[0] * per_call
            device_ms += ms
            if flops:
                bound = _bound(flops, nbytes)[0]
                parts.append(f"{label} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, {bound / ms:.2f} of its bound)")
            elif nbytes:
                parts.append(f"{label} {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, {nbytes / PEAK_HBM_BYTES * 1e3 / ms:.2f} "
                             f"of its bound)")
            else:
                parts.append(f"{label} {ms:.4f} ms")
        print(f"{key} bf16 {tuple(x.shape)} x {tuple(w9.shape)}, one call's launches: {'; '.join(parts)}; device "
              f"{device_ms:.4f} ms in all, the wrapper's host enqueue {_host_us(fn):.1f} us per call  [{gpu}]")


def bn_kernel_phase(mm, cb, gpu: str):
    """K5/K6 and K7/K8 against their plain versions at every shape of the
    flagship fused step (bf16, with the prologue where the step has it) and
    at edge cases (fp32, M = 1, K = N = 8, the R152 stage-3 plane, B = 1,
    and the bf16 K7/K8 tiles' edges); K7/K8's sub-launches at the flagship;
    two runs bitwise equal; each timed (kernel, plain, library) and summed
    over one step's launches. Returns, per kernel name, (max |y or dx
    diff|, step ms, step plain ms, step library ms, step bound ms, bound by)."""
    errs = {k: 0.0 for k in ("k5", "k6", "k7", "k8")}
    step = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in ("k5", "k6", "k7", "k8")}  # ms, plain, library, ops, bytes

    def add_step(kf, kb, t, work, launches):
        for key, kind, flops, nbytes in ((kf, "fwd", work[0], work[1]), (kb, "bwd", work[2], work[3])):
            acc = step[key]
            acc[0] += launches * t[f"kernel_{kind}"]
            acc[1] += launches * t[f"plain_{kind}"]
            acc[2] += launches * t[f"library_{kind}"]
            acc[3] += launches * flops
            acc[4] += launches * nbytes

    for i, (m, k, n, prologue, launches) in enumerate(MM_STEP):
        args = _bn_inputs((m,), k, n, 1, torch.bfloat16, prologue, SEED + i)
        ey, edx = check_bn(mm, args, f"K5/K6 ({m}, {k}) x ({k}, {n}){' +prologue' if prologue else ''}")
        errs["k5"], errs["k6"] = max(errs["k5"], ey), max(errs["k6"], edx)
        t = _time_bn(mm, args, _library_mm)
        work = _bn_work((m,), k, n, 1, 2)
        add_step("k5", "k6", t, work, launches)
        bwd_bound = _bound(work[2], work[3])[0]
        print(f"K5/K6 ({m}, {k}) x ({k}, {n}) bf16 x{launches}/step: fwd kernel {t['kernel_fwd']:.4f} ms "
              f"(bound {_bound(work[0], work[1])[0]:.4f}), plain {t['plain_fwd']:.4f}, cuBLAS+sums "
              f"{t['library_fwd']:.4f}; bwd kernel {t['kernel_bwd']:.4f} (bound "
              f"{bwd_bound:.4f}), plain {t['plain_bwd']:.4f}, cuBLAS "
              f"{t['library_bwd']:.4f}  [{gpu}]")
        x, w, mul, add, dy, ds1, ds2 = args
        y = mm.kernel_fwd(x, w, mul, add)[0]
        parts = _launch_ms(lambda: mm.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2))
        print(f"K6 ({m}, {k}) x ({k}, {n}){' +prologue' if prologue else ''}: {t['kernel_bwd']:.4f} ms, "
              f"{work[3] / 1e6:.1f} MB, {bwd_bound / t['kernel_bwd']:.2f} of its bound; sub-launches "
              + "; ".join(f"{_kernel_label(name)} {ms:.4f} ms" for name, ms in parts.items())
              + f" (device {sum(parts.values()):.4f})  [{gpu}]")
        del args, x, w, mul, add, dy, ds1, ds2, y
    # Edges: M below a tile, K and N off the 64-grid, and K or N within one
    # box with the other past 256 (bf16 K6 takes two kernels there).
    for dtype, shape, prologue in ((torch.float32, (4096, 256, 128), True), (torch.bfloat16, (1, 8, 8), True),
                                   (torch.float32, (1, 8, 8), False), (torch.bfloat16, (1000, 24, 40), True),
                                   (torch.bfloat16, (300, 64, 512), True), (torch.bfloat16, (300, 512, 64), False)):
        m, k, n = shape
        args = _bn_inputs((m,), k, n, 1, dtype, prologue, SEED + 20)
        ey, edx = check_bn(mm, args, f"K5/K6 {str(dtype)[6:]} ({m}, {k}) x ({k}, {n})")
        errs["k5"], errs["k6"] = max(errs["k5"], ey), max(errs["k6"], edx)

    (b, h, w, c, n), launches = CONV_STEP
    for dtype in (torch.bfloat16, torch.float32):
        args = _bn_inputs((b, h, w), c, n, 9, dtype, True, SEED + 30)
        ey, edx = check_bn(cb, args, f"K7/K8 {str(dtype)[6:]} ({b}, {h}, {w}, {c}) x (9, {c}, {n})")
        errs["k7"], errs["k8"] = max(errs["k7"], ey), max(errs["k8"], edx)
        if dtype == torch.bfloat16:
            t = _time_bn(cb, args, _library_conv)
            work = _bn_work((b, h, w), c, n, 9, 2)
            add_step("k7", "k8", t, work, launches)
            print(f"K7/K8 ({b}, {h}, {w}, {c}) x (9, {c}, {n}) bf16 x{launches}/step: fwd kernel "
                  f"{t['kernel_fwd']:.4f} ms ({work[0] / t['kernel_fwd'] / 1e9:.1f} TFLOP/s, bound "
                  f"{_bound(work[0], work[1])[0]:.4f}), plain {t['plain_fwd']:.4f}, cuDNN+sums "
                  f"{t['library_fwd']:.4f}; bwd kernel {t['kernel_bwd']:.4f} ({work[2] / t['kernel_bwd'] / 1e9:.1f} "
                  f"TFLOP/s, bound {_bound(work[2], work[3])[0]:.4f}), plain {t['plain_bwd']:.4f}, cuDNN "
                  f"{t['library_bwd']:.4f}  [{gpu}]")
            conv_breakdown(cb, args, gpu)
        del args
    # Edges: W = 18 and 3 (boxes run past the image), no prologue, C and N
    # not multiples of 64, the flagship plane at B = 1, an image narrower
    # than a box.
    for shape, prologue in (((2, 24, 18, 256, 256), True), ((1, 16, 16, 64, 64), False), ((1, 5, 3, 8, 16), True),
                            ((5, 16, 16, 200, 136), True), ((1, 16, 16, 256, 256), True), ((2, 3, 5, 64, 64), True)):
        b, h, w, c, n = shape
        args = _bn_inputs((b, h, w), c, n, 9, torch.bfloat16, prologue, SEED + 40)
        ey, edx = check_bn(cb, args, f"K7/K8 bf16 ({b}, {h}, {w}, {c}) x (9, {c}, {n})")
        errs["k7"], errs["k8"] = max(errs["k7"], ey), max(errs["k8"], edx)

    for mod, label, shape, taps in ((mm, "K5/K6", (8192,), 1), (cb, "K7/K8", (8, 16, 16), 9)):
        x, w, mul, add, dy, ds1, ds2 = _bn_inputs(shape, 256, 256, taps, torch.bfloat16, True, SEED + 50)
        first, again = mod.kernel_fwd(x, w, mul, add), mod.kernel_fwd(x, w, mul, add)
        bwd = (x, w, mul, add, first[0], dy, ds1, ds2)
        if not all(torch.equal(a, b) for a, b in zip((*first, *mod.kernel_bwd(*bwd)),
                                                     (*again, *mod.kernel_bwd(*bwd)))):
            raise AssertionError(f"{label} are not deterministic: two runs differ")
        print(f"{label} two runs on the same inputs: y, s1, s2, dx, dw, dmul, dadd bitwise equal")
    torch.cuda.empty_cache()
    out = {}
    for key in ("k5", "k6", "k7", "k8"):
        ms, plain_ms, lib_ms, flops, nbytes = step[key]
        bound_ms, bound_by = _bound(flops, nbytes)
        out[key] = (errs[key], ms, plain_ms, lib_ms, bound_ms, bound_by)
        print(f"{key.upper()} per flagship step: kernel {ms:.4f} ms, plain {plain_ms:.4f}, library "
              f"{lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by})  [{gpu}]")
    return out


class _FirstLaunch:
    """Wraps a kernel wrapper: keeps clones of the inputs and outputs of
    its first launch that ``want(args)`` accepts, and adds nothing else (the
    wrapper itself counts the launch)."""

    def __init__(self, fn, want):
        self.fn, self.want, self.saved = fn, want, None

    def __call__(self, *args):
        out = self.fn(*args)
        if self.saved is None and self.want(args):
            clone = lambda t: None if t is None else t.detach().clone()  # noqa: E731
            self.saved = ([clone(a) for a in args], [clone(o) for o in out])
        return out


def fused_train_phase(fhi, iv, mm, cb, gpu: str):
    """h36m3d_r50 with fused_1x1 and fused_conv3 trains through the Trainer
    at batch 128 (the main path, counted): K5/K6 16 and K7/K8 5 launches
    per step, K1/K2 one. One launch of each of K5-K8 in those steps is held
    against the plain versions on its saved inputs. A fused_1x1-alone step
    (counted: K5/K6 26 each). Then the H100 A/B: device ms per step and
    peak memory with both flags, fused_1x1 alone and unfused (the same
    model, in turns, medians of three rounds) with each one's device-busy
    time, and the loss falling over 10 steps on one repeated batch. Returns
    the main path's K5-K8 launches (the fused_1x1 step's included) and the
    saved launches' largest differences."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.resnet import Bottleneck

    base = get_config("h36m3d_r50")
    cfg = base.replace(model=dataclasses.replace(base.model, fused_1x1=True, fused_conv3=True))
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=384, num_workers=8, device="cuda")
    blocks = [m for m in trainer.model.modules() if isinstance(m, Bottleneck)]

    def set_flags(f1, f3):
        for blk in blocks:
            blk.fused_1x1, blk.fused_conv3 = f1, f3

    wrapped = {}
    try:
        batch, _ = next(prefetch_to_device(trainer.loader.epoch(99, 1), "cuda"))
        for _ in range(2):  # warm-up: kernel loads, cuDNN plans
            trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        with_prologue = lambda args: args[2] is not None  # noqa: E731
        for mod, name in ((mm, "kernel_fwd"), (mm, "kernel_bwd"), (cb, "kernel_fwd"), (cb, "kernel_bwd")):
            wrapped[mod, name] = _FirstLaunch(getattr(mod, name), with_prologue)
            setattr(mod, name, wrapped[mod, name])

        # --- the main path, counted: one epoch of TRAIN_STEPS fused steps ---
        trainer.cap_steps_per_epoch(TRAIN_STEPS)
        _zero_counts(fhi, iv, mm, cb)
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv, mm, cb)
        # ---------------------------------------------------------------------
        for (mod, name), w in wrapped.items():
            setattr(mod, name, w.fn)
        want = tuple(TRAIN_STEPS * k for k in (1, 1, 0, 0, 16, 16, 5, 5))
        if counts != want:
            raise AssertionError(f"fused train steps launched K1-K8 {counts} times, want {want}")
        losses = [float(x) for x in trainer.losses]  # the epoch's losses
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"fused train losses {losses}")
        print(f"fused train: {TRAIN_STEPS} steps through Trainer.train, launches K1-K8 {counts}; "
              f"losses {', '.join(f'{x:.4f}' for x in losses)}")

        errs = {}
        for label, mod in (("K5/K6", mm), ("K7/K8", cb)):
            (f_args, f_out), (b_args, b_out) = wrapped[mod, "kernel_fwd"].saved, wrapped[mod, "kernel_bwd"].saved
            dtype, rows = f_args[0].dtype, f_out[0].numel() // f_out[0].shape[-1]
            errs[label] = (
                compare_bn(f"{label[:2]}, one launch of a counted step", FWD_NAMES, f_out,
                           mod.plain(*f_args), dtype, rows)["y"],
                compare_bn(f"{label[3:]}, one launch of a counted step", BWD_NAMES, b_out,
                           mod.plain_bwd(*b_args), dtype, rows)["dx"],
            )

        set_flags(True, False)
        trainer.lean_step_fn(batch)  # warm-up of the stage-3 1x1 shapes
        torch.cuda.synchronize()
        # --- the main path, counted: one fused_1x1-alone step ---
        _zero_counts(fhi, iv, mm, cb)
        trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        alone = _counts(fhi, iv, mm, cb)
        # --------------------------------------------------------
        if alone != (1, 1, 0, 0, 26, 26, 0, 0):
            raise AssertionError(f"a fused_1x1 step launched K1-K8 {alone} times")
        print(f"fused_1x1 alone: one step launched K1-K8 {alone}")

        # The A/B: the same model with both flags, fused_1x1 alone and
        # unfused, in turns (the order reversed every other round), three
        # rounds of three steps each; medians.
        step = lambda: trainer.lean_step_fn(batch)  # noqa: E731
        flags = {"both flags": (True, True), "fused_1x1 alone": (True, False), "unfused": (False, False)}
        timing, peak = {k: [] for k in flags}, {}
        for rnd in range(3):
            for name in (flags if rnd % 2 == 0 else reversed(flags)):
                set_flags(*flags[name])
                torch.cuda.reset_peak_memory_stats()
                timing[name].append(_cuda_ms(step, 3, reps=1))
                peak[name] = torch.cuda.max_memory_allocated() / 2**30
        for name, ts in timing.items():
            ms = statistics.median(ts)
            print(f"fused train A/B, h36m3d_r50 batch {TRAIN_BATCH}, {name}: {ms:.3f} ms/step median of "
                  f"{', '.join(f'{t:.3f}' for t in ts)} ({TRAIN_BATCH / ms * 1e3:.1f} img/s, peak {peak[name]:.2f} "
                  f"GiB) (CUDA events, same model, in turns)  [{gpu}]")
        # What the device does in one step of each: busy time (the kernels'
        # device time, one stream), against the median above, and K5-K8's share.
        for name, f in flags.items():
            set_flags(*f)
            step()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kinds = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in kinds) / 1e3
            fused = sum(e.self_device_time_total for e in kinds if e.key.split("::")[0].split()[-1] in ("c3", "cbn", "mbh")) / 1e3
            ms = statistics.median(timing[name])
            print(f"fused train profile, {name}: device busy {busy:.3f} ms per step, idle share {1 - busy / ms:.3f} "
                  f"of the median; K5-K8 kernels {fused:.3f} ms; largest: "
                  + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in kinds[:3]) + f"  [{gpu}]")

        set_flags(True, True)
        falling = [float(trainer.lean_step_fn(batch)["loss"]) for _ in range(10)]
        if not (all(math.isfinite(x) for x in falling) and falling[-1] < falling[0]):
            raise AssertionError(f"fused loss does not fall on one repeated batch: {falling}")
        print(f"fused train: 10 steps on one repeated batch, loss {falling[0]:.4f} -> {falling[-1]:.4f}")
    finally:
        for (mod, name), w in wrapped.items():
            setattr(mod, name, w.fn)
        trainer.close()
    launches = tuple(c + a for c, a in zip(counts[4:], alone[4:]))
    return launches, errs


def head_library_phase(fhi, iv, gpu: str):
    """The library composition beside K1 and K2 (a yardstick only): the
    final conv as one cuBLAS addmm, then K3 (K1's function) at K1's serving
    shape (64, 4096, 256) and at the train batch (128, 4096, 256); K4 on
    those logits, then dfeat and dW as two cuBLAS matmuls (K2's function)
    at the train batch; bf16. Returns (K1's at 64, K1's at 128, K2's)."""
    hw, w, c, j, d = 64 * 64, 64, 256, 18, 64
    out = []
    for b in (2 * MAX_BATCH, TRAIN_BATCH):
        feat, kernel, bias = _head_inputs(b, hw, c, j * d, torch.bfloat16, SEED)
        flat = feat.view(-1, c)

        def fwd():
            return iv.kernel_stats(torch.addmm(bias, flat, kernel).view(b, hw, j * d), j, d, w)

        out.append(_cuda_ms(fwd, 5, reps=3))
        if b == TRAIN_BATCH:
            logits = torch.addmm(bias, flat, kernel).view(b, hw, j * d)
            coords, m, s = iv.kernel_stats(logits, j, d, w)
            g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(SEED)).cuda()

            def bwd():
                dv = iv.kernel_bwd(logits, m, s, coords, g, j, d, w).view(-1, j * d)
                return dv @ kernel.t(), flat.t() @ dv, dv.float().sum(0)

            out.append(_cuda_ms(bwd, 5, reps=3))
            del logits
        del feat, flat
    torch.cuda.empty_cache()
    print(f"K1's library composition (cuBLAS addmm + K3): {out[0]:.4f} ms at ({2 * MAX_BATCH}, {hw}, {c}), "
          f"{out[1]:.4f} ms at ({TRAIN_BATCH}, {hw}, {c}); K2's (K4 + two cuBLAS matmuls) at "
          f"({TRAIN_BATCH}, {hw}, {c}): {out[2]:.4f} ms  [{gpu}]")
    return tuple(out)


_HEAD = (64 * 64, 256, 18 * 64)  # the flagship head's (H*W, C, J*D)


def k1_bound(b):
    """(ms, bound_by) of K1 at (b, 4096, 256) x (256, 1152), bf16: the logits
    product against reading feat and W once."""
    hw, c, jd = _HEAD
    return _bound(2 * b * hw * c * jd, (b * hw * c + c * jd) * 2)


def k2_bound(b):
    """(ms, bound_by) of K2 at (b, 4096, 256): three products (the logits
    recomputed, dfeat, dW) against reading feat and W and writing dfeat
    and dW once."""
    hw, c, jd = _HEAD
    return _bound(3 * 2 * b * hw * c * jd, (2 * b * hw * c + 2 * c * jd) * 2)


def head_bounds():
    """(ms, bound_by) of K1 at the serving shape (64, 4096, 256), K2 at the
    train batch (128, 4096, 256), K3 and K4 at the (128, 4096, 1152) volume;
    ~5 fp32 operations per logit for the softmax terms."""
    vol = TRAIN_BATCH * _HEAD[0] * _HEAD[2]
    k3 = max(_bound(5 * vol, 0, torch.float32), _bound(0, 2 * vol))
    k4 = max(_bound(5 * vol, 0, torch.float32), _bound(0, 4 * vol))
    return k1_bound(2 * MAX_BATCH), k2_bound(TRAIN_BATCH), k3, k4


# --- P1/P2: the probe tools (ihpr_tpu_torch.tools) ---------------------------------

EXP_ITERS = 30  # passes per mode in exp_probe's timing
MM_ITERS = 20  # calls per phase in mxu_int8_probe's timing
MM_SIZE = 4096  # M = N = K of mxu_int8_probe's products
PROBE_CONV = (64, 64, 64, 256)  # (B, H, W, C) of its conv9 / convref pair
# exp_probe partials and token against plain, relative (read: bitwise): fp32
# sums in another order and ex2.approx; bexpsum rounds each exp's argument
# to bf16 before ex2.
TOL_EXP = {"sum": 1e-5, "maxsum": 1e-5, "expsum": 1e-5, "exp2sum": 1e-5, "bexpsum": 1e-2}


def exp_probe_phase(ep, gpu: str):
    """P1 on the (128, 4096, 1152) fp32 volume (2.416 GB). The probe path,
    counted: the tool's entry ``main`` times all six modes (CUDA events)
    and checks the read floor. Then, on a new volume, every mode's partials
    and token against plain (read bitwise, the reductions within TOL_EXP),
    two runs bitwise equal, and the plain expsum and the library sum
    (``torch.sum`` over the blocks) timed. Returns (launches, expsum's max
    |diff|, expsum ms, plain ms, library ms, bound ms)."""
    # --- the probe path, counted: exp_probe.main ---
    ep.launches = 0
    results = ep.main(["--iters", str(EXP_ITERS), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = ep.launches
    # -----------------------------------------------
    if launches != len(ep.MODES) * ep.ROUNDS * (EXP_ITERS + 1):
        raise AssertionError(f"exp_probe.main launched the kernel {launches} times")
    x = ep.make_volume("cuda", SEED + 1)
    nbytes = x.numel() * x.element_size()
    errs = {}
    for mode in ep.MODES:
        got, again, want = ep.kernel(x, mode), ep.kernel(x, mode), ep.plain(x, mode)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"exp_probe {mode}: two runs differ")
        rel = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"exp_probe {mode}: {tuple(g.shape)} vs {tuple(w.shape)}, finite "
                                     f"{bool(torch.isfinite(g).all())}")
            if mode == "read":
                if not torch.equal(g, w):
                    raise AssertionError("exp_probe read: partials or token differ from plain")
                continue
            rel = max(rel, float(((g - w).abs() / w.abs()).max()))
            if rel > TOL_EXP[mode]:
                raise AssertionError(f"exp_probe {mode}: {rel} relative from plain (> {TOL_EXP[mode]})")
        errs[mode] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"exp_probe {mode}: partials {tuple(got[0].shape)} and token vs plain max|diff| {errs[mode]:.3g} "
              f"({'bitwise' if mode == 'read' else f'{rel:.2e} relative'}), two runs bitwise equal")
        del got, again, want
    blocks = x.view(ep.B * ep.NCHUNK, -1)
    plain_ms = _cuda_ms(lambda: ep.plain(x, "expsum"), 2, reps=3)
    library_ms = _cuda_ms(lambda: blocks.sum(1), 10, reps=3)
    bound_ms = ep.read_floor_ms(nbytes)
    print(f"exp_probe at ({ep.B}, {ep.NCHUNK * ep.CHUNK}, {ep.LANES}) fp32: expsum {results['expsum']:.4f} ms, "
          f"sum {results['sum']:.4f}, read {results['read']:.4f} (bound {bound_ms:.4f}, bytes); plain expsum "
          f"{plain_ms:.4f} ms; torch.sum over the blocks {library_ms:.4f} ms  [{gpu}]")
    del x, blocks
    torch.cuda.empty_cache()
    return launches, errs["expsum"], results["expsum"], plain_ms, library_ms, bound_ms


def probe_mm_phase(pm, gpu: str):
    """P2 at M = N = K = 4096. The probe path, counted: the tool's entry
    ``main`` times the library products, every tile of the kernel in bf16
    and int8, and the conv9 / convref pair. Then every tile against
    plain_mm at 4096^3 (int8 bitwise, bf16 within 1e-4 of max|plain|) and
    plain_mm timed. Returns (launches, bf16 max |diff|, best bf16 tile ms,
    plain ms, cuBLAS bf16 ms, bound ms, bound by)."""
    size = MM_SIZE
    # --- the probe path, counted: mxu_int8_probe.main ---
    pm.launches = 0
    results = pm.main(["--iters", str(MM_ITERS), "--size", str(size), "--device", "cuda",
                       "--conv", *map(str, PROBE_CONV)])
    torch.cuda.synchronize()
    launches = pm.launches
    # ----------------------------------------------------
    tiles = sum(len(t) for t in pm.TILES.values())
    if launches != tiles * (MM_ITERS + 1):
        raise AssertionError(f"mxu_int8_probe.main launched the kernel {launches} times")
    rng = np.random.RandomState(SEED)
    errs, plain_ms = {}, {}
    for dtype in (torch.bfloat16, torch.int8):
        a, b = (t.cuda() for t in pm._mats(rng, size, size, size, dtype))
        errs[dtype] = pm.check_tiles(a, b)
        plain_ms[dtype] = _cuda_ms(lambda: pm.plain_mm(a, b), 2, reps=3)
        tag = pm.TAGS[dtype]
        bound = 2 * size**3 / pm.PEAK[dtype] * 1e3
        lib_ms = results[f"dot_{tag}"]
        lib_name = "torch._int_mm" if dtype == torch.int8 else "cuBLAS"
        for bm, bn, bk in pm.TILES[dtype]:
            ms = results[f"pallas_{tag}_{bm}x{bn}x{bk}"]
            print(f"probe_mm {tag} tile ({bm}, {bn}, {bk}): {ms:.4f} ms, {2 * size**3 / ms / 1e9:.1f} "
                  f"T{'OP' if dtype == torch.int8 else 'FLOP'}/s, {bound / ms:.2f} of the bound, "
                  f"{ms / lib_ms:.2f}x {lib_name} ({lib_ms:.4f} ms)  [{gpu}]")
        best = min((k for k in results if k.startswith(f"pallas_{tag}_")), key=results.get)
        if dtype == torch.int8:  # the share of B's transpose in one call of the best tile
            bm, bn, bk = map(int, best[len(tag) + 8:].split("x"))
            parts = _launch_ms(lambda: pm.kernel_mm(a, b, bm, bn, bk), calls=5)
            transpose = sum(t for n, t in parts.items() if "transpose" in n)
            print(f"probe_mm int8 {best[len(tag) + 8:]}, one call's launches: "
                  + "; ".join(f"{_kernel_label(name)} {t:.4f} ms" for name, t in parts.items())
                  + (f"; the transpose {transpose / sum(parts.values()):.2f} of the call's device time"
                     if transpose else "; the profiler recorded no transpose launch") + f"  [{gpu}]")
        print(f"probe_mm {tag} {size}^3: every tile vs plain_mm max|diff| {errs[dtype]:.3g}"
              f"{' (bitwise)' if dtype == torch.int8 else ''}; best tile {best[len(tag) + 8:]} "
              f"{results[best]:.4f} ms, library {lib_ms:.4f} ms, plain {plain_ms[dtype]:.4f} ms, "
              f"bound {bound:.4f} ms (operations)  [{gpu}]")
        del a, b
    cb_, ch, cw, cc = PROBE_CONV
    conv_bound = 2 * cb_ * ch * cw * cc * cc * 9 / PEAK_BF16_FLOPS * 1e3
    print(f"probe_mm conv {PROBE_CONV} x (3, 3, {cc}, {cc}): conv9 bf16 {results['conv9_bf16']:.4f} ms, "
          f"int8 {results['conv9_int8']:.4f} ms; convref bf16 (cuDNN) {results['convref_bf16']:.4f} ms; "
          f"bf16 bound {conv_bound:.4f} ms  [{gpu}]")
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(2 * size**3, (2 * size * size * 2 + size * size * 4))
    return (launches, errs[torch.bfloat16], results["pallas_bf16"], plain_ms[torch.bfloat16],
            results["dot_bf16"], bound_ms, bound_by)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    from ihpr_tpu_torch.ops import _build
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.tools import exp_probe as ep
    from ihpr_tpu_torch.tools import mxu_int8_probe as pm

    gpu = _gpu_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 versions are true fp32

    t0 = time.perf_counter()
    libs = _build.build_all([fhi._LIB, fhi._BWD_LIB, iv._FWD_LIB, iv._BWD_LIB,
                             mm._FWD_LIB, mm._BWD_LIB, cb._FWD_LIB, cb._BWD_LIB, ep._LIB, pm._LIB])
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())

    k1_err, k1_times = kernel_phase(fhi, gpu)
    k1_ms, k1_plain = k1_times[2 * MAX_BATCH]  # the serving shape, as b1 and k1_lib
    k2_err, (k2_ms, k2_plain) = k2_phase(fhi, gpu)
    k1_lib, k1_lib_train, k2_lib = head_library_phase(fhi, iv, gpu)
    (k1_train_ms, _), b1_train = k1_times[TRAIN_BATCH], k1_bound(TRAIN_BATCH)[0]
    print(f"K1 at the train batch ({TRAIN_BATCH}, 4096, 256): kernel {k1_train_ms:.4f} ms, library "
          f"{k1_lib_train:.4f} ms, bound {b1_train:.4f} ms; K1 + K2 per train step {k1_train_ms + k2_ms:.4f} "
          f"ms against the library's {k1_lib_train + k2_lib:.4f} ms  [{gpu}]")
    k3_err, k4_err, (k3_ms, k3_plain), (k4_ms, k4_plain) = volume_phase(iv, gpu)
    bn = bn_kernel_phase(mm, cb, gpu)
    serve_k1 = serve_phase(fhi, gpu)
    train_k1, train_k2, head_err = train_phase(fhi, gpu)
    (k5_n, k6_n, k7_n, k8_n), fused_errs = fused_train_phase(fhi, iv, mm, cb, gpu)
    hm_k3, hm_k4, hm_err, hm_dv_err = heatmap_phase(fhi, iv, gpu)
    np_k3, np_k4, np_err = noplan_phase(fhi, iv, gpu)
    eval_k1, eval_k3, eval_k1_err, eval_k3_err = eval_phase(fhi, iv, gpu)
    p1 = exp_probe_phase(ep, gpu)
    p2 = probe_mm_phase(pm, gpu)
    b1, b2, b3, b4 = head_bounds()
    kernels = [
        (fhi._LIB, "ihpr_tpu/ops/fused_head_integral.py:133", serve_k1 + train_k1 + eval_k1,
         max(k1_err, eval_k1_err), k1_ms, k1_plain, *b1, k1_lib),
        (fhi._BWD_LIB, "ihpr_tpu/ops/fused_head_integral.py:153", train_k2,
         max(k2_err, head_err), k2_ms, k2_plain, *b2, k2_lib),
        (iv._FWD_LIB, "ihpr_tpu/ops/integral_pallas.py:201", hm_k3 + np_k3 + eval_k3,
         max(k3_err, hm_err, np_err, eval_k3_err), k3_ms, k3_plain, *b3, None),
        (iv._BWD_LIB, "ihpr_tpu/ops/integral_pallas.py:239", hm_k4 + np_k4,
         max(k4_err, hm_dv_err), k4_ms, k4_plain, *b4, None),
    ]
    for (name, replaces, key, launches), err in zip(
        ((mm._FWD_LIB, "ihpr_tpu/ops/matmul_bn.py:127", "k5", k5_n),
         (mm._BWD_LIB, "ihpr_tpu/ops/matmul_bn.py:151", "k6", k6_n),
         (cb._FWD_LIB, "ihpr_tpu/ops/conv_bn.py:150", "k7", k7_n),
         (cb._BWD_LIB, "ihpr_tpu/ops/conv_bn.py:177", "k8", k8_n)),
        (*fused_errs["K5/K6"], *fused_errs["K7/K8"]),
    ):
        phase_err, ms, plain_ms, lib_ms, bound_ms, bound_by = bn[key]
        kernels.append((name, replaces, launches, max(phase_err, err), ms, plain_ms, bound_ms, bound_by, lib_ms))
    p1_n, p1_err, p1_ms, p1_plain, p1_lib, p1_bound = p1
    kernels.append((ep._LIB, "tools/exp_probe.py:44", p1_n, p1_err, p1_ms, p1_plain, p1_bound, "bytes", p1_lib))
    p2_n, p2_err, p2_ms, p2_plain, p2_lib, p2_bound, p2_by = p2
    kernels.append((pm._LIB, "tools/mxu_int8_probe.py:110", p2_n, p2_err, p2_ms, p2_plain, p2_bound, p2_by, p2_lib))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"ihpr_tpu_torch/ops/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    } for name, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
