"""Smoke run of the PyTorch/CUDA port (ihpr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the environment: torch, CUDA, nvcc, the card's name and power limit.
2. Builds every CUDA kernel of the serving and training paths from
   ihpr_tpu_torch/ops/csrc, one nvcc per source, all at once.
3. K1 (fused head forward): holds it against its plain PyTorch version on
   the card, at the serving shapes and at edge cases, and times both with
   CUDA events (median of repeated launches, in turns).
4. K2 (fused head backward): holds it against plain_bwd at a training
   shape in bf16 and fp32, at J=17, H*W=96*72, all-equal logits and a soft
   peak (checked against float64 on the host), checks that two runs give
   bitwise-equal dW, and times both at the flagship training batch.
5. Serves the flagship config h36m3d_r50 (ResNet-50, 256x256, 18 joints,
   64 depth bins, bf16, flip-test) at max_batch 32 with seeded random
   weights: predict_patches, predict (native warp) and predict_stream.
6. Trains h36m3d_r50 at full width and depth (batch 128, lean BN in train
   mode) through the Trainer on synthetic H36M+MPII: a few warm-up steps,
   then a counted epoch of TRAIN_STEPS steps; the head gradients of one
   step against plain_bwd on the same saved inputs; the loss falling over
   10 steps on one repeated batch; device ms per step (CUDA events),
   host-clock img/s and the loader's host ms per batch.

In 5 and 6 the kernels' launch counters are set to 0 just before the path
runs and read just after; each kernel of the path must have launched as
often as the path dispatched it. Outputs are checked for shape and
finiteness and against the plain versions.

Prints one JSON line of kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; so does a host without CUDA.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_VOXEL = 5e-4  # kernel vs plain coords: same operands, fp32 accumulation
# K2 vs plain_bwd, relative to each result's largest magnitude: bf16 rounds
# dv before both contractions and every result once (2^-8), after fp32 sums
# taken in another order; fp32 differs only by ex2.approx and sum order.
TOL_BWD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
MAX_BATCH = 32
TRAIN_BATCH = 128  # h36m3d_r50's batch_size_per_device
TRAIN_STEPS = 5  # counted steps of the train phase
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
    """K1 vs plain at the serving shapes and edge cases; times at the
    flagship dispatch (2 x 32 flip-test samples, 64x64 heatmap, C=256)."""
    b, hw, w, c, d = 2 * MAX_BATCH, 64 * 64, 64, 256, 64
    errs = []
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = _head_inputs(b, hw, c, 18 * d, dtype, SEED)
        errs.append(check_kernel(fhi, *args, 18, d, w))
        runs = {"plain": (lambda: fhi.plain(*args, 18, d, w), []),
                "kernel": (lambda: fhi.kernel_stats(*args, 18, d, w), [])}
        for name in ("plain", "kernel", "kernel", "plain") * 2:  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 10 if name == "kernel" else 3, reps=3))
        plain_ms, kernel_ms = runs["plain"][1], runs["kernel"][1]
        timing[dtype] = (statistics.median(kernel_ms), statistics.median(plain_ms))
        flops = 2 * b * hw * c * 18 * d
        print(
            f"K1 {str(dtype)[6:]} ({b}, {hw}, {c}) x ({c}, {18 * d}): kernel "
            f"{timing[dtype][0]:.4f} ms ({flops / timing[dtype][0] / 1e9:.1f} TFLOP/s), plain "
            f"{timing[dtype][1]:.4f} ms, max|dcoords| {errs[-1]:.3g} voxel  [{gpu}]"
        )
    errs.append(check_kernel(fhi, *_head_inputs(b, hw, c, 17 * d, torch.bfloat16, 1), 17, d, w))
    print(f"K1 J=17 (COCO skeleton): max|dcoords| {errs[-1]:.3g} voxel")
    errs.append(check_kernel(fhi, *_head_inputs(b, 96 * 72, c, 18 * d, torch.bfloat16, 2), 18, d, 72))
    print(f"K1 H*W = 96*72: max|dcoords| {errs[-1]:.3g} voxel")
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
    return max(errs), timing[torch.bfloat16]


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


def _soft_peak_check(fhi, dtype):
    """A logit of 5 over a flat floor at one voxel (p spread over the whole
    volume, dv nonzero everywhere): dW's column for that voxel against
    float64 on the host from the same dtype-rounded inputs."""
    b, h, w, c, j, d = 2, 64, 64, 256, 18, 64
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
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err, scale = float((col - ref).abs().max()), float(ref.abs().max())
    if not (scale > 1e-3 and err <= tol * scale):
        raise AssertionError(f"K2 soft peak {dtype}: dW column {err} from float64 (max {scale})")
    print(f"K2 soft peak (logit 5 over a flat floor), {str(dtype)[6:]}: dW column vs float64 "
          f"|diff|/max {err / scale:.2e}")
    return err


def k2_phase(fhi, gpu: str):
    """K2 vs plain_bwd at a training shape (B=16, 64x64, C=256, J=18, D=64)
    and edge cases; bitwise determinism of dW; times at B=128."""
    hw, w, c, d = 64 * 64, 64, 256, 64
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        args = _bwd_inputs(fhi, 16, hw, c, 18, d, w, dtype, SEED)
        err, got = check_bwd(fhi, args, 18, d, w, TOL_BWD[dtype], f"train shape {str(dtype)[6:]}")
        errs.append(err)
        if dtype == torch.bfloat16:
            again = fhi.kernel_bwd(*args, 18, d, w)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("K2 is not deterministic: two runs differ")
            print("K2 two runs on the same inputs: dfeat, dW, db bitwise equal")
    bf16 = TOL_BWD[torch.bfloat16]
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, hw, c, 17, d, w, torch.bfloat16, 1), 17, d, w,
                          bf16, "J=17 (COCO skeleton)")[0])
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, 96 * 72, c, 18, d, 72, torch.bfloat16, 2),
                          18, d, 72, bf16, "H*W = 96*72")[0])
    feat, kernel, bias, m, s, coords, g = _bwd_inputs(fhi, 4, hw, c, 18, d, w, torch.bfloat16, 3)
    feat, kernel, bias = (torch.zeros_like(t) for t in (feat, kernel, bias))
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, 18, d, w)
    errs.append(check_bwd(fhi, (feat, kernel, bias, m, s, coords, g), 18, d, w, bf16,
                          "all-equal logits (db only: feat = W = 0)",
                          want=(torch.zeros_like(feat), torch.zeros_like(kernel),
                                fhi.plain_bwd(feat, kernel, bias, m, s, coords, g, 18, d, w)[2]))[0])
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(_soft_peak_check(fhi, dtype))

    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = _bwd_inputs(fhi, TRAIN_BATCH, hw, c, 18, d, w, dtype, 4)
        runs = {"plain": (lambda: fhi.plain_bwd(*args, 18, d, w), []),
                "kernel": (lambda: fhi.kernel_bwd(*args, 18, d, w), [])}
        for name in ("plain", "kernel", "kernel", "plain"):  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 3 if name == "kernel" and dtype == torch.bfloat16 else 1, reps=3))
        timing[dtype] = (statistics.median(runs["kernel"][1]), statistics.median(runs["plain"][1]))
        flops = 4 * 2 * TRAIN_BATCH * hw * c * 18 * d
        print(f"K2 {str(dtype)[6:]} ({TRAIN_BATCH}, {hw}, {c}) x ({c}, {18 * d}): kernel "
              f"{timing[dtype][0]:.4f} ms ({flops / timing[dtype][0] / 1e9:.1f} TFLOP/s over its "
              f"4 matmuls), plain_bwd {timing[dtype][1]:.4f} ms  [{gpu}]")
    del args, runs
    torch.cuda.empty_cache()
    return max(errs), timing[torch.bfloat16]


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


def _reference_coords(server, patches: np.ndarray, fhi, finalize_patch) -> np.ndarray:
    """The server's flip-test coords for one max_batch chunk, recomputed on
    the card with the fused op's plain version on the same head features."""
    cfg, model = server.cfg, server.model
    n = len(patches)
    chunk = np.concatenate([patches, np.repeat(patches[-1:], MAX_BATCH - n, 0)])
    with torch.inference_mode():
        image = finalize_patch(
            torch.from_numpy(chunk).cuda(), torch.ones(MAX_BATCH, 3, device="cuda"), cfg.data
        )
        both = torch.cat([image, image.flip(2)])
        feat = model.head.features(model.backbone(both.permute(0, 3, 1, 2)))
        bb, h, w, c = feat.shape
        coords = fhi.plain(
            feat.reshape(bb, h * w, c), model.head.final.weight, model.head.final.bias,
            model.joint_num, model.depth_dim, w,
        )[0]
        cf = coords[MAX_BATCH:].clone()
        cf[..., 0] = cfg.data.output_shape[1] - 1.0 - cf[..., 0]
        out = (coords[:MAX_BATCH] + cf[:, server.flip_perm]) * 0.5
    return out[:n].cpu().numpy()


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
    ref = _reference_coords(server, patches[64:], fhi, finalize_patch)
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
        n0 = len(trainer.losses)
        fhi.launches = fhi.bwd_launches = 0
        t0 = time.perf_counter()
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        k1, k2 = fhi.launches, fhi.bwd_launches
        # ---------------------------------------------------------------
        losses = [float(x) for x in trainer.losses[n0:]]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    from ihpr_tpu_torch.ops import _build
    from ihpr_tpu_torch.ops import fused_head_integral as fhi

    gpu = _gpu_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 versions are true fp32

    t0 = time.perf_counter()
    libs = _build.build_all([fhi._LIB, fhi._BWD_LIB])
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())

    k1_err, (k1_ms, k1_plain) = kernel_phase(fhi, gpu)
    k2_err, (k2_ms, k2_plain) = k2_phase(fhi, gpu)
    serve_k1 = serve_phase(fhi, gpu)
    train_k1, train_k2, head_err = train_phase(fhi, gpu)
    kernels = [
        (fhi._LIB, "ihpr_tpu/ops/fused_head_integral.py:133", serve_k1 + train_k1, k1_err,
         k1_ms, k1_plain),
        (fhi._BWD_LIB, "ihpr_tpu/ops/fused_head_integral.py:153", train_k2,
         max(k2_err, head_err), k2_ms, k2_plain),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"ihpr_tpu_torch/ops/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    } for name, replaces, launches, err, ms, plain_ms in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
