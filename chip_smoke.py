"""Smoke run of the PyTorch/CUDA port (ihpr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the environment: torch, CUDA, nvcc, the card's name and power limit.
2. Builds every CUDA kernel of the serving path from ihpr_tpu_torch/ops/csrc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at edge cases, and times both with
   CUDA events (median of repeated launches).
4. Serves the flagship config h36m3d_r50 (ResNet-50, 256x256, 18 joints,
   64 depth bins, bf16, flip-test) at max_batch 32 with seeded random
   weights: predict_patches, predict (native warp) and predict_stream.
   The kernels' launch counters are set to 0 just before and read just
   after; each kernel must have launched. Coords are checked for shape and
   finiteness and against the plain version on the same head features.

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
MAX_BATCH = 32
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
    lib = _build.build(fhi._LIB)
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip())

    max_err, (k_ms, p_ms) = kernel_phase(fhi, gpu)
    launches = serve_phase(fhi, gpu)
    print(json.dumps({"kernels": [{
        "name": fhi._LIB,
        "route": "cuda",
        "source": f"ihpr_tpu_torch/ops/csrc/{fhi._LIB}.cu",
        "replaces": "ihpr_tpu/ops/fused_head_integral.py:133",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
