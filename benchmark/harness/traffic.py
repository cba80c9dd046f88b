"""The one generator of inputs: reads a traffic file's parameters and makes
the cell's inputs from the seed. What each parameter means is written
beside it in the traffic file's ``about``.

- ``train_resident``: a ring of distinct train batches on the device, as
  the Trainer's loader hands them to the step: host-warped uint8 patches
  (the augmentation baked into the rendered pose), a colour scale per
  sample, heatmap-space joints, their visibility and whether the sample has
  depth (Human3.6M rows do, MPII rows do not and lack some joints).
- ``serve_stream``: a pool of frames made during set-up, and a schedule of
  requests, each one frame with its people's boxes, due at a fixed rate.
  Every seed gets the same people counts in each block of requests, in its
  own order, so seeds differ in order and not in work.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from benchmark.harness import common


def _blobs(gen, n: int, k: int, h: int, w: int, sigma, amp, device) -> torch.Tensor:
    """(n, h, w, 3): the sum of ``k`` coloured Gaussian blobs per image at
    random centres (separable, one batched product)."""
    cy = torch.rand(n, k, 1, generator=gen, device=device) * h
    cx = torch.rand(n, k, 1, generator=gen, device=device) * w
    s = sigma[0] + (sigma[1] - sigma[0]) * torch.rand(n, k, 1, generator=gen, device=device)
    color = (torch.rand(n, k, 3, generator=gen, device=device) * 2 - 1) * amp
    gy = torch.exp(-0.5 * ((torch.arange(h, device=device) - cy) / s) ** 2)
    gx = torch.exp(-0.5 * ((torch.arange(w, device=device) - cx) / s) ** 2)
    return torch.einsum("nkh,nkw,nkc->nhwc", gy, gx, color)


def _background(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) smooth random colour fields around grey, with a finer texture."""
    coarse = torch.randn(n, 3, 6, 8, generator=gen, device=device) * 45.0
    fine = torch.randn(n, 3, max(1, h // 8), max(1, w // 8), generator=gen, device=device) * 12.0
    size = (h, w)
    img = (torch.nn.functional.interpolate(coarse, size=size, mode="bilinear", align_corners=False)
           + torch.nn.functional.interpolate(fine, size=size, mode="bilinear", align_corners=False))
    return 128.0 + img.permute(0, 2, 3, 1)


def _u8(img: torch.Tensor) -> torch.Tensor:
    return img.clamp(0, 255).round().to(torch.uint8).contiguous()


def train_ring(t: Dict, sizes: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``t["ring"]`` batches of ``sizes["batch_size"]`` samples on ``device``."""
    gen = common.generator(seed, common.TRAIN_INPUTS, device)
    b, j, d = sizes["batch_size"], sizes["joint_num"], sizes["depth_dim"]
    (in_h, in_w), (out_h, out_w) = sizes["input_shape"], sizes["output_shape"]
    ring = []
    for _ in range(t["ring"]):
        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=device)

        mpii = rand(b) < t["mpii_share"]
        # The root near the patch centre (the crop follows the person), the
        # joints spread about it, depth about the middle of the volume.
        root = torch.stack([out_w * (0.5 + t["root_jitter"] * (rand(b) - 0.5)),
                            out_h * (0.5 + t["root_jitter"] * (rand(b) - 0.5))], -1)
        spread = torch.tensor([out_w, out_h], dtype=torch.float32, device=device) * t["joint_spread"]
        xy = root[:, None, :] + torch.randn(b, j, 2, generator=gen, device=device) * spread
        xy = torch.minimum(xy.clamp_min(0.5), torch.tensor([out_w - 1.5, out_h - 1.5], device=device))
        z = (d / 2 + torch.randn(b, j, generator=gen, device=device) * d * t["depth_spread"]).clamp(0.5, d - 1.5)
        vis = torch.ones(b, j, device=device)
        missing = torch.zeros(j, dtype=torch.bool, device=device)
        missing[t["mpii_missing_joints"]] = True
        occluded = rand(b, j) < t["mpii_occluded_share"]
        vis = torch.where(mpii[:, None] & (missing[None] | occluded), 0.0, vis)
        # The patch: a background with the person's joints drawn as blobs.
        px = xy * torch.tensor([in_w / out_w, in_h / out_h], device=device)
        sig = t["joint_blob_px"]
        gy = torch.exp(-0.5 * ((torch.arange(in_h, device=device) - px[..., 1:2]) / sig) ** 2)
        gx = torch.exp(-0.5 * ((torch.arange(in_w, device=device) - px[..., 0:1]) / sig) ** 2)
        color = (rand(b, j, 3) * 2 - 1) * 90.0
        img = _background(gen, b, in_h, in_w, device) + torch.einsum("bjh,bjw,bjc->bhwc", gy, gx, color)
        lo = 1.0 - t["color_factor"]
        ring.append({
            "patch": _u8(img),
            "color_scale": lo + 2 * t["color_factor"] * rand(b, 3),
            "joint_img": torch.cat([xy, z[..., None]], -1).contiguous(),
            "joint_vis": vis,
            "joints_have_depth": (~mpii).to(torch.float32),
        })
    return ring


def frames(t: Dict, seed: int, device) -> torch.Tensor:
    """(pool, H, W, 3) uint8 frames on ``device``."""
    gen = common.generator(seed, common.FRAMES, device)
    h, w = t["frame_hw"]
    out = []
    for s in range(0, t["pool"], 8):
        n = min(8, t["pool"] - s)
        img = _background(gen, n, h, w, device) + _blobs(gen, n, t["frame_blobs"], h, w, t["frame_blob_px"], 90.0,
                                                          device)
        out.append(_u8(img))
    return torch.cat(out)


def people_block(t: Dict) -> np.ndarray:
    """The people counts of one block of requests: the quantiles of
    P(n) proportional to n^-alpha on [min, max] at (i + 0.5) / block."""
    p = t["people"]
    n = np.arange(p["min"], p["max"] + 1)
    cdf = np.cumsum(n ** -float(p["alpha"]))
    cdf /= cdf[-1]
    q = (np.arange(t["block"]) + 0.5) / t["block"]
    return n[np.searchsorted(cdf, q)]


def requests(t: Dict, seed: int, stream: int = common.REQUESTS) -> Iterator[Tuple[int, np.ndarray]]:
    """Endless (frame index, (N, 4) boxes x, y, w, h) requests."""
    rng = common.host_rng(seed, stream)
    block = people_block(t)
    h, w = t["frame_hw"]
    lo, hi = t["person_height_px"]
    while True:
        for n in rng.permutation(block):
            heights = np.exp(rng.uniform(math.log(lo), math.log(hi), n))
            widths = heights * rng.uniform(*t["person_aspect"], n)
            x = rng.uniform(0, 1, n) * (w - widths)
            y = rng.uniform(0, 1, n) * (h - heights)
            yield int(rng.integers(t["pool"])), np.stack([x, y, widths, heights], -1).astype(np.float32)
