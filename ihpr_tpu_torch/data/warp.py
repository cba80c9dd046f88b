"""Patch affines and the device warp, counterpart of ``ihpr_tpu.data.warp``.

``gen_trans_np`` / ``trans_point2d_np`` are the host (numpy) copies the
host-warp loader and the warp-back use. ``gen_trans``, ``trans_point2d``,
``affine_warp_bilinear`` and the flips run on a device with torch tensors:
the canvas path (``data/augment.py:make_patch_batch``) and the server's warp
when the native library is missing.

``gen_trans*`` maps SOURCE pixel -> DESTINATION patch pixel (``inv=True``
gives the inverse, which the warp samples with), from three control points
(centre, centre + down, centre + right) rotated in source space.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def gen_trans_np(
    c_x, c_y, src_width, src_height, dst_width, dst_height, scale, rot_deg, inv=False
) -> np.ndarray:
    """Patch transform from bbox centre/size + scale/rotation -> (..., 2, 3)."""
    c_x, c_y, src_width, src_height, scale, rot_deg = np.broadcast_arrays(
        *[np.asarray(a, np.float32) for a in (c_x, c_y, src_width, src_height, scale, rot_deg)]
    )
    src_w = src_width * scale
    src_h = src_height * scale
    rad = np.pi * rot_deg / 180.0
    sn, cs = np.sin(rad), np.cos(rad)

    def rot2d(vx, vy):
        return np.stack([vx * cs - vy * sn, vx * sn + vy * cs], -1)

    src_center = np.stack([c_x, c_y], -1)
    src_down = rot2d(np.zeros_like(src_h), src_h * 0.5)
    src_right = rot2d(src_w * 0.5, np.zeros_like(src_w))
    shp = src_center.shape
    dst_center = np.broadcast_to(
        np.array([dst_width * 0.5, dst_height * 0.5], np.float32), shp
    )
    dst_down = np.broadcast_to(np.array([0.0, dst_height * 0.5], np.float32), shp)
    dst_right = np.broadcast_to(np.array([dst_width * 0.5, 0.0], np.float32), shp)

    src = np.stack([src_center, src_center + src_down, src_center + src_right], -2)
    dst = np.stack([dst_center, dst_center + dst_down, dst_center + dst_right], -2)
    if inv:
        src, dst = dst, src

    # Closed-form 3-point affine: L = [U V] @ [u v]^-1, t = dst0 - L @ src0.
    u = src[..., 1, :] - src[..., 0, :]
    v = src[..., 2, :] - src[..., 0, :]
    U = dst[..., 1, :] - dst[..., 0, :]
    V = dst[..., 2, :] - dst[..., 0, :]
    inv_det = 1.0 / (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0])
    a = v[..., 1] * inv_det
    b = -v[..., 0] * inv_det
    c = -u[..., 1] * inv_det
    d = u[..., 0] * inv_det
    l00 = U[..., 0] * a + V[..., 0] * c
    l01 = U[..., 0] * b + V[..., 0] * d
    l10 = U[..., 1] * a + V[..., 1] * c
    l11 = U[..., 1] * b + V[..., 1] * d
    t0 = dst[..., 0, 0] - (l00 * src[..., 0, 0] + l01 * src[..., 0, 1])
    t1 = dst[..., 0, 1] - (l10 * src[..., 0, 0] + l11 * src[..., 0, 1])
    return np.stack(
        [np.stack([l00, l01, t0], -1), np.stack([l10, l11, t1], -1)], -2
    ).astype(np.float32)


def trans_point2d_np(pt: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """(..., 2) points through (..., 2, 3) affines."""
    ones = np.ones(pt.shape[:-1] + (1,), pt.dtype)
    return np.einsum("...ij,...j->...i", trans, np.concatenate([pt, ones], -1))


# --- the device warp (counterpart of the jnp half of ihpr_tpu.data.warp) ---


def rotate_2d(pt: torch.Tensor, rot_rad: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 2) points by ``rot_rad`` (broadcast over the leading axes)."""
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    x = pt[..., 0] * cs - pt[..., 1] * sn
    y = pt[..., 0] * sn + pt[..., 1] * cs
    return torch.stack([x, y], dim=-1)


def _affine_from_3pts(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The (..., 2, 3) affine M with M @ [src_i, 1] = dst_i for the 3 points of
    (..., 3, 2) ``src`` / ``dst``: L = [U V] @ [u v]^-1, t = dst0 - L @ src0,
    elementwise (no matmul, so no TF32)."""
    u = src[..., 1, :] - src[..., 0, :]
    v = src[..., 2, :] - src[..., 0, :]
    U = dst[..., 1, :] - dst[..., 0, :]
    V = dst[..., 2, :] - dst[..., 0, :]
    inv_det = 1.0 / (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0])
    a = v[..., 1] * inv_det
    b = -v[..., 0] * inv_det
    c = -u[..., 1] * inv_det
    d = u[..., 0] * inv_det
    l00 = U[..., 0] * a + V[..., 0] * c
    l01 = U[..., 0] * b + V[..., 0] * d
    l10 = U[..., 1] * a + V[..., 1] * c
    l11 = U[..., 1] * b + V[..., 1] * d
    t0 = dst[..., 0, 0] - (l00 * src[..., 0, 0] + l01 * src[..., 0, 1])
    t1 = dst[..., 0, 1] - (l10 * src[..., 0, 0] + l11 * src[..., 0, 1])
    return torch.stack([torch.stack([l00, l01, t0], -1), torch.stack([l10, l11, t1], -1)], -2)


def gen_trans(
    c_x, c_y, src_width, src_height, dst_width: int, dst_height: int, scale, rot_deg, inv: bool = False
) -> torch.Tensor:
    """``gen_trans_np`` batched on a device: the arguments may be tensors
    (on one device) or numbers, broadcast together; -> (..., 2, 3) fp32 on
    the tensors' device."""
    args = (c_x, c_y, src_width, src_height, scale, rot_deg)
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    c_x, c_y, src_width, src_height, scale, rot_deg = torch.broadcast_tensors(
        *[torch.as_tensor(a, dtype=torch.float32, device=device) for a in args]
    )
    src_w = src_width * scale
    src_h = src_height * scale
    rot_rad = math.pi * rot_deg / 180.0

    src_center = torch.stack([c_x, c_y], -1)
    src_down = rotate_2d(torch.stack([torch.zeros_like(src_h), src_h * 0.5], -1), rot_rad)
    src_right = rotate_2d(torch.stack([src_w * 0.5, torch.zeros_like(src_w)], -1), rot_rad)

    def const(x, y):
        return torch.tensor([x, y], dtype=torch.float32, device=src_center.device).expand(src_center.shape)

    dst_center = const(dst_width * 0.5, dst_height * 0.5)
    src = torch.stack([src_center, src_center + src_down, src_center + src_right], -2)
    dst = torch.stack(
        [dst_center, dst_center + const(0.0, dst_height * 0.5), dst_center + const(dst_width * 0.5, 0.0)], -2
    )
    if inv:
        src, dst = dst, src
    return _affine_from_3pts(src, dst)


def trans_point2d(pt: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(..., 2) points through (..., 2, 3) affines, in fp32 multiply-adds:
    joint labels must not round through TF32 (JAX pins this product to
    ``Precision.HIGHEST``)."""
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack(
        [trans[..., 0, 0] * x + trans[..., 0, 1] * y + trans[..., 0, 2],
         trans[..., 1, 0] * x + trans[..., 1, 1] * y + trans[..., 1, 2]],
        dim=-1,
    )


def affine_warp_bilinear(
    images: torch.Tensor, inv_trans: torch.Tensor, out_shape: Tuple[int, int]
) -> torch.Tensor:
    """Batched inverse-map bilinear warp (the ``cv2.warpAffine`` equivalent),
    on the images' device.

    ``images``: (B, H, W, C) canvases of any dtype, H, W >= 2; ``inv_trans``:
    (B, 2, 3) DESTINATION -> SOURCE affines (``gen_trans(..., inv=True)``);
    ``out_shape``: (out_h, out_w). Returns (B, out_h, out_w, C) fp32; samples
    outside the image are 0 (cv2's BORDER_CONSTANT).

    As JAX's: each output pixel gathers the 2x2 taps starting at
    floor(source coordinate), the starts clamped to [0, W-2] x [0, H-2], and
    weights each tap by the bilinear hat at its real coordinate, so taps
    past the border, and pixels wholly outside, weigh 0. The sampling
    coordinates are fp32 multiply-adds, not a (TF32) matmul."""
    b, h, w, c = images.shape
    out_h, out_w = out_shape
    dev = images.device
    inv_trans = inv_trans.to(device=dev, dtype=torch.float32)
    gy, gx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    t = inv_trans[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    sx = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]  # (B, oh, ow)
    sy = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    # Clamp before the integer cast: a float past int range has no defined cast.
    x0f = torch.floor(sx).clamp(0, w - 2)
    y0f = torch.floor(sy).clamp(0, h - 2)
    x0, y0 = x0f.long(), y0f.long()
    bi = torch.arange(b, device=dev)[:, None, None]

    def tap(yi, xi):  # gathered in the images' dtype, then fp32
        return images[bi, yi, xi].to(torch.float32)

    wx0 = (1.0 - (sx - x0f).abs()).clamp_min(0.0)[..., None]
    wx1 = (1.0 - (sx - (x0f + 1.0)).abs()).clamp_min(0.0)[..., None]
    wy0 = (1.0 - (sy - y0f).abs()).clamp_min(0.0)[..., None]
    wy1 = (1.0 - (sy - (y0f + 1.0)).abs()).clamp_min(0.0)[..., None]
    return (
        tap(y0, x0) * (wy0 * wx0)
        + tap(y0, x0 + 1) * (wy0 * wx1)
        + tap(y0 + 1, x0) * (wy1 * wx0)
        + tap(y0 + 1, x0 + 1) * (wy1 * wx1)
    )


def flip_image(images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of (B, H, W, C) images."""
    return images.flip(2)


def flip_joints(joints_xy: torch.Tensor, joint_vis: torch.Tensor, flip_perm, width: float):
    """Mirror joint x (x -> width - 1 - x) and swap the left/right pairs
    (``flip_perm``, an involution) of (..., J, 2+) joints and (..., J) vis."""
    x = width - 1.0 - joints_xy[..., 0]
    flipped = torch.cat([x[..., None], joints_xy[..., 1:]], dim=-1)
    return flipped[..., flip_perm, :], joint_vis[..., flip_perm]
