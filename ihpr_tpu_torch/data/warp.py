"""Patch affine matrices on the host (numpy); the port's copy of
``gen_trans_np`` and ``trans_point2d_np`` from ``ihpr_tpu.data.warp``.

``gen_trans_np`` maps SOURCE pixel -> DESTINATION patch pixel (``inv=True``
gives the inverse, which the warp samples with), from three control points
(centre, centre + down, centre + right) rotated in source space.
"""

from __future__ import annotations

import numpy as np


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
