"""Camera, bbox and alignment geometry on the host (numpy); the port's copy
of ``ihpr_tpu.data.geometry`` (reference ``common/utils/pose_utils.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def cam2pixel(cam_coord: np.ndarray, f: Sequence[float], c: Sequence[float]) -> np.ndarray:
    """(N, 3) camera-space mm -> (N, 3) [u px, v px, Z mm]."""
    x = cam_coord[..., 0] / cam_coord[..., 2] * f[0] + c[0]
    y = cam_coord[..., 1] / cam_coord[..., 2] * f[1] + c[1]
    return np.stack([x, y, cam_coord[..., 2]], axis=-1)


def pixel2cam(pixel_coord: np.ndarray, f: Sequence[float], c: Sequence[float]) -> np.ndarray:
    """(N, 3) [u, v, Z mm] -> (N, 3) camera-space mm."""
    x = (pixel_coord[..., 0] - c[0]) / f[0] * pixel_coord[..., 2]
    y = (pixel_coord[..., 1] - c[1]) / f[1] * pixel_coord[..., 2]
    return np.stack([x, y, pixel_coord[..., 2]], axis=-1)


def world2cam(world: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N, 3) world mm -> camera mm via x_cam = R @ (x_world) + t."""
    return world @ R.T + t.reshape(1, 3)


def process_bbox(
    bbox: np.ndarray, img_width: int, img_height: int, aspect_ratio: float, margin: float = 1.25
) -> np.ndarray | None:
    """Sanitize an (x, y, w, h) bbox: clip to the image, force the target
    aspect ratio (input W/H), expand by ``margin``. Returns None for a
    degenerate box, which the caller drops."""
    x, y, w, h = bbox
    x1 = np.max((0, x))
    y1 = np.max((0, y))
    x2 = np.min((img_width - 1, x1 + np.max((0, w - 1))))
    y2 = np.min((img_height - 1, y1 + np.max((0, h - 1))))
    if w * h > 0 and x2 >= x1 and y2 >= y1:
        bbox = np.array([x1, y1, x2 - x1, y2 - y1], dtype=np.float32)
    else:
        return None

    w, h = bbox[2], bbox[3]
    c_x, c_y = bbox[0] + w / 2.0, bbox[1] + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    bbox = np.array(
        [c_x - w * margin / 2.0, c_y - h * margin / 2.0, w * margin, h * margin],
        dtype=np.float32,
    )
    return bbox


def z_voxel_to_mm(z_vox: np.ndarray, bbox_3d_z: float, depth_dim: int) -> np.ndarray:
    """[0, depth_dim] voxel z -> root-relative mm: (z/D*2 - 1) * (bbox_3d/2)."""
    return (z_vox / depth_dim * 2.0 - 1.0) * (bbox_3d_z / 2.0)


def warp_coord_to_original(
    coords_voxel: np.ndarray,
    trans_inv: np.ndarray,
    output_shape: Tuple[int, int],
    input_shape: Tuple[int, int],
    depth_dim: int,
    bbox_3d_z: float,
    root_z: float,
) -> np.ndarray:
    """(J, 3) voxel coords -> (J, 3) [orig px, orig px, abs mm]: voxel ->
    input px (x * in/out) -> inverse patch affine -> original px; z: voxel
    -> root-relative mm -> + root depth."""
    xy = np.empty((coords_voxel.shape[0], 2), np.float32)
    xy[:, 0] = coords_voxel[:, 0] / output_shape[1] * input_shape[1]
    xy[:, 1] = coords_voxel[:, 1] / output_shape[0] * input_shape[0]
    ones = np.ones((xy.shape[0], 1), np.float32)
    xy = np.concatenate([xy, ones], axis=1) @ trans_inv.T  # (J, 2)
    z = z_voxel_to_mm(coords_voxel[:, 2], bbox_3d_z, depth_dim) + root_z
    return np.concatenate([xy, z[:, None]], axis=1)


def rigid_transform_3d(A: np.ndarray, B: np.ndarray):
    """Similarity transform (scale c, rotation R, translation t) minimizing
    ||c*A@R.T + t - B||, with reflection correction: the Procrustes
    alignment of H36M protocol 1. Returns (c, R, t)."""
    assert A.shape == B.shape and A.shape[1] == 3
    n = A.shape[0]
    mu_a, mu_b = A.mean(0), B.mean(0)
    Ac, Bc = A - mu_a, B - mu_b
    var_a = (Ac**2).sum() / n
    H = Ac.T @ Bc / n
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    c = float(np.trace(np.diag(S) @ D) / var_a)
    t = mu_b - c * R @ mu_a
    return c, R, t


def rigid_align(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Align A onto B with the similarity transform (PA-MPJPE preprocessing)."""
    c, R, t = rigid_transform_3d(A, B)
    return c * A @ R.T + t
