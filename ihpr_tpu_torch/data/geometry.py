"""Bbox and coordinate geometry on the host (numpy); the port's copy of the
serving helpers in ``ihpr_tpu.data.geometry``."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
