"""Keypoint and skeleton overlays, counterpart of ``ihpr_tpu.utils.vis``
(reference ``common/utils/vis.py``): ``vis_keypoints`` draws a 2-D pose on
an image with cv2 (anti-aliased limbs in one colour each, white joints),
``vis_3d_skeleton`` plots a 3-D pose with matplotlib, and
``save_debug_grid`` tiles a batch of patches with their poses.

They draw on host numpy images with the same cv2 and matplotlib calls as
the JAX package, imported inside each function, so an overlay is bitwise
JAX's with the same cv2. Where cv2 or matplotlib is missing they raise
``ImportError`` naming it; nothing draws another way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ihpr_tpu_torch.data.skeletons import Skeleton


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the vis overlays draw with cv2 (opencv-python), which is not installed") from e
    return cv2


def _limb_colors(n: int):
    import colorsys

    return [
        tuple(int(255 * c) for c in colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0))
        for i in range(n)
    ]


def vis_keypoints(
    img: np.ndarray,
    joints_xy: np.ndarray,
    skeleton: Skeleton,
    joint_vis: Optional[np.ndarray] = None,
    radius: int = 3,
    thickness: int = 2,
    alpha: float = 1.0,
) -> np.ndarray:
    """Draw a 2D pose on an HWC uint8 image; returns a new image."""
    cv2 = _cv2()
    out = img.copy()
    overlay = img.copy()
    if joint_vis is None:
        joint_vis = np.ones(len(joints_xy))
    colors = _limb_colors(len(skeleton.skeleton))
    for (a, b), color in zip(skeleton.skeleton, colors):
        if joint_vis[a] > 0 and joint_vis[b] > 0:
            pa = tuple(np.round(joints_xy[a, :2]).astype(int))
            pb = tuple(np.round(joints_xy[b, :2]).astype(int))
            cv2.line(overlay, pa, pb, color, thickness, cv2.LINE_AA)
    for j, (x, y) in enumerate(joints_xy[:, :2]):
        if joint_vis[j] > 0:
            cv2.circle(overlay, (int(round(x)), int(round(y))), radius, (255, 255, 255), -1, cv2.LINE_AA)
    cv2.addWeighted(overlay, alpha, out, 1 - alpha, 0, out)
    return out


def vis_3d_skeleton(
    joints_xyz: np.ndarray,
    skeleton: Skeleton,
    joint_vis: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    title: str = "",
):
    """3D skeleton plot (matplotlib, Agg); returns the figure. z up, y into
    the screen: the reference's camera-frame orientation."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("vis_3d_skeleton plots with matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if joint_vis is None:
        joint_vis = np.ones(len(joints_xyz))
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    colors = _limb_colors(len(skeleton.skeleton))
    for (a, b), color in zip(skeleton.skeleton, colors):
        if joint_vis[a] > 0 and joint_vis[b] > 0:
            xs = [joints_xyz[a, 0], joints_xyz[b, 0]]
            ys = [joints_xyz[a, 2], joints_xyz[b, 2]]
            zs = [-joints_xyz[a, 1], -joints_xyz[b, 1]]
            ax.plot(xs, ys, zs, color=np.asarray(color) / 255.0)
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def save_debug_grid(
    images: np.ndarray,
    joints_xy_patch: np.ndarray,
    skeleton: Skeleton,
    path: str,
    pixel_mean: Sequence[float],
    pixel_std: Sequence[float],
    max_images: int = 16,
):
    """Un-normalize a batch of (N, H, W, 3) training patches, overlay their
    poses, tile them into a grid and write it to ``path`` with
    ``cv2.imwrite``: the reference's ``output/vis`` spot check. Returns the
    RGB grid."""
    cv2 = _cv2()
    n = min(len(images), max_images)
    mean = np.asarray(pixel_mean, np.float32) * 255.0
    std = np.asarray(pixel_std, np.float32) * 255.0
    tiles = []
    for i in range(n):
        img = np.clip(images[i] * std + mean, 0, 255).astype(np.uint8)
        tiles.append(vis_keypoints(img, joints_xy_patch[i], skeleton))
    side = int(np.ceil(np.sqrt(len(tiles))))
    h, w = tiles[0].shape[:2]
    grid = np.zeros((side * h, side * w, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, side)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = t
    cv2.imwrite(path, grid[:, :, ::-1])  # RGB -> BGR for imwrite
    return grid
