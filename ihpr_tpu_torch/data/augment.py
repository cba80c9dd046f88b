"""Augmentation and patch generation on the device, counterpart of
``ihpr_tpu.data.augment``.

Two input paths end here. The host-warp path (``data/pipeline.py``'s
``WarpedHostBatch``) brings warped uint8 patches, and the device only runs
``finalize_patch`` (colour scale, clip, ImageNet normalize). The canvas path
(``HostBatch``) brings fixed-size uint8 canvases cropped around each bbox
with the (origin, scale) that maps canvas pixels back to image pixels, and
``make_patch_batch`` does the rest on the canvases' device: the patch
affines, the flip, the bilinear warp, colour jitter, normalize, and the
joints through the same transforms.

Augmentation distributions (reference ``get_aug_config``), drawn by
``sample_aug_params`` from a ``torch.Generator``:
  scale ~ 1 + scale_factor * clip(N(0,1), -1, 1)
  rot   ~ rot_factor * clip(N(0,1), -2, 2) with prob rot_prob, else 0
  flip  ~ Bernoulli(flip_prob)
  color ~ U[1 - color_factor, 1 + color_factor] per RGB channel
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ihpr_tpu_torch.config import DataConfig
from ihpr_tpu_torch.data.warp import affine_warp_bilinear, gen_trans, gen_trans_np, trans_point2d


@dataclasses.dataclass(frozen=True)
class PatchBatch:
    """A batch ready for the model, on the device."""

    image: torch.Tensor  # (B, in_h, in_w, 3) fp32, normalized
    joint_img: torch.Tensor  # (B, J, 3) voxel coords (x, y, z)
    joint_vis: torch.Tensor  # (B, J) {0, 1}
    joints_have_depth: torch.Tensor  # (B,) {0, 1}


def _normalize(img: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=img.device) * 255.0
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=img.device) * 255.0
    return (img - mean) / std


def finalize_patch(
    patch_u8: torch.Tensor, color_scale: torch.Tensor, cfg: DataConfig
) -> torch.Tensor:
    """(B, H, W, 3) uint8 patch + (B, 3) colour scale -> (B, H, W, 3) fp32
    normalized image, on the patch's device."""
    img = patch_u8.to(torch.float32) * color_scale[:, None, None, :]
    return _normalize(img.clamp(0.0, 255.0), cfg)


def sample_aug_params(generator: torch.Generator, batch: int, cfg: DataConfig):
    """(scale (B,), rot (B,) degrees, do_flip (B,) bool, color (B, 3)) drawn
    from ``generator``, on its device. Reference ``get_aug_config``,
    vectorized over the batch."""
    kw = dict(generator=generator, device=generator.device)
    scale = 1.0 + cfg.scale_factor * torch.randn(batch, **kw).clamp(-1.0, 1.0)
    rot = cfg.rot_factor * torch.randn(batch, **kw).clamp(-2.0, 2.0)
    rot = torch.where(torch.rand(batch, **kw) <= cfg.rot_prob, rot, 0.0)
    do_flip = torch.rand(batch, **kw) < cfg.flip_prob
    lo = 1.0 - cfg.color_factor
    color = lo + (2.0 * cfg.color_factor) * torch.rand((batch, 3), **kw)
    return scale, rot, do_flip, color


def patch_batch_from_params(
    canvas: torch.Tensor,  # (B, Hc, Wc, 3) uint8/float source crops
    canvas_origin: torch.Tensor,  # (B, 2) image-px coords of canvas (0, 0)
    canvas_scale: torch.Tensor,  # (B,) image px per canvas px
    bbox: torch.Tensor,  # (B, 4) x, y, w, h in image px
    joints: torch.Tensor,  # (B, J, 3) x, y image px; z root-relative mm
    joint_vis: torch.Tensor,  # (B, J)
    joints_have_depth: torch.Tensor,  # (B,)
    flip_perm,  # (J,) left/right involution
    cfg: DataConfig,
    scale: torch.Tensor,
    rot: torch.Tensor,
    do_flip: torch.Tensor,
    color: torch.Tensor,
) -> PatchBatch:
    """``make_patch_batch`` with the augmentation already drawn: (B,) scale,
    (B,) rotation in degrees, (B,) bool flip, (B, 3) colour scale, moved to
    the canvases' device."""
    dev = canvas.device
    b, _, wc, _ = canvas.shape
    in_h, in_w = cfg.input_shape
    out_h, out_w = cfg.output_shape
    depth_dim = cfg.depth_dim
    scale, rot, do_flip, color = (t.to(dev) for t in (scale, rot, do_flip, color))
    color = color.to(torch.float32)
    perm = torch.as_tensor(flip_perm, device=dev)

    # bbox centre and size in canvas pixels.
    inv_cs = 1.0 / canvas_scale
    c_x = (bbox[:, 0] + bbox[:, 2] * 0.5 - canvas_origin[:, 0]) * inv_cs
    c_y = (bbox[:, 1] + bbox[:, 3] * 0.5 - canvas_origin[:, 1]) * inv_cs
    src_w = bbox[:, 2] * inv_cs
    src_h = bbox[:, 3] * inv_cs

    # Flip: mirror the canvas and the bbox centre's x (the reference flips the
    # whole image; the same on the canvas, since a flip commutes with the crop).
    canvas_used = torch.where(do_flip[:, None, None, None], canvas.flip(2), canvas)
    c_x = torch.where(do_flip, wc - 1.0 - c_x, c_x)

    trans_inv = gen_trans(c_x, c_y, src_w, src_h, in_w, in_h, scale, rot, inv=True)
    patch = affine_warp_bilinear(canvas_used, trans_inv, (in_h, in_w))
    image = _normalize((patch * color[:, None, None, :]).clamp(0.0, 255.0), cfg)

    # Joints: the same flip (x mirror, pair swap), then the patch affine.
    xy = (joints[:, :, :2] - canvas_origin[:, None, :]) * inv_cs[:, None, None]
    flipped = torch.stack([wc - 1.0 - xy[:, :, 0], xy[:, :, 1]], -1)[:, perm]
    xy = torch.where(do_flip[:, None, None], flipped, xy)
    vis = torch.where(do_flip[:, None], joint_vis[:, perm], joint_vis)
    z = torch.where(do_flip[:, None], joints[:, perm, 2], joints[:, :, 2])

    trans_fwd = gen_trans(c_x, c_y, src_w, src_h, in_w, in_h, scale, rot)
    xy_patch = trans_point2d(xy, trans_fwd[:, None])
    # An in-plane rotation turns the pose about the z axis; the root-relative
    # depth is unchanged (the reference leaves z alone).
    x_hm = xy_patch[..., 0] / in_w * out_w
    y_hm = xy_patch[..., 1] / in_h * out_h
    z_hm = z / (cfg.bbox_3d_shape[0] / 2.0) * (depth_dim / 2.0) + depth_dim / 2.0

    # Visibility gated on the joint landing inside the patch volume.
    inside = (
        (x_hm >= 0) & (x_hm < out_w)
        & (y_hm >= 0) & (y_hm < out_h)
        & (z_hm >= 0) & (z_hm < depth_dim)
    )
    return PatchBatch(
        image=image,
        joint_img=torch.stack([x_hm, y_hm, z_hm], -1),
        joint_vis=vis * inside.to(vis.dtype),
        joints_have_depth=joints_have_depth.to(torch.float32),
    )


def no_aug_params(batch: int, device=None):
    """The identity draws: scale 1, no rotation, no flip, colour 1."""
    return (
        torch.ones(batch, device=device),
        torch.zeros(batch, device=device),
        torch.zeros(batch, dtype=torch.bool, device=device),
        torch.ones((batch, 3), device=device),
    )


def make_patch_batch(
    canvas: torch.Tensor,
    canvas_origin: torch.Tensor,
    canvas_scale: torch.Tensor,
    bbox: torch.Tensor,
    joints: torch.Tensor,
    joint_vis: torch.Tensor,
    joints_have_depth: torch.Tensor,
    flip_perm,
    cfg: DataConfig,
    generator: Optional[torch.Generator] = None,
    train: bool = True,
) -> PatchBatch:
    """The reference ``__getitem__`` pipeline for a whole batch, on the
    canvases' device: with ``train`` and ``cfg.use_aug`` the augmentation is
    drawn from ``generator`` (``sample_aug_params``), else none is applied.
    Arguments as ``patch_batch_from_params``'s."""
    b = canvas.shape[0]
    if train and cfg.use_aug:
        if generator is None:
            raise ValueError("make_patch_batch(train=True) with use_aug needs a generator")
        params = sample_aug_params(generator, b, cfg)
    else:
        params = no_aug_params(b)
    return patch_batch_from_params(
        canvas, canvas_origin, canvas_scale, bbox, joints, joint_vis, joints_have_depth,
        flip_perm, cfg, *params,
    )


def eval_patch_transforms(
    bbox: np.ndarray, input_shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 4) bboxes -> forward and inverse patch affines (N, 2, 3) in image
    coordinates, without augmentation (host, numpy). The inverse is what
    ``geometry.warp_coord_to_original`` takes at eval."""
    c_x = bbox[:, 0] + bbox[:, 2] * 0.5
    c_y = bbox[:, 1] + bbox[:, 3] * 0.5
    args = (c_x, c_y, bbox[:, 2], bbox[:, 3], input_shape[1], input_shape[0], 1.0, 0.0)
    return gen_trans_np(*args), gen_trans_np(*args, inv=True)
