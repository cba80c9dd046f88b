"""Joint-coordinate L1 loss with visibility / depth masking, counterpart of
``ihpr_tpu.ops.loss``.

``|coord_out - gt| * joint_vis`` per axis, with the z term also masked by
``joints_have_depth`` so 2D datasets (MPII, COCO) supervise x and y only;
the mean is over all B*J*3 elements.
"""

from __future__ import annotations

from typing import Tuple

import torch


def joint_location_loss(
    coord_out: torch.Tensor,
    joint_img: torch.Tensor,
    joint_vis: torch.Tensor,
    joints_have_depth: torch.Tensor,
) -> torch.Tensor:
    """Masked mean L1 over voxel coords: coord_out, joint_img (B, J, 3),
    joint_vis (B, J) or (B, J, 1), joints_have_depth (B,) or (B, 1), both in
    {0, 1}. Invisible joints count as zeros in the mean; they are not
    removed from the denominator."""
    vis = joint_vis.reshape(joint_vis.shape[0], -1, 1).to(torch.float32)
    have_depth = joints_have_depth.reshape(-1, 1, 1).to(torch.float32)
    err = (coord_out.to(torch.float32) - joint_img.to(torch.float32)).abs()
    z_mask = torch.cat([torch.ones_like(err[..., :2]), have_depth.expand_as(err[..., 2:])], dim=-1)
    return (err * vis * z_mask).mean()


def joint_location_loss_sums(
    coord_out: torch.Tensor,
    joint_img: torch.Tensor,
    joint_vis: torch.Tensor,
    joints_have_depth: torch.Tensor,
) -> torch.Tensor:
    """The four sums of ``joint_location_loss_components`` as one (4,)
    tensor: (visible xy error, visible joints, supervised z error,
    supervised joints). Sums of several batches (data-parallel ranks) give
    the components of their union with ``components_from_sums``."""
    vis = joint_vis.reshape(joint_vis.shape[0], -1).to(torch.float32)
    hd = joints_have_depth.reshape(-1, 1).to(torch.float32)
    err = (coord_out.to(torch.float32) - joint_img.to(torch.float32)).abs()
    zw = vis * hd
    return torch.stack([(err[..., :2].mean(-1) * vis).sum(), vis.sum(), (err[..., 2] * zw).sum(), zw.sum()])


def components_from_sums(sums: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean visible xy error, mean supervised z error) from the sums of
    ``joint_location_loss_sums``."""
    return sums[0] / sums[1].clamp_min(1.0), sums[2] / sums[3].clamp_min(1.0)


def joint_location_loss_components(
    coord_out: torch.Tensor,
    joint_img: torch.Tensor,
    joint_vis: torch.Tensor,
    joints_have_depth: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Diagnostic split of the loss, in voxels: mean visible xy error and
    mean supervised z error. Logged, never differentiated."""
    return components_from_sums(joint_location_loss_sums(coord_out, joint_img, joint_vis, joints_have_depth))
