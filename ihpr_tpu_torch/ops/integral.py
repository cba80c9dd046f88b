"""Integral soft-argmax: volumetric softmax + per-axis expectation (plain
PyTorch). fp32 whatever the input dtype: the softmax over D*H*W elements
is precision-sensitive."""

from __future__ import annotations

import torch


def _expectation(marginal: torch.Tensor) -> torch.Tensor:
    """(..., N) probability marginal -> (...,) expected index."""
    idx = torch.arange(marginal.shape[-1], dtype=marginal.dtype, device=marginal.device)
    return (marginal * idx).sum(-1)


def soft_argmax_3d(logits: torch.Tensor) -> torch.Tensor:
    """(B, J, D, H, W) heatmap logits -> (B, J, 3) voxel coords (x, y, z):
    x indexes W, y indexes H, z indexes D."""
    b, j, d, h, w = logits.shape
    x = logits.to(torch.float32).reshape(b, j, d * h * w)
    p = torch.softmax(x, dim=-1).reshape(b, j, d, h, w)
    accu_x = p.sum(dim=(2, 3))  # (B, J, W)
    accu_y = p.sum(dim=(2, 4))  # (B, J, H)
    accu_z = p.sum(dim=(3, 4))  # (B, J, D)
    return torch.stack(
        [_expectation(accu_x), _expectation(accu_y), _expectation(accu_z)], dim=-1
    )


def soft_argmax_2d(logits: torch.Tensor) -> torch.Tensor:
    """(B, J, H, W) heatmap logits -> (B, J, 2) coords (x, y)."""
    b, j, h, w = logits.shape
    x = logits.to(torch.float32).reshape(b, j, h * w)
    p = torch.softmax(x, dim=-1).reshape(b, j, h, w)
    return torch.stack([_expectation(p.sum(dim=2)), _expectation(p.sum(dim=3))], dim=-1)


def soft_argmax_1d(logits: torch.Tensor) -> torch.Tensor:
    """(..., N) logits -> (...,) expected index under softmax."""
    return _expectation(torch.softmax(logits.to(torch.float32), dim=-1))


def heatmap_to_volume(heatmap: torch.Tensor, joint_num: int, depth_dim: int) -> torch.Tensor:
    """The head's (B, H, W, J*D) channels-last logits -> the (B, J, D, H, W)
    volume ``soft_argmax_3d`` takes: the channel axis split as (J, D) and
    moved before the spatial axes (a view)."""
    b, h, w, c = heatmap.shape
    if c != joint_num * depth_dim:
        raise ValueError(f"{c} channels are not {joint_num} joints x {depth_dim} bins")
    return heatmap.reshape(b, h, w, joint_num, depth_dim).permute(0, 3, 4, 1, 2)
