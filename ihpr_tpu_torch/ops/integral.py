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
