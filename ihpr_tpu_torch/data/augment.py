"""Device tail of the host-warp path: colour scale, clip, ImageNet normalize."""

from __future__ import annotations

import torch

from ihpr_tpu_torch.config import DataConfig


def finalize_patch(
    patch_u8: torch.Tensor, color_scale: torch.Tensor, cfg: DataConfig
) -> torch.Tensor:
    """(B, H, W, 3) uint8 patch + (B, 3) colour scale -> (B, H, W, 3) fp32
    normalized image, on the patch's device."""
    img = patch_u8.to(torch.float32) * color_scale[:, None, None, :]
    img = img.clamp(0.0, 255.0)
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=img.device) * 255.0
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=img.device) * 255.0
    return (img - mean) / std
