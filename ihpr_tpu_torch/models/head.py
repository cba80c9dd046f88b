"""Deconvolution head: stride-32 features -> stride-4 heatmap volumes,
counterpart of ``ihpr_tpu.models.head.DeconvHead``.

3 x [ConvTranspose2d(4, stride 2, padding 1) + BN + ReLU], then a final
1x1 conv C -> J*D. The final conv's weight is held as a (C, J*D) matrix in
the compute dtype, and its bias in the compute dtype too (the JAX head
casts both before the fused op), so the fused kernel reads them as they
are and the plain logits path multiplies by the same values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ihpr_tpu_torch.models.resnet import BN
from ihpr_tpu_torch.ops.fused_head_integral import fused_final_conv_integral


class FinalConv(nn.Module):
    """1x1 conv as a (C, J*D) weight matrix and a (J*D,) bias."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=dtype, device=device))


class DeconvHead(nn.Module):
    def __init__(
        self,
        cin: int,
        out_channels: int,
        num_layers: int,
        features: int,
        dtype: torch.dtype,
        bn_mode: str,
        fp32_logits: bool,
        device=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.fp32_logits = fp32_logits
        for i in range(num_layers):
            self.add_module(
                f"deconv{i + 1}",
                nn.ConvTranspose2d(
                    cin if i == 0 else features, features, 4, stride=2, padding=1,
                    bias=False, dtype=dtype, device=device,
                ),
            )
            self.add_module(f"bn{i + 1}", BN(features, bn_mode, dtype, device=device))
        self.final = FinalConv(features, out_channels, dtype, device)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, h, w) -> (B, H, W, C) penultimate features. With
        channels_last input the permute is a contiguous view, so the
        (B, H*W, C) matrix the fused kernel reads costs no copy."""
        for i in range(1, self.num_layers + 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"deconv{i}")(x)))
        return x.permute(0, 2, 3, 1)

    def forward(self, x, mode: str = "logits", joint_num=None, depth_dim=None):
        """mode='logits': (B, H, W, J*D) heatmap logits. mode='coords':
        (B, J, 3) voxel coords through the fused final-conv + integral op."""
        feat = self.features(x)
        if mode == "coords":
            return fused_final_conv_integral(
                feat, self.final.weight, self.final.bias, joint_num, depth_dim
            )
        logits = torch.matmul(feat, self.final.weight) + self.final.bias
        return logits.to(torch.float32) if self.fp32_logits else logits
