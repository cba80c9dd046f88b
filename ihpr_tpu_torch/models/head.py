"""Deconvolution head: stride-32 features -> stride-4 heatmap volumes,
counterpart of ``ihpr_tpu.models.head.DeconvHead``.

3 x [ConvTranspose2d(4, stride 2, padding 1) + BN + ReLU], then a final
1x1 conv C -> J*D. Every weight is an fp32 master, as in the JAX head; the
deconvs cast theirs to the compute dtype per call, and the final conv's
(C, J*D) weight and (J*D,) bias are cast to the compute dtype before the
fused op or the plain logits matmul (``head.py:143-148``), so autograd
returns fp32 gradients through the casts.

Row-sharded (``dp`` of spatial > 1), each deconv takes one row of each
neighbour (``mesh.halo_rows``, zeros past the image's edges) and runs with
padding 3 in H, which crops its output to the rank's 2h rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ihpr_tpu_torch.models.resnet import BN
from ihpr_tpu_torch.ops.fused_head_integral import fused_final_conv_integral
from ihpr_tpu_torch.parallel.mesh import DataParallel, halo_rows


class FinalConv(nn.Module):
    """1x1 conv as an fp32 (C, J*D) weight matrix and an fp32 (J*D,) bias."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32, device=device))


class Deconv(nn.ConvTranspose2d):
    """ConvTranspose2d(4, stride 2, padding 1), bias-free, with an fp32
    master weight cast to ``compute_dtype`` on each call. ``rows``
    (``DataParallel.row_axis``): the input is this rank's h rows; with one
    halo row above and below, output row q of the h + 2 rows, less the
    padding, is row q - 3 of the rank's output, so padding 3 in H leaves
    exactly its 2h rows."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype, device=None,
                 rows: DataParallel | None = None):
        super().__init__(
            cin, cout, 4, stride=2, padding=1, bias=False, dtype=torch.float32, device=device
        )
        self.compute_dtype = compute_dtype
        self.rows = rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        if self.rows is not None:
            x, padding = halo_rows(x, 1, 1, 0.0, self.rows), (3, self.padding[1])
        return F.conv_transpose2d(
            x, self.weight.to(self.compute_dtype), None, self.stride, padding,
            self.output_padding, self.groups, self.dilation,
        )


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
        dp: DataParallel | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.fp32_logits = fp32_logits
        rows = dp.row_axis if dp is not None else None
        for i in range(num_layers):
            self.add_module(f"deconv{i + 1}", Deconv(cin if i == 0 else features, features, dtype, device, rows))
            self.add_module(f"bn{i + 1}", BN(features, bn_mode, dtype, device=device, dp=dp))
        self.final = FinalConv(features, out_channels, device)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, h, w) -> (B, H, W, C) penultimate features. With
        channels_last input the permute is a contiguous view, so the
        (B, H*W, C) matrix the fused kernel reads costs no copy."""
        for i in range(1, self.num_layers + 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"deconv{i}")(x)))
        return x.permute(0, 2, 3, 1)

    def forward(self, x, mode: str = "logits", joint_num=None, depth_dim=None):
        """mode='logits': (B, H, W, J*D) heatmap logits. mode='coords':
        (B, J, 3) voxel coords through the fused final-conv + integral op.
        Data-parallel, each rank runs it on its own rows (K1/K2 per rank,
        JAX's ``_sharded_fused``); the final conv's dW and db are summed
        over the ranks by the gradient reduction."""
        feat = self.features(x)
        kernel = self.final.weight.to(self.dtype)
        bias = self.final.bias.to(self.dtype)
        if mode == "coords":
            return fused_final_conv_integral(feat, kernel, bias, joint_num, depth_dim)
        logits = torch.matmul(feat, kernel) + bias
        return logits.to(torch.float32) if self.fp32_logits else logits
