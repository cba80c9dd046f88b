"""Deconvolution head: stride-32 features -> stride-4 heatmap volumes,
counterpart of ``ihpr_tpu.models.head.DeconvHead``.

3 x [ConvTranspose2d(4, stride 2, padding 1) + BN + ReLU], then a final
1x1 conv C -> J*D. Every weight is an fp32 master, as in the JAX head; the
deconvs cast theirs to the compute dtype per call, and the final conv's
(C, J*D) weight and (J*D,) bias are cast to the compute dtype before the
fused op or the plain logits matmul (``head.py:143-148``), so autograd
returns fp32 gradients through the casts.

Row-sharded (``dp`` of spatial > 1), each deconv takes the input rows its
output rows (``mesh.row_range`` of the 2R output rows) receive taps from
(``mesh.halo_rows`` with ``mesh.deconv_needs``, zeros past the image's
edges) and crops the rest: on rows split evenly, one row of each neighbour
and padding 3 in H. A rank with no output rows runs no cuDNN call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ihpr_tpu_torch.models.resnet import BN, _no_rows
from ihpr_tpu_torch.ops.fused_head_integral import fused_final_conv_integral
from ihpr_tpu_torch.parallel.mesh import DataParallel, deconv_needs, halo_rows, row_range


class FinalConv(nn.Module):
    """1x1 conv as an fp32 (C, J*D) weight matrix and an fp32 (J*D,) bias."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32, device=device))


class Deconv(nn.ConvTranspose2d):
    """ConvTranspose2d(4, stride 2, padding 1), bias-free, with an fp32
    master weight cast to ``compute_dtype`` on each call. ``rows``
    (``DataParallel.row_axis``): the input is this rank's rows of a stage
    of ``rows_in`` rows (default: the grid's ``input_rows``). Output rows
    [a, b) take input rows [i0, i1) = [(a - 1) // 2, b // 2 + 1); with
    padding 0 in H those give output rows 2*i0 - 1 ... 2*i1 of the whole,
    so the first a - 2*i0 + 1 and the last (2 or 3) rows past b are
    cropped: by padding where both ends crop alike (3 and 3 on rows split
    evenly), else by padding the lesser and slicing the rest."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype, device=None,
                 rows: DataParallel | None = None, rows_in: int | None = None):
        super().__init__(
            cin, cout, 4, stride=2, padding=1, bias=False, dtype=torch.float32, device=device
        )
        self.compute_dtype = compute_dtype
        self.rows = rows
        self.rows_in = None if rows is None else (rows_in if rows_in is not None else rows.input_rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.compute_dtype)
        padding = self.padding
        top = crop = 0
        if self.rows is not None:
            needs = deconv_needs(self.rows_in, self.rows.world)
            a, b = row_range(2 * self.rows_in, self.rows.rank, self.rows.world)
            x = halo_rows(x, self.rows_in, needs, 0.0, self.rows)
            if b == a:
                return _no_rows((x.shape[0], self.out_channels, 0, 2 * x.shape[3]), x, w)
            i0, i1 = needs[self.rows.rank]
            top = a - 2 * i0 + 1
            bottom = 2 * (i1 - i0) + 2 - top - (b - a)
            crop = min(top, bottom)
            padding, top = (crop, self.padding[1]), top - crop
        y = F.conv_transpose2d(x, w, None, self.stride, padding, self.output_padding, self.groups, self.dilation)
        if self.rows is not None and (top or y.shape[2] != b - a):
            y = y[:, :, top:top + b - a]
        return y


class SubpixelConvTranspose(Deconv):
    """JAX's ``SubpixelConvTranspose`` (ihpr_tpu/models/head.py:27): the
    4x4 stride-2 deconv as four 2x2 phase convs and a pixel shuffle, a
    drop-in for ``Deconv`` with the same weight (torch's (in, out, 4, 4)
    layout). Output pixel (2i + py, 2j + px) correlates the input padded
    by 1 with the phase kernel ``w.flip(2, 3)[:, :, py::2, px::2]``: torch's
    transposed conv correlates with the taps that flax's convolves with
    (``models/convert.py``), so the phases are flax's strided slices of
    the flipped weight. Equal to ``Deconv`` up to the convs' summation
    order. Whole images only (no ``rows``); ``DeconvHead`` keeps
    ``Deconv``, as JAX's head keeps ``nn.ConvTranspose``."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype, device=None):
        super().__init__(cin, cout, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        f = self.out_channels
        k = self.weight.to(self.compute_dtype).flip(2, 3)
        phases = torch.cat([k[:, :, py::2, px::2] for py in (0, 1) for px in (0, 1)], dim=1)  # (in, 4F, 2, 2)
        y = F.conv2d(F.pad(x.to(self.compute_dtype), (1, 1, 1, 1)), phases.transpose(0, 1))  # (B, 4F, h+1, w+1)
        ee, eo = y[:, 0:f, 0:h, 0:w], y[:, f:2 * f, 0:h, 1:w + 1]
        oe, oo = y[:, 2 * f:3 * f, 1:h + 1, 0:w], y[:, 3 * f:, 1:h + 1, 1:w + 1]
        out = torch.stack([torch.stack([ee, eo], -1), torch.stack([oe, oo], -1)], 3)  # (B, F, h, 2, w, 2)
        return out.reshape(b, f, 2 * h, 2 * w).contiguous(memory_format=torch.channels_last)


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
        rows_in: int | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.fp32_logits = fp32_logits
        rows = dp.row_axis if dp is not None else None
        # The global rows of the heatmap on a spatial grid (None: whole images).
        self.rows_out = None if rows_in is None else rows_in * 2 ** num_layers
        for i in range(num_layers):
            r = None if rows_in is None else rows_in * 2 ** i
            self.add_module(f"deconv{i + 1}", Deconv(cin if i == 0 else features, features, dtype, device, rows, r))
            self.add_module(f"bn{i + 1}", BN(features, bn_mode, dtype, device=device, dp=dp,
                                             rows=None if r is None else 2 * r))
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
