"""ResNet backbone (torchvision v1.5: the stride sits on the Bottleneck's
3x3 conv), counterpart of ``ihpr_tpu.models.resnet``.

Tensors are NCHW in ``channels_last`` memory format. Every parameter is an
fp32 master, as in the JAX package (``param_dtype=float32``); each conv
casts its weight to the compute dtype per call (autograd returns the fp32
gradient through the cast). BatchNorm parameters and running statistics
are fp32 and BatchNorm follows ``nn.Module.train()``/``eval()``. Module
names follow the JAX parameter tree (``layer{stage}_{i}.conv1``,
``down_bn``, ...), so ``models.convert`` maps one onto the other by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# resnet_type -> (block kind, stage depths, channel expansion)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
    152: ("bottleneck", (3, 8, 36, 3), 4),
}

_STAGE_WIDTHS = (64, 128, 256, 512)

BN_MODES = ("flax", "lean")


class BN(nn.Module):
    """BatchNorm in one of two arithmetics:

    - ``"flax"``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
      then cast to ``dtype`` (flax ``nn.BatchNorm``);
    - ``"lean"``: ``mul = scale * rsqrt(var + eps)`` and
      ``add = bias - mean * scale * rsqrt(var + eps)`` computed in fp32, both
      cast to ``dtype``, then ``x * mul + add`` in ``dtype`` (``_LeanBN``).

    In train mode both normalize with the batch statistics, taken in fp32
    over (N, H, W) as ``mean = E[x]`` and the biased ``var = max(E[x^2] -
    mean^2, 0)``, with gradients through both, and update the running
    statistics as ``momentum * old + (1 - momentum) * batch`` (flax momentum
    0.9; the running variance gets the biased variance too). In eval mode
    they normalize with the running statistics.
    """

    momentum = 0.9  # flax momentum: the share of the old running statistic

    def __init__(self, channels: int, mode: str, dtype: torch.dtype, eps: float = 1e-5, device=None):
        super().__init__()
        if mode not in BN_MODES:
            raise ValueError(f"bn_mode {mode!r} is not ported; use one of {BN_MODES}")
        self.mode = mode
        self.dtype = dtype
        self.eps = eps
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def _batch_stats(self, x: torch.Tensor):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        rstd = torch.rsqrt(var + self.eps)
        if self.mode == "lean":
            mul = (self.weight * rstd).to(self.dtype)
            add = (self.bias - mean * self.weight * rstd).to(self.dtype)
            # One rounding of x*mul + add, as XLA's fused multiply-add gives.
            return torch.addcmul(add[:, None, None], x.to(self.dtype), mul[:, None, None])
        mul = rstd * self.weight
        y = (x.to(torch.float32) - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class Conv(nn.Conv2d):
    """Bias-free conv with an fp32 master weight, cast to ``compute_dtype``
    on each call (a no-op once the weight is stored in that dtype, as in
    ``pose_net.inference_copy``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, compute_dtype, device=None):
        super().__init__(
            cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
            dtype=torch.float32, device=device,
        )
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(self.compute_dtype), None)


def _conv(cin: int, cout: int, kernel: int, stride: int, dtype, device) -> Conv:
    return Conv(cin, cout, kernel, stride, dtype, device)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, dtype, bn_mode: str, device=None):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, dtype, device)
        self.bn1 = BN(features, bn_mode, dtype, device=device)
        self.conv2 = _conv(features, features, 3, 1, dtype, device)
        self.bn2 = BN(features, bn_mode, dtype, device=device)
        if stride != 1 or cin != features:
            self.down_conv = _conv(cin, features, 1, stride, dtype, device)
            self.down_bn = BN(features, bn_mode, dtype, device=device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, dtype, bn_mode: str, device=None):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1, 1, dtype, device)
        self.bn1 = BN(features, bn_mode, dtype, device=device)
        self.conv2 = _conv(features, features, 3, stride, dtype, device)
        self.bn2 = BN(features, bn_mode, dtype, device=device)
        self.conv3 = _conv(features, out, 1, 1, dtype, device)
        self.bn3 = BN(out, bn_mode, dtype, device=device)
        if stride != 1 or cin != out:
            self.down_conv = _conv(cin, out, 1, stride, dtype, device)
            self.down_bn = BN(out, bn_mode, dtype, device=device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + residual)


class ResNetBackbone(nn.Module):
    """(B, 3, H, W) image -> (B, C, H/32, W/32) features, C = 512 for
    ResNet-18/34 and 2048 for 50/101/152."""

    def __init__(self, resnet_type: int, dtype: torch.dtype, bn_mode: str, device=None):
        super().__init__()
        if resnet_type not in RESNET_SPECS:
            raise ValueError(f"resnet_type {resnet_type} not in {sorted(RESNET_SPECS)}")
        kind, depths, expansion = RESNET_SPECS[resnet_type]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.dtype = dtype
        self.out_features = 512 * expansion
        self.conv1 = Conv(3, 64, 7, 2, dtype, device)
        self.bn1 = BN(64, bn_mode, dtype, device=device)
        self.block_names = []
        cin = 64
        for stage, (width, depth) in enumerate(zip(_STAGE_WIDTHS, depths)):
            for i in range(depth):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(cin, width, stride, dtype, bn_mode, device))
                self.block_names.append(name)
                cin = width * expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
