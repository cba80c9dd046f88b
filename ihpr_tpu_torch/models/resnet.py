"""ResNet backbone (torchvision v1.5: the stride sits on the Bottleneck's
3x3 conv), eval only, counterpart of ``ihpr_tpu.models.resnet``.

Tensors are NCHW in ``channels_last`` memory format. Conv weights are held
in the compute dtype (one rounding of the fp32 master, as the JAX package
casts its fp32 params per call); BatchNorm parameters and running
statistics stay fp32. Module names follow the JAX parameter tree
(``layer{stage}_{i}.conv1``, ``down_bn``, ...), so ``models.convert`` maps
one onto the other by name.
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
    """Eval-mode BatchNorm on running statistics, in one of two arithmetics:

    - ``"flax"``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
      then cast to ``dtype`` (flax ``nn.BatchNorm``);
    - ``"lean"``: ``mul = scale * rsqrt(var + eps)`` and
      ``add = bias - mean * scale * rsqrt(var + eps)`` computed in fp32, both
      cast to ``dtype``, then ``x * mul + add`` in ``dtype`` (``_LeanBN``).
    """

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rstd = torch.rsqrt(self.running_var + self.eps)
        if self.mode == "lean":
            mul = (self.weight * rstd).to(self.dtype)
            add = (self.bias - self.running_mean * self.weight * rstd).to(self.dtype)
            # One rounding of x*mul + add, as XLA's fused multiply-add gives.
            return torch.addcmul(add[:, None, None], x.to(self.dtype), mul[:, None, None])
        mul = rstd * self.weight
        y = (x.to(torch.float32) - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


def _conv(cin: int, cout: int, kernel: int, stride: int, dtype, device) -> nn.Conv2d:
    return nn.Conv2d(
        cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
        dtype=dtype, device=device,
    )


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
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype, device=device)
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
