"""Plain float32 reference of the pose network: a ResNet v1.5 backbone (the
stride on each Bottleneck's 3x3 conv), three 4x4 stride-2 deconvolutions
with BatchNorm and ReLU, a final 1x1 conv to J*D channels and the integral
soft-argmax over each joint's (D, H, W) volume (Sun et al., "Integral Human
Pose Regression", ECCV 2018, eq. 3-4).

Written from the published equations with ``torch.nn.functional`` alone.
It imports nothing of the program under test and takes only the state
dictionary the benchmark drew (names and layouts as ``param_specs`` lists
them) and the inputs the benchmark made. BatchNorm takes its batch
statistics in two passes, ``var = E[(x - mean)^2]``, and normalizes as
``x * scale + shift`` with ``scale = weight / sqrt(var + eps)`` and ``shift
= bias - mean * scale`` (the configurations' lean BatchNorm; in float32 the
same as ``(x - mean) * scale + bias``). ``quant`` is applied where the
program holds a tensor in its compute dtype: both operands of every
convolution and matrix product, each convolution's output, BatchNorm's
input, ``scale``, ``shift`` and output, and each residual sum; the
benchmark's lower-precision control passes a rounding there
(``precision.fp8``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGE_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def blocks(resnet_type: int) -> List[Tuple[str, int, int, int, bool]]:
    """(name, cin, width, stride, has_down) of every Bottleneck in order."""
    if resnet_type not in STAGE_DEPTHS:
        raise ValueError(f"the reference has Bottleneck ResNets {sorted(STAGE_DEPTHS)}, not {resnet_type}")
    out, cin = [], 64
    for stage, (width, depth) in enumerate(zip(STAGE_WIDTHS, STAGE_DEPTHS[resnet_type])):
        for i in range(depth):
            stride = 2 if stage > 0 and i == 0 else 1
            out.append((f"layer{stage + 1}_{i}", cin, width, stride, stride != 1 or cin != width * EXPANSION))
            cin = width * EXPANSION
    return out


def param_specs(sizes: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the state dictionary, kind one of
    conv, deconv, final_w, final_b, bn_w, bn_b, bn_mean, bn_var."""
    specs = []

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
                      (f"{name}.running_mean", (c,), "bn_mean"), (f"{name}.running_var", (c,), "bn_var")])

    specs.append(("backbone.conv1.weight", (64, 3, 7, 7), "conv"))
    bn("backbone.bn1", 64)
    for name, cin, width, _, down in blocks(sizes["resnet_type"]):
        p = f"backbone.{name}"
        out = width * EXPANSION
        specs.append((f"{p}.conv1.weight", (width, cin, 1, 1), "conv"))
        bn(f"{p}.bn1", width)
        specs.append((f"{p}.conv2.weight", (width, width, 3, 3), "conv"))
        bn(f"{p}.bn2", width)
        specs.append((f"{p}.conv3.weight", (out, width, 1, 1), "conv"))
        bn(f"{p}.bn3", out)
        if down:
            specs.append((f"{p}.down_conv.weight", (out, cin, 1, 1), "conv"))
            bn(f"{p}.down_bn", out)
    cin = STAGE_WIDTHS[-1] * EXPANSION
    feats = sizes["deconv_channels"]
    for i in range(1, sizes["num_deconv_layers"] + 1):
        specs.append((f"head.deconv{i}.weight", (cin if i == 1 else feats, feats, 4, 4), "deconv"))
        bn(f"head.bn{i}", feats)
    jd = sizes["joint_num"] * sizes["depth_dim"]
    specs.append(("head.final.weight", (feats, jd), "final_w"))
    specs.append(("head.final.bias", (jd,), "final_b"))
    return specs


class PoseNetRef:
    """The network as functions of a state dictionary ``p`` (float32 tensors).
    ``train``: BatchNorm normalizes with the batch statistics; else with
    ``running_mean`` / ``running_var``. ``record``, where given, receives each
    BatchNorm's batch (mean, var) by name."""

    def __init__(self, sizes: Dict, quant: Optional[Callable] = None):
        self.sizes = sizes
        self.q = quant or _identity
        self.eps = sizes["bn_epsilon"]

    def _conv(self, x, w, stride=1, pad=0):
        return self.q(F.conv2d(self.q(x), self.q(w), None, stride, pad))

    def _bn(self, x, p, name, train, record):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            if record is not None:
                record[name] = (mean.detach(), var.detach())
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = p[f"{name}.weight"] * torch.rsqrt(var + self.eps)
        shift = p[f"{name}.bias"] - mean * scale
        return self.q(self.q(x) * self.q(scale)[None, :, None, None] + self.q(shift)[None, :, None, None])

    def features(self, p, image: torch.Tensor, train: bool, record=None) -> torch.Tensor:
        """(B, H, W, 3) normalized image -> (B, H/4, W/4, C) head features."""
        x = image.permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, p["backbone.conv1.weight"], 2, 3), p, "backbone.bn1", train, record))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, _, _, stride, down in blocks(self.sizes["resnet_type"]):
            b = f"backbone.{name}"
            y = F.relu(self._bn(self._conv(x, p[f"{b}.conv1.weight"]), p, f"{b}.bn1", train, record))
            y = F.relu(self._bn(self._conv(y, p[f"{b}.conv2.weight"], stride, 1), p, f"{b}.bn2", train, record))
            y = self._bn(self._conv(y, p[f"{b}.conv3.weight"]), p, f"{b}.bn3", train, record)
            if down:
                x = self._bn(self._conv(x, p[f"{b}.down_conv.weight"], stride), p, f"{b}.down_bn", train, record)
            x = F.relu(self.q(y + x))
        for i in range(1, self.sizes["num_deconv_layers"] + 1):
            x = self.q(F.conv_transpose2d(self.q(x), self.q(p[f"head.deconv{i}.weight"]), None, 2, 1))
            x = F.relu(self._bn(x, p, f"head.bn{i}", train, record))
        return x.permute(0, 2, 3, 1)

    def coords(self, p, image: torch.Tensor, train: bool, record=None) -> torch.Tensor:
        """(B, H, W, 3) normalized image -> (B, J, 3) voxel coords (x, y, z)."""
        feat = self.features(p, image, train, record)
        logits = self.q(feat) @ self.q(p["head.final.weight"]) + p["head.final.bias"]
        return soft_argmax(logits, self.sizes["joint_num"], self.sizes["depth_dim"])


def soft_argmax(logits: torch.Tensor, joints: int, depth: int) -> torch.Tensor:
    """(B, H, W, J*D) logits, channel j*D + z -> (B, J, 3) expected (x, y, z)
    under the softmax over each joint's D*H*W voxels."""
    b, h, w, _ = logits.shape
    vol = logits.reshape(b, h, w, joints, depth).permute(0, 3, 4, 1, 2).reshape(b, joints, -1)
    prob = torch.softmax(vol, dim=-1).reshape(b, joints, depth, h, w)

    def expect(marginal):
        return (marginal * torch.arange(marginal.shape[-1], dtype=marginal.dtype, device=marginal.device)).sum(-1)

    return torch.stack([expect(prob.sum(dim=(2, 3))), expect(prob.sum(dim=(2, 4))), expect(prob.sum(dim=(3, 4)))], -1)


def normalize(patch_u8: torch.Tensor, color_scale: torch.Tensor, sizes: Dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 patch and (B, 3) colour scale -> the network's input:
    colour scale, clip to [0, 255], ImageNet mean and deviation."""
    mean = torch.tensor(sizes["pixel_mean"], dtype=torch.float32, device=patch_u8.device) * 255.0
    std = torch.tensor(sizes["pixel_std"], dtype=torch.float32, device=patch_u8.device) * 255.0
    img = (patch_u8.to(torch.float32) * color_scale[:, None, None, :]).clamp(0.0, 255.0)
    return (img - mean) / std


def masked_l1(coords, joint_img, joint_vis, have_depth) -> torch.Tensor:
    """Mean over B*J*3 of |coords - joint_img|, each joint weighted by its
    visibility and z also by whether the sample has depth (2D samples
    supervise x and y only)."""
    err = (coords - joint_img).abs() * joint_vis[:, :, None]
    mask = torch.ones_like(err)
    mask[..., 2] = have_depth[:, None]
    return (err * mask).mean()
