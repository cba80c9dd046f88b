"""The lower-precision control: the reference's products computed in fp8.

The configurations state bfloat16 for the tensors the network computes on,
so the control steps one below: each tensor that the reference rounds where
the program holds bfloat16 (``pose_net.PoseNetRef``'s ``quant``) is
rounded to float8 e4m3 with one scale per tensor (its largest magnitude
mapped to e4m3's largest finite value), and, in the backward, the gradient
reaching it to float8 e5m2 the same way. BatchNorm's statistics, the
softmax, the loss and the optimizer stay in float32, as in the program.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = largest / amax
    return ((x.to(torch.float32) * scale).to(dtype).to(torch.float32) / scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale; its gradient to e5m2."""
    return _FP8.apply(x)
