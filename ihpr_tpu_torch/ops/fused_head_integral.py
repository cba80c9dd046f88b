"""Fused final 1x1 conv + integral soft-argmax, forward.

The head's last op is a 1x1 conv C -> J*D followed by the volumetric
soft-argmax. Fused, the (B, H*W, J*D) logits volume never reaches device
memory: the CUDA kernel ``csrc/fused_head_integral_fwd.cu`` (the port of
``ihpr_tpu/ops/fused_head_integral.py:_fwd_kernel``; its header says how)
forms each logits tile in registers and folds it straight into per-joint
online softmax statistics.

Routing: a CUDA tensor goes to the kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version in this module, which is also
what the kernel is held against on the card. Nothing falls back from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ihpr_tpu_torch.ops import _build

_LIB = "fused_head_integral_fwd"
_MAX_DEPTH = 64  # depth bins one CTA holds (kCols in the kernel)
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper

# Kernel launches since the count was last set to 0; the wrapper adds one
# per launch and nothing else touches it.
launches = 0


def plain(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. feat (B, HW, C), kernel (C, J*D), bias (J*D,)
    -> coords (B, J, 3), per-joint max m (B, J) and normalizer
    s = sum exp(v - m) (B, J), all fp32. Products of bf16 values are exact
    in fp32, so upcasting first equals fp32 accumulation."""
    b, hw, _ = feat.shape
    v = feat.float() @ kernel.float() + bias.float()  # (B, HW, J*D)
    v = v.reshape(b, hw, joint_num, depth_dim).permute(0, 2, 1, 3)  # (B, J, HW, D)
    m = v.amax(dim=(2, 3))
    e = torch.exp(v - m[..., None, None])
    s = e.sum(dim=(2, 3))
    p = e / s[..., None, None]
    rows = torch.arange(hw, device=feat.device)
    x = (rows % width).float()
    y = torch.div(rows, width, rounding_mode="floor").float()
    z = torch.arange(depth_dim, device=feat.device, dtype=torch.float32)
    p_rows = p.sum(-1)  # (B, J, HW)
    coords = torch.stack(
        [(p_rows * x).sum(-1), (p_rows * y).sum(-1), (p.sum(2) * z).sum(-1)], dim=-1
    )
    return coords, m, s


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.ihpr_fused_head_integral_fwd_smem.restype = ctypes.c_size_t
    lib.ihpr_fused_head_integral_fwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ihpr_fused_head_integral_fwd.restype = ctypes.c_int
    lib.ihpr_fused_head_integral_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    return lib


def _check(feat, kernel, bias, joint_num, depth_dim, width):
    b, hw, c = feat.shape
    jd = joint_num * depth_dim
    if kernel.shape != (c, jd) or bias.shape != (jd,):
        raise ValueError(
            f"kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} do not match "
            f"C={c}, J*D={joint_num}*{depth_dim}"
        )
    if width <= 0 or hw % width:
        raise ValueError(f"width {width} does not divide H*W={hw}")
    return b, hw, c


def kernel_stats(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel on the same contract as ``plain``. Launches on the
    current stream without synchronizing; raises on any input the kernel
    does not take and on a refused launch."""
    global launches
    b, hw, c = _check(feat, kernel, bias, joint_num, depth_dim, width)
    tensors = (feat, kernel, bias)
    if not all(t.is_cuda and t.device == feat.device for t in tensors):
        raise ValueError("feat, kernel and bias must be CUDA tensors on one device")
    if feat.dtype not in (torch.bfloat16, torch.float32) or any(
        t.dtype != feat.dtype for t in tensors
    ):
        raise ValueError(
            f"dtypes {[t.dtype for t in tensors]}: need all bfloat16 or all float32"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("feat, kernel and bias must be contiguous")
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned")
    if c % 16:
        raise ValueError(f"C={c} must be a multiple of 16")
    if not 1 <= depth_dim <= _MAX_DEPTH:
        raise ValueError(f"depth_dim={depth_dim} must be in [1, {_MAX_DEPTH}]")
    if not (1 <= b <= 65535 and joint_num >= 1 and hw >= 1):
        raise ValueError(f"batch {b} must be in [1, 65535], J and H*W >= 1")
    lib = _lib()
    is_bf16 = int(feat.dtype == torch.bfloat16)
    smem = lib.ihpr_fused_head_integral_fwd_smem(c, is_bf16)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    opts = dict(dtype=torch.float32, device=feat.device)
    coords = torch.empty((b, joint_num, 3), **opts)
    m = torch.empty((b, joint_num), **opts)
    s = torch.empty((b, joint_num), **opts)
    with torch.cuda.device(feat.device):
        err = lib.ihpr_fused_head_integral_fwd(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            coords.data_ptr(), m.data_ptr(), s.data_ptr(),
            b, hw, width, c, joint_num, depth_dim, is_bf16,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    launches += 1
    return coords, m, s


def fused_final_conv_integral(
    features: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    joint_num: int,
    depth_dim: int,
) -> torch.Tensor:
    """(B, H, W, C) head features + (C, J*D) final-conv weight + (J*D,) bias
    -> (B, J, 3) voxel coords (x, y, z), fp32. CUDA tensors run the kernel;
    CPU tensors run ``plain``."""
    b, h, w, c = features.shape
    if features.is_cuda:
        if not features.is_contiguous():
            raise ValueError("features must be contiguous (B, H, W, C) on the kernel path")
        return kernel_stats(features.view(b, h * w, c), kernel, bias, joint_num, depth_dim, w)[0]
    if features.device.type != "cpu":
        raise ValueError(f"no fused head integral for device {features.device}")
    feat = features.reshape(b, h * w, c)
    _check(feat, kernel, bias, joint_num, depth_dim, w)
    return plain(feat, kernel, bias, joint_num, depth_dim, w)[0]
