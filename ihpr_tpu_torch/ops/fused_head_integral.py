"""Fused final 1x1 conv + integral soft-argmax, forward and backward.

The head's last op is a 1x1 conv C -> J*D followed by the volumetric
soft-argmax. Fused, the (B, H*W, J*D) logits volume never reaches device
memory, in either direction:

- K1, ``csrc/fused_head_integral_fwd.cu`` (the port of
  ``ihpr_tpu/ops/fused_head_integral.py:_fwd_kernel``), forms each logits
  tile in registers (wgmma on TMA-loaded tiles) and folds it straight into
  per-joint online softmax statistics: coords, and the per-joint max m and
  normalizer s;
- K2, ``csrc/fused_head_integral_bwd.cu`` (the port of ``_bwd_kernel``),
  recomputes the logits from m and s and contracts dv at once into dfeat,
  dW and db.

Both take bf16 heads only. fp32 heads take the no-plan route below: the
tensor cores' fp32 input is TF32, which would break ``"highest"``, and
scalar fp32 kernels were slower than cuBLAS in fp32 plus K3/K4.

``FusedHeadIntegral`` is the autograd Function around the pair.
``fused_final_conv_integral`` picks its route from the shapes alone
(``fused_supported``), before anything launches: heads K1/K2 take go
through ``FusedHeadIntegral``; any other head forms the fp32 logits volume
with a plain matmul and runs the standalone integral, K3/K4
(``integral_volume.SoftArgmaxVolume``), as JAX does when ``_pad_plan``
finds no tiling. On either route a CUDA tensor goes to the kernels, which
launch or raise; a CPU tensor goes to the plain PyTorch versions
(``plain``, ``plain_bwd``), which are also what the kernels are held
against on the card. Nothing falls back from one to the other.

Data-parallel, each rank calls this op on its own rows of the batch: K1/K2
run per rank on the local (B/W, H*W, C) features, which is the port of
JAX's ``_sharded_fused`` (``ihpr_tpu/ops/fused_head_integral.py:352``, a
shard_map over the batch rows). The op is per sample, so nothing here
changes with the world size; the final conv's dW and db are summed over the
ranks by ``DistributedDataParallel``'s gradient reduction, as the shard_map
transpose psums them in JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

from ihpr_tpu_torch.ops import _build, integral_volume
from ihpr_tpu_torch.ops.integral_volume import _acc_dtype, fold_bwd_rows

_LIB = "fused_head_integral_fwd"
_BWD_LIB = "fused_head_integral_bwd"
_MAX_DEPTH = 64  # depth bins of one joint's slab (kBox in csrc/hopper.cuh)
_MAX_CHANNELS = 256  # channels K2's register accumulators hold (kMaxC)
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper

# Launches of K1 (``launches``) and K2 (``bwd_launches``) since the count
# was last set to 0; each wrapper adds one per launch and nothing else
# touches them.
launches = 0
bwd_launches = 0


def fused_supported(channels: int, depth_dim: int, dtype: torch.dtype) -> bool:
    """Whether K1 and K2 take a head of ``channels`` features, ``depth_dim``
    bins and ``dtype``: bf16, C a multiple of 16 up to K2's 256 channels,
    D <= 64. A pure predicate on shapes, the counterpart of JAX's
    ``fused_supported`` / ``_pad_plan``; J and H*W are free. Up to 256
    channels both kernels' shared memory fits a Hopper block."""
    return (
        dtype == torch.bfloat16
        and channels % 16 == 0
        and 16 <= channels <= _MAX_CHANNELS
        and 1 <= depth_dim <= _MAX_DEPTH
    )


def plain(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. feat (B, HW, C), kernel (C, J*D), bias (J*D,)
    -> coords (B, J, 3), per-joint max m (B, J) and normalizer
    s = sum exp(v - m) (B, J), all fp32 (fp64 for fp64 inputs). Products of
    bf16 values are exact in fp32, so upcasting first equals fp32
    accumulation."""
    acc = _acc_dtype(feat)
    v = feat.to(acc) @ kernel.to(acc) + bias.to(acc)  # (B, HW, J*D)
    return integral_volume.plain(v, joint_num, depth_dim, width)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.ihpr_fused_head_integral_fwd_smem.restype = ctypes.c_size_t
    lib.ihpr_fused_head_integral_fwd_smem.argtypes = [ctypes.c_int]
    lib.ihpr_fused_head_integral_fwd.restype = ctypes.c_int
    lib.ihpr_fused_head_integral_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    return lib


def plain_bwd(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, rounded as the JAX kernel
    rounds: dv in fp32; dvc = dv in kernel's dtype feeds both contractions,
    each accumulated in fp32; dfeat (B, HW, C) in feat's dtype, dW (C, J*D)
    in kernel's dtype, db (J*D,) summed from the fp32 dv, in bias's dtype
    (fp64 throughout for fp64 inputs)."""
    b, hw, c = feat.shape
    jd = joint_num * depth_dim
    acc = _acc_dtype(feat)
    v = feat.to(acc) @ kernel.to(acc) + bias.to(acc)  # (B, HW, J*D)
    dv = integral_volume.plain_dv(v, m, s, coords, g, joint_num, depth_dim, width)
    dvc = dv.to(kernel.dtype).to(acc)
    dfeat = (dvc @ kernel.to(acc).t()).to(feat.dtype)
    dw = (feat.to(acc).reshape(b * hw, c).t() @ dvc.view(b * hw, jd)).to(kernel.dtype)
    db = dv.sum(dim=(0, 1)).to(bias.dtype)
    return dfeat, dw, db


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


def _check_cuda_tensors(feat, kernel, bias):
    """Device, dtype and layout every CUDA route requires of feat, kernel
    and bias."""
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


def _check_kernel_inputs(feat, kernel, bias, joint_num, depth_dim, width):
    """What both kernels require of feat, kernel and bias; returns
    (B, HW, C)."""
    b, hw, c = _check(feat, kernel, bias, joint_num, depth_dim, width)
    _check_cuda_tensors(feat, kernel, bias)
    if feat.dtype != torch.bfloat16:
        raise ValueError(f"K1/K2 take bfloat16 heads, not {feat.dtype} (fp32 heads take the no-plan route)")
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned")
    if c % 16:
        raise ValueError(f"C={c} must be a multiple of 16")
    if not 1 <= depth_dim <= _MAX_DEPTH:
        raise ValueError(f"depth_dim={depth_dim} must be in [1, {_MAX_DEPTH}]")
    if not (1 <= b <= 65535 and joint_num >= 1 and hw >= 1):
        raise ValueError(f"batch {b} must be in [1, 65535], J and H*W >= 1")
    return b, hw, c


def kernel_stats(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on the same contract as ``plain``. Launches on the current stream
    without synchronizing; raises on any input the kernel does not take and
    on a refused launch."""
    global launches
    b, hw, c = _check_kernel_inputs(feat, kernel, bias, joint_num, depth_dim, width)
    lib = _lib()
    smem = lib.ihpr_fused_head_integral_fwd_smem(c)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    opts = dict(dtype=torch.float32, device=feat.device)
    coords = torch.empty((b, joint_num, 3), **opts)
    m = torch.empty((b, joint_num), **opts)
    s = torch.empty((b, joint_num), **opts)
    wt = torch.empty((joint_num * depth_dim, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        err = lib.ihpr_fused_head_integral_fwd(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), wt.data_ptr(),
            coords.data_ptr(), m.data_ptr(), s.data_ptr(),
            b, hw, width, c, joint_num, depth_dim,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    launches += 1
    return coords, m, s


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_LIB)
    lib.ihpr_fused_head_integral_bwd_smem.restype = ctypes.c_size_t
    lib.ihpr_fused_head_integral_bwd_smem.argtypes = [ctypes.c_int]
    lib.ihpr_fused_head_integral_bwd_max_channels.restype = ctypes.c_int
    lib.ihpr_fused_head_integral_bwd_max_channels.argtypes = []
    lib.ihpr_fused_head_integral_bwd_partials.restype = ctypes.c_int
    lib.ihpr_fused_head_integral_bwd_partials.argtypes = [ctypes.c_int] * 3
    lib.ihpr_fused_head_integral_bwd.restype = ctypes.c_int
    lib.ihpr_fused_head_integral_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    return lib


def kernel_bwd(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on the same contract as ``plain_bwd``. Checks feat, kernel and
    bias as ``kernel_stats`` does, and m, s (B, J), coords, g (B, J, 3) as
    fp32 contiguous tensors on the same device. Launches on the current
    stream without synchronizing; raises on any input the kernel does not
    take and on a refused launch."""
    global bwd_launches
    b, hw, c = _check_kernel_inputs(feat, kernel, bias, joint_num, depth_dim, width)
    for name, t, shape in (("m", m, (b, joint_num)), ("s", s, (b, joint_num)),
                           ("coords", coords, (b, joint_num, 3)), ("g", g, (b, joint_num, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}{tuple(t.shape)}: need float32{shape}")
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feat.device}")
    lib = _bwd_lib()
    max_c = lib.ihpr_fused_head_integral_bwd_max_channels()
    if c > max_c:
        raise ValueError(f"C={c} is more than the backward's {max_c} channels")
    smem = lib.ihpr_fused_head_integral_bwd_smem(c)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    jd = joint_num * depth_dim
    rows = fold_bwd_rows(m, s, coords, g)
    f32 = dict(dtype=torch.float32, device=feat.device)
    wt = torch.empty((jd, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        parts = lib.ihpr_fused_head_integral_bwd_partials(b, hw, joint_num)
        part = torch.empty((parts, joint_num, c, _MAX_DEPTH), **f32)
        dbpart = torch.empty((parts, joint_num, _MAX_DEPTH), **f32)
        dfeat = torch.empty_like(feat)
        dw = torch.empty_like(kernel)
        db = torch.empty_like(bias)
        err = lib.ihpr_fused_head_integral_bwd(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), rows.data_ptr(),
            wt.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
            dfeat.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, hw, width, c, joint_num, depth_dim, parts,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_BWD_LIB} launch failed: CUDA error {err}")
    bwd_launches += 1
    return dfeat, dw, db


class FusedHeadIntegral(torch.autograd.Function):
    """coords = fused final conv + integral of (feat, kernel, bias): K1
    forward and K2 backward on CUDA tensors, ``plain`` and ``plain_bwd`` on
    CPU tensors. Saves feat, kernel, bias, m, s and coords for the backward;
    nothing when no input needs a gradient or ``grad_enabled`` (the caller's
    ``torch.is_grad_enabled()``: the forward itself runs with grad off) is
    False, as under ``no_grad`` and ``inference_mode``."""

    @staticmethod
    def forward(ctx, feat, kernel, bias, joint_num: int, depth_dim: int, width: int,
                grad_enabled: bool):
        run = kernel_stats if feat.is_cuda else plain
        coords, m, s = run(feat, kernel, bias, joint_num, depth_dim, width)
        if grad_enabled and any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(feat, kernel, bias, m, s, coords)
            ctx.dims = (joint_num, depth_dim, width)
        return coords

    @staticmethod
    def backward(ctx, g):
        feat, kernel, bias, m, s, coords = ctx.saved_tensors
        run = kernel_bwd if feat.is_cuda else plain_bwd
        grads = run(feat, kernel, bias, m, s, coords, g.to(m.dtype).contiguous(), *ctx.dims)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN convs while the block runs, restored
    after, so the setting does not leak into the rest of the process."""
    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda_mm.allow_tf32, cudnn.allow_tf32
    cuda_mm.allow_tf32, cudnn.allow_tf32 = False, False
    try:
        yield
    finally:
        cuda_mm.allow_tf32, cudnn.allow_tf32 = prev


class _Logits(torch.autograd.Function):
    """v = feat @ kernel + bias (B, HW, J*D), accumulated in fp32 (fp64 for
    fp64 inputs) from the operands as given, TF32 off in both directions:
    the no-plan route's final conv, which JAX computes outside any kernel as
    ``jnp.dot(..., preferred_element_type=float32)``. bf16 products are
    exact in fp32, so upcasting first equals fp32 accumulation. Gradients
    come back in each operand's dtype."""

    @staticmethod
    def forward(ctx, feat, kernel, bias):
        acc = _acc_dtype(feat)
        with no_tf32():
            v = feat.to(acc) @ kernel.to(acc) + bias.to(acc)
        ctx.save_for_backward(feat, kernel)
        ctx.bias_dtype = bias.dtype
        return v

    @staticmethod
    def backward(ctx, dv):
        feat, kernel = ctx.saved_tensors
        b, hw, c = feat.shape
        need = ctx.needs_input_grad
        dfeat = dw = db = None
        with no_tf32():
            if need[0]:
                dfeat = (dv @ kernel.to(dv.dtype).t()).to(feat.dtype)
            if need[1]:
                dw = (feat.to(dv.dtype).reshape(b * hw, c).t() @ dv.reshape(b * hw, -1)).to(kernel.dtype)
        if need[2]:
            db = dv.sum(dim=(0, 1)).to(ctx.bias_dtype)
        return dfeat, dw, db


def fused_final_conv_integral(
    features: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    joint_num: int,
    depth_dim: int,
) -> torch.Tensor:
    """(B, H, W, C) head features + (C, J*D) final-conv weight + (J*D,) bias
    -> (B, J, 3) voxel coords (x, y, z), fp32, differentiable in all three
    tensors. Heads ``fused_supported`` admits (bf16) run
    ``FusedHeadIntegral`` (K1/K2 on CUDA tensors); any other head, fp32
    included, forms the fp32 logits (``_Logits``) and runs
    ``integral_volume.SoftArgmaxVolume`` (K3/K4 on CUDA tensors). CPU
    tensors take the same route through the plain versions."""
    b, h, w, c = features.shape
    if features.is_cuda:
        if not features.is_contiguous():
            raise ValueError("features must be contiguous (B, H, W, C) on the kernel path")
        _check_cuda_tensors(features, kernel, bias)
        feat = features.view(b, h * w, c)
    elif features.device.type == "cpu":
        feat = features.reshape(b, h * w, c)
    else:
        raise ValueError(f"no fused head integral for device {features.device}")
    _check(feat, kernel, bias, joint_num, depth_dim, w)
    if fused_supported(c, depth_dim, features.dtype):
        return FusedHeadIntegral.apply(
            feat, kernel, bias, joint_num, depth_dim, w, torch.is_grad_enabled()
        )
    return integral_volume.soft_argmax_volume(
        _Logits.apply(feat, kernel, bias), joint_num, depth_dim, w
    )
