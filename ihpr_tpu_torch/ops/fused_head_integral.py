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

Both take bf16 heads. fp32 heads have their own pair, K1-fp32 and K2-fp32
(``csrc/fused_head_integral_fwd_f32.cu``, ``_bwd_f32.cu``): the same
functions with every product in 3xTF32 on wgmma (``csrc/fused_head_f32.cuh``),
~2^-21 relative per product, which keeps JAX's fp32 ``Precision.HIGHEST``.
Each first splits the weight into TF32 hi and lo planes (``split_planes``
is that pre-pass's plain version). ``kernel_stats`` and ``kernel_bwd`` pick
the pair by dtype.

``FusedHeadIntegral`` is the autograd Function around either pair.
``fused_final_conv_integral`` picks its route from the shapes and dtype
alone (``fused_supported``), before anything launches. bf16 heads within
K1/K2's limits go through ``FusedHeadIntegral``; fp32 heads do so exactly
where JAX runs its fused kernel in fp32 (``jax_plan``, the copy of JAX's
``_pad_plan``: ``h36m3d_r50_fp32``, ``parity_r50``, the accuracy harness's
``tiny``). Any other head (the D = 1 heads of ``mpii2d_r50`` and
``coco2d_r50``, C = 72, D = 80, float64) forms the fp32 logits volume with
a plain matmul and runs the standalone integral, K3/K4
(``integral_volume.SoftArgmaxVolume``), as JAX does when ``_pad_plan``
finds no tiling. On either route a CUDA tensor goes to the kernels, which
launch or raise; a CPU tensor goes to the plain PyTorch versions
(``plain``, ``plain_bwd``), which are also what the kernels are held
against on the card. Nothing falls back from one to the other.

Two measurement modes of JAX's kernels, read from the environment at each
call (JAX reads them when it traces): ``IHPR_EXP2=1`` pre-scales W and b
by log2 e (``base2_scale``: an fp32 multiply, one rounding to the compute
dtype), so that the kernels' logits are base 2 and take ``ex2`` with no
multiply of their own, m is a base-2 max, the backward's rows carry
log2 s and ln 2, and dW, db are scaled back by log2 e before their one
rounding; ``IHPR_BEXP=1`` rounds the backward's exp argument and its
result to bf16. ``plain`` and ``plain_bwd`` take both modes; the kernels
take them as an argument.

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
import os
from typing import Tuple

import torch

from ihpr_tpu_torch.ops import _build, integral_volume
from ihpr_tpu_torch.ops.integral_volume import _acc_dtype, fold_bwd_rows

_LIB = "fused_head_integral_fwd"
_BWD_LIB = "fused_head_integral_bwd"
_F32_LIB = "fused_head_integral_fwd_f32"
_F32_BWD_LIB = "fused_head_integral_bwd_f32"
_MAX_DEPTH = 64  # depth bins of one joint's slab (kBox in csrc/hopper.cuh, kBins in the fp32 kernels)
_MAX_CHANNELS = 256  # channels K2's register accumulators hold (kMaxC)
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
# Channel multiple each dtype's kernels take: bf16 wgmma k-steps of 16;
# the fp32 kernels' 32-channel ring stages.
_C_MULTIPLE = {torch.bfloat16: 16, torch.float32: 32}

# Launches of K1 (``launches``), K2 (``bwd_launches``), K1-fp32
# (``f32_launches``) and K2-fp32 (``f32_bwd_launches``) since the count was
# last set to 0; each wrapper adds one per launch of its kernel and nothing
# else touches them.
launches = 0
bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

_LOG2E = 1.4426950408889634  # log2(e)
_LN2 = 0.6931471805599453  # 1 / log2(e)
# The kernels' mode argument: bit 0 IHPR_EXP2, bit 1 IHPR_BEXP.
_MODE_EXP2, _MODE_BEXP = 1, 2


def exp_modes() -> Tuple[bool, bool]:
    """(``IHPR_EXP2``, ``IHPR_BEXP``) as the environment sets them now: each
    on when its variable is "1", as JAX's ``_use_exp2`` / ``_use_bexp``."""
    return os.environ.get("IHPR_EXP2", "0") == "1", os.environ.get("IHPR_BEXP", "0") == "1"


def base2_scale(kernel: torch.Tensor, bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_base2_scale``: W and b times log2 e, multiplied in fp32 and
    rounded once to their dtype, so the logits come out in base 2."""
    acc = _acc_dtype(kernel)
    return ((kernel.to(acc) * _LOG2E).to(kernel.dtype).contiguous(),
            (bias.to(acc) * _LOG2E).to(bias.dtype).contiguous())


# JAX's fused-kernel plan, copied as plain Python on ints (the port imports
# nothing of the JAX package): ``_chunk_rows``, ``_supported`` and
# ``_padded_joint_num`` of ihpr_tpu/ops/integral_pallas.py, and
# ``fused_supported`` and ``_pad_plan`` of ihpr_tpu/ops/fused_head_integral.py,
# at JAX's default 2 MiB chunk budget.
_PLAN_CHUNK_BYTES = 2 * 1024 * 1024
_PLAN_LANES = 128


def _chunk_rows(hw: int, lanes: int) -> int | None:
    cap = max(8, _PLAN_CHUNK_BYTES // (lanes * 4))
    if hw <= cap:
        return hw
    for c in range(cap, 7, -1):
        if hw % c == 0 and c % 8 == 0:
            return c
    return None


def _lanes_supported(joint_num: int, depth_dim: int, hw: int) -> bool:
    return (
        (joint_num * depth_dim) % _PLAN_LANES == 0
        and joint_num <= _PLAN_LANES
        and _chunk_rows(hw, joint_num * depth_dim) is not None
    )


def _padded_joint_num(joint_num: int, depth_dim: int, hw: int) -> int | None:
    if _PLAN_LANES % depth_dim != 0:
        return None
    g = max(1, _PLAN_LANES // depth_dim)
    j2 = -(-joint_num // g) * g
    return j2 if _lanes_supported(j2, depth_dim, hw) else None


def _plan_fits(joint_num: int, depth_dim: int, hw: int, channels: int) -> bool:
    return (
        _lanes_supported(joint_num, depth_dim, hw)
        and channels % _PLAN_LANES == 0
        and (_chunk_rows(hw, joint_num * depth_dim) or 0) % 8 == 0
    )


@functools.cache
def jax_plan(joint_num: int, depth_dim: int, hw: int, channels: int) -> int | None:
    """JAX's ``_pad_plan``: the joint count JAX runs its fused kernel at (J,
    or J padded up to a 128-lane multiple of J*D, at most 2J), or None where
    JAX computes the logits outside any kernel. The port's kernels take any
    J, so only the choice of route is copied, not the weight padding."""
    if _plan_fits(joint_num, depth_dim, hw, channels):
        return joint_num
    j2 = _padded_joint_num(joint_num, depth_dim, hw)
    if j2 is not None and j2 <= 2 * joint_num and _plan_fits(j2, depth_dim, hw, channels):
        return j2
    return None


def fused_supported(joint_num: int, depth_dim: int, hw: int, channels: int, dtype: torch.dtype) -> bool:
    """Whether ``fused_final_conv_integral`` takes ``FusedHeadIntegral`` (K1
    and K2 on the card) for a head of ``joint_num`` joints, ``depth_dim``
    bins, ``hw`` rows, ``channels`` features and ``dtype``. A pure
    predicate on shapes and dtype:

    - bf16: C a multiple of 16 up to K2's 256 channels, D <= 64; J and H*W
      are free;
    - fp32: exactly where JAX runs its fused kernel in fp32 (``jax_plan``;
      it needs C % 128 == 0), within K1/K2-fp32's limits (C a multiple of
      32 up to 256, D <= 64);
    - any other dtype: never.

    Within these limits both kernels' shared memory fits a Hopper block."""
    multiple = _C_MULTIPLE.get(dtype)
    if multiple is None or not (channels % multiple == 0 and multiple <= channels <= _MAX_CHANNELS
                                and 1 <= depth_dim <= _MAX_DEPTH):
        return False
    return dtype == torch.bfloat16 or jax_plan(joint_num, depth_dim, hw, channels) is not None


def plain(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int, exp2: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. feat (B, HW, C), kernel (C, J*D), bias (J*D,)
    -> coords (B, J, 3), per-joint max m (B, J) and normalizer
    s = sum exp(v - m) (B, J), all fp32 (fp64 for fp64 inputs). Products of
    bf16 values are exact in fp32, so upcasting first equals fp32
    accumulation. ``exp2``: ``IHPR_EXP2``'s base-2 logits from the scaled
    W and b, m their max and s = sum exp2(v - m)."""
    if exp2:
        kernel, bias = base2_scale(kernel, bias)
    acc = _acc_dtype(feat)
    v = feat.to(acc) @ kernel.to(acc) + bias.to(acc)  # (B, HW, J*D)
    return integral_volume.plain(v, joint_num, depth_dim, width, base2=exp2)


# The pre-pass of K1-fp32 / K2-fp32 (csrc/fused_head_f32.cuh): each joint
# padded to _MAX_DEPTH bins; position p of a 32-channel block of the Wt
# planes holds channel _PERM32[p], position q of an 8-bin group of the W
# planes bin _PERM8[q].
_PERM32 = [8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1) for p in range(32)]
_PERM8 = [2 * (q & 3) + (q >> 2) for q in range(8)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero) by the integer rule of ``csrc/tf32x3.cuh:to_tf32``: the low 13
    bits of the result are zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 x -> (hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi),
    |x - (hi + lo)| <= 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_planes(kernel: torch.Tensor, joint_num: int, depth_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fp32 kernels' pre-pass. kernel (C, J*D) fp32
    -> wt (2, J*64, C) and w (2, C, J*64): the TF32 hi plane, then the lo
    plane, every joint padded to 64 bins with zeros. wt is K-major over
    channels, each 32-channel block in ``_PERM32``'s order; w is K-major
    over bins, each 8-bin group in ``_PERM8``'s (tf32x3::as_a's relabelling
    of k)."""
    c = kernel.shape[0]
    padded = kernel.new_zeros(c, joint_num, _MAX_DEPTH)
    padded[:, :, :depth_dim] = kernel.view(c, joint_num, depth_dim)
    planes = torch.stack(tf32_split(padded))  # (2, C, J, 64)
    bins = torch.tensor([8 * (p // 8) + _PERM8[p % 8] for p in range(_MAX_DEPTH)], device=kernel.device)
    chans = torch.tensor([32 * (p // 32) + _PERM32[p % 32] for p in range(c)], device=kernel.device)
    w = planes[..., bins].reshape(2, c, joint_num * _MAX_DEPTH)
    wt = planes.permute(0, 2, 3, 1).reshape(2, joint_num * _MAX_DEPTH, c)[..., chans]
    return wt.contiguous(), w.contiguous()


@functools.cache
def _lib(name: str = _LIB) -> ctypes.CDLL:
    """The forward library ``name`` (``_LIB`` or ``_F32_LIB``: one C
    interface, its symbols named ``ihpr_<name>``; ``_F32_LIB`` also sizes
    its scratch, ``ihpr_<name>_scratch``)."""
    lib = _build.load(name)
    smem, run = getattr(lib, f"ihpr_{name}_smem"), getattr(lib, f"ihpr_{name}")
    smem.restype, smem.argtypes = ctypes.c_size_t, [ctypes.c_int]
    run.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    if name == _F32_LIB:
        lib.ihpr_fused_head_integral_fwd_f32_scratch.restype = ctypes.c_size_t
        lib.ihpr_fused_head_integral_fwd_f32_scratch.argtypes = [ctypes.c_int] * 4
    return lib


def plain_bwd(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int, exp2: bool = False, bexp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, rounded as the JAX kernel
    rounds: dv in fp32; dvc = dv in kernel's dtype feeds both contractions,
    each accumulated in fp32; dfeat (B, HW, C) in feat's dtype, dW (C, J*D)
    in kernel's dtype, db (J*D,) summed from the fp32 dv, in bias's dtype
    (fp64 throughout for fp64 inputs). ``exp2`` (m, s from ``plain`` in the
    same mode): the scaled W and b, rows of log2 s and ln 2 (so dv is the
    base-2 logits' cotangent and dfeat comes out exact), dW and db times
    log2 e before their rounding; ``bexp``: p from a bf16 exp of a bf16
    argument."""
    b, hw, c = feat.shape
    jd = joint_num * depth_dim
    if exp2:
        kernel, bias = base2_scale(kernel, bias)
    scale = _LOG2E if exp2 else 1.0
    acc = _acc_dtype(feat)
    v = feat.to(acc) @ kernel.to(acc) + bias.to(acc)  # (B, HW, J*D)
    dv = integral_volume.plain_dv(v, m, s, coords, g, joint_num, depth_dim, width, base2=exp2,
                                  g_scale=_LN2 if exp2 else 1.0, bexp=bexp)
    dvc = dv.to(kernel.dtype).to(acc)
    dfeat = (dvc @ kernel.to(acc).t()).to(feat.dtype)
    dw = (feat.to(acc).reshape(b * hw, c).t() @ dvc.view(b * hw, jd) * scale).to(kernel.dtype)
    db = (dv.sum(dim=(0, 1)) * scale).to(bias.dtype)
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
    """What both kernels of either dtype require of feat, kernel and bias;
    returns (B, HW, C)."""
    b, hw, c = _check(feat, kernel, bias, joint_num, depth_dim, width)
    _check_cuda_tensors(feat, kernel, bias)
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned")
    multiple = _C_MULTIPLE[feat.dtype]
    if c % multiple:
        raise ValueError(f"C={c} must be a multiple of {multiple} for {feat.dtype} heads")
    if not 1 <= depth_dim <= _MAX_DEPTH:
        raise ValueError(f"depth_dim={depth_dim} must be in [1, {_MAX_DEPTH}]")
    if not (1 <= b <= 65535 and joint_num >= 1 and hw >= 1):
        raise ValueError(f"batch {b} must be in [1, 65535], J and H*W >= 1")
    return b, hw, c


def kernel_stats(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    joint_num: int, depth_dim: int, width: int, exp2: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 (bf16 operands) or K1-fp32 (fp32 operands) on the same contract as
    ``plain``, ``exp2`` included. Launches on the current stream without
    synchronizing; raises on any input the kernel does not take and on a
    refused launch."""
    global launches, f32_launches
    b, hw, c = _check_kernel_inputs(feat, kernel, bias, joint_num, depth_dim, width)
    if exp2:
        kernel, bias = base2_scale(kernel, bias)
    name = _LIB if feat.dtype == torch.bfloat16 else _F32_LIB
    lib = _lib(name)
    smem = getattr(lib, f"ihpr_{name}_smem")(c)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    opts = dict(dtype=torch.float32, device=feat.device)
    coords = torch.empty((b, joint_num, 3), **opts)
    m = torch.empty((b, joint_num), **opts)
    s = torch.empty((b, joint_num), **opts)
    with torch.cuda.device(feat.device):
        if name == _LIB:  # W transposed
            wt = torch.empty((joint_num * depth_dim, c), dtype=feat.dtype, device=feat.device)
        else:  # W's split planes and the row parts' states
            wt = torch.empty(lib.ihpr_fused_head_integral_fwd_f32_scratch(b, hw, c, joint_num), **opts)
        err = getattr(lib, f"ihpr_{name}")(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), wt.data_ptr(),
            coords.data_ptr(), m.data_ptr(), s.data_ptr(),
            b, hw, width, c, joint_num, depth_dim, _MODE_EXP2 if exp2 else 0,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if name == _LIB:
        launches += 1
    else:
        f32_launches += 1
    return coords, m, s


@functools.cache
def _bwd_lib(name: str = _BWD_LIB) -> ctypes.CDLL:
    """The backward library ``name`` (``_BWD_LIB`` or ``_F32_BWD_LIB``: one
    C interface, its symbols named ``ihpr_<name>``)."""
    lib = _build.load(name)
    sym = f"ihpr_{name}"
    smem, max_c = getattr(lib, f"{sym}_smem"), getattr(lib, f"{sym}_max_channels")
    parts, run = getattr(lib, f"{sym}_partials"), getattr(lib, sym)
    smem.restype, smem.argtypes = ctypes.c_size_t, [ctypes.c_int]
    max_c.restype, max_c.argtypes = ctypes.c_int, []
    parts.restype, parts.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    run.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def kernel_bwd(
    feat: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
    m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int, exp2: bool = False, bexp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 (bf16 operands) or K2-fp32 (fp32 operands) on the same contract as
    ``plain_bwd``, ``exp2`` and ``bexp`` included. Checks feat, kernel and bias as ``kernel_stats`` does,
    and m, s (B, J), coords, g (B, J, 3) as fp32 contiguous tensors on the
    same device. Launches on the current stream without synchronizing;
    raises on any input the kernel does not take and on a refused launch."""
    global bwd_launches, f32_bwd_launches
    b, hw, c = _check_kernel_inputs(feat, kernel, bias, joint_num, depth_dim, width)
    for name, t, shape in (("m", m, (b, joint_num)), ("s", s, (b, joint_num)),
                           ("coords", coords, (b, joint_num, 3)), ("g", g, (b, joint_num, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}{tuple(t.shape)}: need float32{shape}")
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feat.device}")
    name = _BWD_LIB if feat.dtype == torch.bfloat16 else _F32_BWD_LIB
    sym = f"ihpr_{name}"
    lib = _bwd_lib(name)
    max_c = getattr(lib, f"{sym}_max_channels")()
    if c > max_c:
        raise ValueError(f"C={c} is more than the backward's {max_c} channels")
    smem = getattr(lib, f"{sym}_smem")(c)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory (> {_MAX_SMEM})")
    jd = joint_num * depth_dim
    rows = fold_bwd_rows(m, s, coords, g, base2=exp2, g_scale=_LN2 if exp2 else 1.0)
    dw = torch.empty_like(kernel)
    db = torch.empty_like(bias)
    if exp2:
        kernel, bias = base2_scale(kernel, bias)
    f32 = dict(dtype=torch.float32, device=feat.device)
    # bf16: W transposed; fp32: W's split planes, Wt's and W's (4, J*64, C)
    wt = (torch.empty((jd, c), dtype=feat.dtype, device=feat.device) if name == _BWD_LIB
          else torch.empty((4, joint_num * _MAX_DEPTH, c), **f32))
    with torch.cuda.device(feat.device):
        parts = getattr(lib, f"{sym}_partials")(b, hw, joint_num)
        part = torch.empty((parts, joint_num, c, _MAX_DEPTH), **f32)
        dbpart = torch.empty((parts, joint_num, _MAX_DEPTH), **f32)
        dfeat = torch.empty_like(feat)
        err = getattr(lib, sym)(
            feat.data_ptr(), kernel.data_ptr(), bias.data_ptr(), rows.data_ptr(),
            wt.data_ptr(), part.data_ptr(), dbpart.data_ptr(),
            dfeat.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, hw, width, c, joint_num, depth_dim, parts,
            (_MODE_EXP2 if exp2 else 0) | (_MODE_BEXP if bexp else 0),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if name == _BWD_LIB:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    return dfeat, dw, db


class FusedHeadIntegral(torch.autograd.Function):
    """coords = fused final conv + integral of (feat, kernel, bias): K1
    forward and K2 backward (their fp32 instances for fp32 operands) on CUDA
    tensors, ``plain`` and ``plain_bwd`` on CPU tensors, in the exp modes
    ``modes`` = (exp2, bexp). Saves feat, kernel, bias, m, s and coords for
    the backward; nothing when no input needs a gradient or
    ``grad_enabled`` (the caller's ``torch.is_grad_enabled()``: the forward
    itself runs with grad off) is False, as under ``no_grad`` and
    ``inference_mode``."""

    @staticmethod
    def forward(ctx, feat, kernel, bias, joint_num: int, depth_dim: int, width: int,
                grad_enabled: bool, modes: Tuple[bool, bool] = (False, False)):
        run = kernel_stats if feat.is_cuda else plain
        coords, m, s = run(feat, kernel, bias, joint_num, depth_dim, width, modes[0])
        if grad_enabled and any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(feat, kernel, bias, m, s, coords)
            ctx.dims = (joint_num, depth_dim, width, *modes)
        return coords

    @staticmethod
    def backward(ctx, g):
        feat, kernel, bias, m, s, coords = ctx.saved_tensors
        run = kernel_bwd if feat.is_cuda else plain_bwd
        grads = run(feat, kernel, bias, m, s, coords, g.to(m.dtype).contiguous(), *ctx.dims)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None, None)


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
    tensors. Heads ``fused_supported`` admits (bf16 within K1/K2's limits;
    fp32 where JAX has a fused plan) run ``FusedHeadIntegral`` (K1/K2 or
    K1/K2-fp32 on CUDA tensors) in the exp modes the environment sets now
    (``exp_modes``); any other head forms the fp32 logits
    (``_Logits``) and runs ``integral_volume.SoftArgmaxVolume`` (K3/K4 on
    CUDA tensors). CPU tensors take the same route through the plain
    versions."""
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
    if fused_supported(joint_num, depth_dim, h * w, c, features.dtype):
        return FusedHeadIntegral.apply(
            feat, kernel, bias, joint_num, depth_dim, w, torch.is_grad_enabled(), exp_modes()
        )
    return integral_volume.soft_argmax_volume(
        _Logits.apply(feat, kernel, bias), joint_num, depth_dim, w
    )
