"""Fused stride-1 SAME 3x3 conv + BatchNorm statistics, forward and
backward: the counterpart of ``ihpr_tpu/ops/conv_bn.py``.

    fused_conv3x3_bn(x, w, mul, add) -> (y, s1, s2)

    a = relu(x * mul + add)              # optional per-channel prologue
    y = conv3x3(a, w), stride 1, SAME     # fp32 accumulation, x's dtype
    s1 = sum_pixels(yf); s2 = sum_pixels(yf * yf)   # fp32, pre-cast

x is NHWC (B, H, W, C) and w HWIO (3, 3, C, N), as in JAX; the kernels
take w as (9, C, N) in the tap order t = (dy+1)*3 + (dx+1).

- K7, ``csrc/conv_bn_fwd.cu`` (the port of ``_fwd_kernel``): the conv with
  the prologue and the statistics epilogue;
- K8, ``csrc/conv_bn_bwd.cu`` (the port of ``_bwd_kernel``): g folded and
  rounded as in K6, ``da = sum_t shift_{-t}(gc) w_t^T`` with the
  prologue's backward, and per tap ``dw_t = shift_t(a)^T gc``.

The route inside each library is chosen by dtype. bf16 takes the Hopper
kernels of ``csrc/conv3_hopper.cuh``: one elementwise pass writes a (and,
backward, gc) to scratch, then TMA reads each tap as a shifted 4-D box
(zero outside the image: the SAME padding) and wgmma multiplies. fp32
(K7/K8-fp32), which JAX multiplies at ``Precision.HIGHEST``, takes the
kernels of ``csrc/conv3_f32.cuh``: the same shifted boxes in fp32, every
product in 3xTF32 on wgmma as K5/K6-fp32 (``csrc/matmul_bn_f32.cuh``), A
split in registers (a formed there from x; g written once to scratch), B
from the TF32 hi and lo planes of each tap's w that a pre-pass splits once
a call (``split_planes`` is its plain version). JAX's conv3 route takes an
fp32 ResNet-50 block only where an image's plane fits its VMEM budget
beside the nine fp32 weight blocks: stage 3 at a 128x128 frame, none at
256x256. Neither route is a fallback for the other; no failure is caught.

``FusedConv3x3BN`` is the autograd Function: a CUDA tensor goes to the
kernels, which launch or raise; a CPU tensor goes to ``plain`` /
``plain_bwd`` (``integral_volume.use_kernels``, which refuses
``IHPR_PALLAS=off`` on a CUDA tensor). ``kernel_fwd`` and ``kernel_bwd`` count one launch per call,
however many CUDA kernels the call runs: bf16 in ``launches`` /
``bwd_launches``, fp32 in ``f32_launches`` / ``f32_bwd_launches``. ``supported`` and ``profitable``
are JAX's route predicates, copied; as in ``matmul_bn`` they pick the
Bottleneck blocks that take the fused route and do not gate the kernels,
which take any B, H, W and C, N multiples of 8.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
from ihpr_tpu_torch.ops.integral_volume import _acc_dtype, use_kernels
from ihpr_tpu_torch.ops.matmul_bn import (
    _VMEM_BUDGET, _planes_shape, _ptr, _stream, check_cotangents, check_kernel_inputs, fold_g, prologue,
    prologue_bwd,
)
from ihpr_tpu_torch.ops.matmul_bn import split_planes as _split_one

_FWD_LIB = "conv_bn_fwd"
_BWD_LIB = "conv_bn_bwd"

# Launches of K7 (``launches``), K8 (``bwd_launches``), K7-fp32
# (``f32_launches``) and K8-fp32 (``f32_bwd_launches``) since the count was
# last set to 0; each wrapper adds one per launch of its kernel and nothing
# else touches them.
launches = 0
bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

# --- JAX's route predicates (ihpr_tpu/ops/conv_bn.py:46-112) ------------------


def _fwd_costs(c: int, n: int, item: int) -> tuple[int, int]:
    """(bytes per tile row, fixed bytes) of the TPU forward kernel."""
    per_row = 2 * (c + n) * item + 4 * n + c * item + 2 * 128 * 4
    return per_row, 2 * 9 * c * n * item + 8 * n


def _bwd_costs(c: int, n: int, item: int) -> tuple[int, int]:
    """(bytes per tile row, fixed bytes) of the TPU backward kernel."""
    per_row = 4 * (c + n) * item + 4 * n + 4 * c + 4 * n + 2 * 128 * 4
    return per_row, 9 * c * n * (item + 4) + 8 * c + 8 * n


def _images_per_tile(b: int, hw: int, c: int, n: int, itemsize: int, bwd: bool) -> int | None:
    """Largest divisor G of B such that G whole images fit the TPU kernel's
    VMEM budget; None if even one image does not."""
    row_b, fixed_b = (_bwd_costs if bwd else _fwd_costs)(c, n, itemsize)
    cap = max(0, (_VMEM_BUDGET - fixed_b) // row_b) // hw
    cap = min(cap, b)
    for g in range(cap, 0, -1):
        if b % g == 0:
            return g
    return None


def supported(b: int, h: int, w: int, c: int, n: int, stride: int, itemsize: int = 2) -> bool:
    """Shapes JAX's fused 3x3 route takes."""
    ok_axis = lambda v: v % 128 == 0 or v <= 256  # noqa: E731
    return (
        stride == 1
        and (h * w) % 8 == 0
        and w >= 2
        and ok_axis(c)
        and ok_axis(n)
        and _images_per_tile(b, h * w, c, n, itemsize, bwd=False) is not None
        and _images_per_tile(b, h * w, c, n, itemsize, bwd=True) is not None
    )


def profitable(c: int, n: int) -> bool:
    """JAX's channel-depth gate for the fused 3x3 route: min(c, n) at least
    ``IHPR_CONV3_MIN_CH`` (default 256)."""
    return min(c, n) >= int(os.environ.get("IHPR_CONV3_MIN_CH", "256"))


# --- plain versions -------------------------------------------------------------


def _torch_weight(w9: torch.Tensor, dtype) -> torch.Tensor:
    """(9, C, N) taps -> (N, C, 3, 3), the layout of ``F.conv2d``."""
    _, c, n = w9.shape
    return w9.to(dtype).reshape(3, 3, c, n).permute(3, 2, 0, 1)


def plain(x: torch.Tensor, w9: torch.Tensor, mul=None, add=None):
    """Plain PyTorch version. x (B, H, W, C), w9 (9, C, N) -> y (B, H, W, N)
    in x's dtype, s1 and s2 (N,) summed from the fp32 conv output (fp64
    for fp64 inputs)."""
    acc = _acc_dtype(x)
    a = prologue(x, mul, add).to(acc).permute(0, 3, 1, 2)
    with no_tf32():
        yf = F.conv2d(a, _torch_weight(w9, acc), padding=1).permute(0, 2, 3, 1)
    return yf.to(x.dtype), yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def plain_bwd(x, w9, mul, add, y, dy, ds1, ds2):
    """Plain PyTorch version of the backward: (dx in x's dtype, dw (9, C, N)
    in the accumulation dtype, dmul, dadd), None for dmul/dadd without
    mul."""
    b, h, w, c = x.shape
    n = w9.shape[2]
    gc = fold_g(y, dy, ds1, ds2).permute(0, 3, 1, 2)
    a = prologue(x, mul, add).to(gc.dtype).permute(0, 3, 1, 2)
    wt = _torch_weight(w9, gc.dtype)
    with no_tf32():
        da = torch.nn.grad.conv2d_input(a.shape, wt, gc, padding=1)
        dwt = torch.nn.grad.conv2d_weight(a, wt.shape, gc, padding=1)
    dw = dwt.permute(2, 3, 1, 0).reshape(9, c, n)
    dx, dmul, dadd = prologue_bwd(x.reshape(-1, c), mul, add, da.permute(0, 2, 3, 1).reshape(-1, c))
    return dx.reshape(b, h, w, c), dw, dmul, dadd


def split_planes(w9: torch.Tensor, trans: bool) -> torch.Tensor:
    """Plain version of K7-fp32's and K8-fp32's pre-pass: fp32 w9 (9, C, N)
    -> (9, 2, R, L'), each tap's ``matmul_bn.split_planes``: with ``trans``
    K7-fp32's B, rows n over the contraction C, else K8-fp32's da B, rows c
    over N."""
    return torch.stack([_split_one(w9[t], trans) for t in range(w9.shape[0])])


# --- the kernels -------------------------------------------------------------------


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, C) without a copy (raises if one is needed)."""
    return t.view(-1, t.shape[-1])


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load(_FWD_LIB)
    lib.ihpr_conv_bn_fwd_partials.restype = ctypes.c_int
    lib.ihpr_conv_bn_fwd_partials.argtypes = [ctypes.c_int] * 5
    lib.ihpr_conv_bn_fwd.restype = ctypes.c_int
    lib.ihpr_conv_bn_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.ihpr_conv_bn_split.restype = ctypes.c_int
    lib.ihpr_conv_bn_split.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_LIB)
    lib.ihpr_conv_bn_bwd_dx_partials.restype = ctypes.c_int
    lib.ihpr_conv_bn_bwd_dx_partials.argtypes = [ctypes.c_int] * 5
    lib.ihpr_conv_bn_bwd_dw_partials.restype = ctypes.c_int
    lib.ihpr_conv_bn_bwd_dw_partials.argtypes = [ctypes.c_int] * 6
    lib.ihpr_conv_bn_bwd.restype = ctypes.c_int
    lib.ihpr_conv_bn_bwd.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    return lib


def _scratch(x2, mul, rows: int, length: int):
    """bf16: the (M, C) buffer the route writes a = relu(x*mul + add) into,
    None without the prologue (a is x); fp32: the (9, 2, rows, length
    rounded up to 32) TF32 planes of w's split (the fp32 kernels form a in
    registers)."""
    if x2.dtype == torch.float32:
        return torch.empty((9, *_planes_shape(rows, length)), dtype=torch.float32, device=x2.device)
    return torch.empty_like(x2) if mul is not None else None


def kernel_fwd(x: torch.Tensor, w9: torch.Tensor, mul=None, add=None):
    """K7 on the same contract as ``plain``. Launches on the current stream
    without synchronizing; raises on any input it does not take and on a
    refused launch."""
    global launches, f32_launches
    b, h, w, _ = x.shape
    x2 = _rows(x)
    m, k, n, is_bf16 = check_kernel_inputs(x2, w9, mul, add)
    if w9.shape[0] != 9:
        raise ValueError(f"w9 {tuple(w9.shape)} is not (9, C, N)")
    lib = _fwd_lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = _scratch(x2, mul, n, k)  # bf16: a; fp32: w's split, K7-fp32's B
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s = torch.empty((2, n), **f32)
    with torch.cuda.device(x.device):  # fp32's partial count follows this card's SM count
        parts = lib.ihpr_conv_bn_fwd_partials(b, h, w, n, is_bf16)
        part = torch.empty((parts, 2, n), **f32)
        err = lib.ihpr_conv_bn_fwd(
            x2.data_ptr(), w9.data_ptr(), _ptr(mul), _ptr(add), _ptr(scratch), y.data_ptr(), part.data_ptr(),
            parts, s.data_ptr(), b, h, w, k, n, is_bf16, _stream(),
        )
    if err:
        raise RuntimeError(f"{_FWD_LIB} launch failed: CUDA error {err}")
    if is_bf16:
        launches += 1
    else:
        f32_launches += 1
    return y.view(b, h, w, n), s[0], s[1]


def kernel_bwd(x, w9, mul, add, y, dy, ds1, ds2):
    """K8 on the same contract as ``plain_bwd`` (dw in fp32). Launches on
    the current stream without synchronizing; raises on any input it does
    not take and on a refused launch."""
    global bwd_launches, f32_bwd_launches
    b, h, w, _ = x.shape
    x2 = _rows(x)
    m, k, n, is_bf16 = check_kernel_inputs(x2, w9, mul, add)
    if w9.shape[0] != 9:
        raise ValueError(f"w9 {tuple(w9.shape)} is not (9, C, N)")
    y2, dy2 = _rows(y), _rows(dy)
    ds = check_cotangents(x2, y2, dy2, ds1, ds2, n)
    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = _scratch(x2, mul, k, n)  # bf16: a; fp32: w's split, K8-fp32's da B
    gc = torch.empty_like(y2)  # g in x's dtype
    dx = torch.empty_like(x2)
    dw = torch.empty((9, k, n), **f32)
    dmd = torch.empty((2, k), **f32)
    with torch.cuda.device(x.device):  # partial counts follow this card's SM count
        parts_x = lib.ihpr_conv_bn_bwd_dx_partials(b, h, w, k, is_bf16)
        parts_w = lib.ihpr_conv_bn_bwd_dw_partials(b, h, w, k, n, is_bf16)
        part_x = torch.empty((parts_x, 2, k), **f32)
        part_w = torch.empty((parts_w, 9, k, n), **f32)
        err = lib.ihpr_conv_bn_bwd(
            x2.data_ptr(), w9.data_ptr(), _ptr(mul), _ptr(add), y2.data_ptr(), dy2.data_ptr(),
            ds.data_ptr(), _ptr(scratch), gc.data_ptr(), dx.data_ptr(), dw.data_ptr(), dmd.data_ptr(),
            part_x.data_ptr(), parts_x, part_w.data_ptr(), parts_w, b, h, w, k, n, is_bf16, _stream(),
        )
    if err:
        raise RuntimeError(f"{_BWD_LIB} launch failed: CUDA error {err}")
    if is_bf16:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    dx = dx.view(x.shape)
    if mul is None:
        return dx, dw, None, None
    return dx, dw, dmd[0], dmd[1]


class FusedConv3x3BN(torch.autograd.Function):
    """(y, s1, s2) of (x, w9, mul, add): K7 forward and K8 backward on CUDA
    tensors, ``plain`` and ``plain_bwd`` on CPU tensors. dw comes back in
    w9's dtype."""

    @staticmethod
    def forward(ctx, x, w9, mul, add):
        ctx.kernels = use_kernels(x.device)  # the backward takes the forward's route
        y, s1, s2 = (kernel_fwd if ctx.kernels else plain)(x, w9, mul, add)
        ctx.save_for_backward(x, w9, mul, add, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w9, mul, add, y = ctx.saved_tensors
        run = kernel_bwd if ctx.kernels else plain_bwd
        dx, dw, dmul, dadd = run(x, w9, mul, add, y, dy.contiguous(), ds1, ds2)
        return dx, dw.to(w9.dtype), dmul, dadd


def fused_conv3x3_bn(x: torch.Tensor, w: torch.Tensor, mul=None, add=None):
    """NHWC (B, H, W, C) x HWIO (3, 3, C, N) stride-1 SAME conv with the
    optional relu(x*mul + add) prologue and the BN-statistics epilogue.
    Returns (y, s1, s2): y (B, H, W, N) in x's dtype, s1 = sum(y) and s2 =
    sum(y^2) over all pixels in fp32, taken before the cast. w is cast to
    x's dtype, as JAX does. On the card x must already be contiguous."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused 3x3 conv + BN statistics for device {x.device}")
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not NHWC and (3, 3, C, N)")
    if mul is not None:
        acc = _acc_dtype(x)
        mul, add = mul.to(acc), add.to(acc)
    w9 = w.reshape(9, w.shape[2], w.shape[3]).to(x.dtype).contiguous()
    return FusedConv3x3BN.apply(x, w9, mul, add)
