"""Fused 1x1 conv (matmul) + BatchNorm statistics, forward and backward:
the counterpart of ``ihpr_tpu/ops/matmul_bn.py``.

    fused_matmul_bn(x, w, mul, add) -> (y, s1, s2)

    a  = relu(x * mul + add)   # optional per-channel prologue (a BN apply)
    y  = a @ w                 # fp32 accumulation, stored in x's dtype
    s1 = colsum(yf), s2 = colsum(yf * yf)   # fp32, from the accumulator

- K5, ``csrc/matmul_bn_fwd.cu`` (the port of ``_fwd_kernel``), computes y
  and the statistics in one pass; ``a`` never reaches device memory. In
  bf16 it runs the TMA + wgmma kernel of ``csrc/matmul_bn_hopper.cuh``:
  persistent CTAs that read x once for N up to 256, keep w in shared
  memory where it fits, form ``a`` in place in the tiles they load, and
  store y through staging tiles;
- K6, ``csrc/matmul_bn_bwd.cu`` (the port of ``_bwd_kernel``), folds the
  statistics' cotangents into ``g = dy + ds1 + 2*y*ds2`` (with the saved,
  rounded y), rounds g to x's dtype, recomputes ``a`` from x and returns
  dx, dw (fp32), dmul and dadd. In bf16 it runs the TMA + wgmma kernels of
  ``csrc/matmul_bn_hopper.cuh``, which form gc, and a, in shared memory from
  the tiles they load, so neither reaches device memory: one kernel where
  K and N are at most 256 and dw fits a warpgroup's registers (K x N up to
  128 x 128 after rounding each up to 64, 128 or 256), else a dx kernel
  and a dw kernel.

fp32 operands, which JAX multiplies at ``Precision.HIGHEST``, take K5-fp32
and K6-fp32 (``csrc/matmul_bn_f32.cuh``, the same two entry points): every
product in 3xTF32 on wgmma (~2^-21 relative a product, fp32 accumulation),
A split in registers, B from TF32 hi and lo planes of w that a pre-pass
splits once a call (``split_planes`` is its plain version); g and a stay in
registers, and dw's accumulators are flushed into fp32 partials every 16
row tiles. ``f32_launches`` and ``f32_bwd_launches`` count them.

``ops/conv_bn.py`` takes ``check_kernel_inputs`` and ``split_planes`` from
here; its fp32 route (K7/K8-fp32, ``csrc/conv3_f32.cuh``) splits each tap's
w the same way in the same pre-pass kernel.

``FusedMatmulBN`` is the autograd Function around the pair: a CUDA tensor
goes to the kernels, which launch or raise; a CPU tensor goes to the plain
versions here (``plain``, ``plain_bwd``), which are also what the kernels
are held against on the card.

Data-parallel, each rank runs K5/K6 on its own rows, and the Bottleneck
hands the local s1, s2 to ``BN.from_sums``, which sums them over the ranks
in one differentiable all-reduce (``parallel/mesh.py:AllReduceSum``): the
port of JAX's ``_sharded_call`` (``ihpr_tpu/ops/matmul_bn.py:394``), whose
shard_map runs the kernel per shard and psums s1, s2. K6 then receives the
cotangents ds1, ds2 of the global sums, as the transpose of that psum gives
them. Nothing here changes with the world size.

``supported`` is JAX's shape predicate, copied with its TPU VMEM budget.
The port uses it only to pick which Bottleneck blocks take the fused route,
so that it fuses the blocks JAX fuses (at bf16 the two routes round at
different places). It does not gate the kernels: they take any M, and K
and N that are multiples of 8.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32, tf32_split
from ihpr_tpu_torch.ops.integral_volume import _acc_dtype

_FWD_LIB = "matmul_bn_fwd"
_BWD_LIB = "matmul_bn_bwd"

# Launches of K5 (``launches``), K6 (``bwd_launches``), K5-fp32
# (``f32_launches``) and K6-fp32 (``f32_bwd_launches``) since the count was
# last set to 0; each wrapper adds one per launch of its kernel and nothing
# else touches them.
launches = 0
bwd_launches = 0
f32_launches = 0
f32_bwd_launches = 0

# --- JAX's route predicate (ihpr_tpu/ops/matmul_bn.py:56-116) ----------------

# The TPU kernel's estimated scoped-VMEM budget per kernel.
_VMEM_BUDGET = 6 * 1024 * 1024


def _fwd_costs(k: int, n: int, item: int) -> tuple[int, int]:
    """(bytes per tile row, fixed bytes) of the TPU forward kernel."""
    return 2 * (k + n) * item + 4 * n, 2 * k * n * item + 8 * n


def _bwd_costs(k: int, n: int, item: int) -> tuple[int, int]:
    """(bytes per tile row, fixed bytes) of the TPU backward kernel."""
    return (
        4 * (k + n) * item + 4 * (k + n),
        k * n * (2 * item + 4) + 8 * k + 8 * n,
    )


def _row_tile(m: int, k: int, n: int, itemsize: int, bwd: bool) -> int | None:
    """Largest divisor of m that is a multiple of 256 and keeps the TPU
    kernel's estimated VMEM under ``_VMEM_BUDGET``; None if there is none."""
    row_b, fixed_b = (_bwd_costs if bwd else _fwd_costs)(k, n, itemsize)
    cap = max(0, (_VMEM_BUDGET - fixed_b) // row_b)
    cap = min(cap, m)
    if cap < 8:
        return None
    for t in range(cap - cap % 256, 255, -256):
        if m % t == 0:
            return t
    return m if m <= cap else None


def supported(m: int, k: int, n: int, itemsize: int = 2) -> bool:
    """Shapes JAX's fused route takes (both directions tile within its VMEM
    budget, channel axes 128-multiples or at most 256)."""
    ok_axis = lambda c: c % 128 == 0 or c <= 256  # noqa: E731
    return (
        m % 8 == 0
        and ok_axis(k)
        and ok_axis(n)
        and _row_tile(m, k, n, itemsize, bwd=False) is not None
        and _row_tile(m, k, n, itemsize, bwd=True) is not None
    )


# --- plain versions -----------------------------------------------------------


def prologue(x: torch.Tensor, mul, add) -> torch.Tensor:
    """a = relu(x * mul + add) in the accumulation dtype, rounded to x's
    dtype; x itself without mul."""
    if mul is None:
        return x
    return torch.relu(x.to(_acc_dtype(x)) * mul + add).to(x.dtype)


def prologue_bwd(x: torch.Tensor, mul, add, da: torch.Tensor):
    """(dx, dmul, dadd) from da = d(loss)/d(a) (rows, K) in the accumulation
    dtype: t = da * (x*mul + add > 0), dx = t*mul in x's dtype, dmul =
    colsum(t*x), dadd = colsum(t); without mul, (da in x's dtype, None,
    None)."""
    if mul is None:
        return da.to(x.dtype), None, None
    xf = x.to(da.dtype)
    t = da * (xf * mul + add > 0)
    return (t * mul).to(x.dtype), (t * xf).sum(0), t.sum(0)


def fold_g(y: torch.Tensor, dy: torch.Tensor, ds1: torch.Tensor, ds2: torch.Tensor) -> torch.Tensor:
    """gc = (dy + ds1 + 2*y*ds2) in the accumulation dtype, rounded to y's
    dtype and returned in the accumulation dtype: the cotangent both
    backward products see."""
    acc = _acc_dtype(y)
    g = dy.to(acc) + ds1 + 2 * y.to(acc) * ds2
    return g.to(y.dtype).to(acc)


def plain(x: torch.Tensor, w: torch.Tensor, mul=None, add=None):
    """Plain PyTorch version. x (M, K), w (K, N) -> y (M, N) in x's dtype,
    s1 and s2 (N,) summed from the fp32 accumulator (fp64 for fp64
    inputs). Products of bf16 values are exact in fp32, so upcasting first
    equals fp32 accumulation."""
    acc = _acc_dtype(x)
    with no_tf32():
        yf = prologue(x, mul, add).to(acc) @ w.to(acc)
    return yf.to(x.dtype), yf.sum(0), (yf * yf).sum(0)


def plain_bwd(x, w, mul, add, y, dy, ds1, ds2):
    """Plain PyTorch version of the backward: (dx in x's dtype, dw (K, N)
    in the accumulation dtype, dmul, dadd), None for dmul/dadd without
    mul."""
    gc = fold_g(y, dy, ds1, ds2)
    with no_tf32():
        dw = prologue(x, mul, add).to(gc.dtype).t() @ gc
        da = gc @ w.to(gc.dtype).t()
    dx, dmul, dadd = prologue_bwd(x, mul, add, da)
    return dx, dw, dmul, dadd


def _perm32(p: int) -> int:
    """Contraction index at position p of a 32-long run of the fp32
    kernels' planes (``csrc/fused_head_f32.cuh:perm32``): k-step s = p // 8
    of the run takes indices 2s and 2s + 1 of each thread's 8, so that a
    thread's A values of the run are 8 consecutive ones."""
    return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1)


def split_planes(w: torch.Tensor, trans: bool) -> torch.Tensor:
    """Plain version of K5-fp32's and K6-fp32's pre-pass: fp32 w (K, N) ->
    planes (2, R, L') of TF32 bit patterns, the hi plane then the lo plane
    (``tf32_split``): with ``trans`` K5-fp32's B, rows n over the contraction
    K (R = N), else K6-fp32's dx B, rows k over N (R = K). L' is the
    contraction rounded up to 32, zeros past it, and each 32-long run holds
    its indices in ``_perm32``'s order."""
    src = w.t() if trans else w  # (R, L)
    rows, length = src.shape
    padded = src.new_zeros(rows, -(-length // 32) * 32)
    padded[:, :length] = src
    order = torch.tensor([32 * (p // 32) + _perm32(p % 32) for p in range(padded.shape[1])], device=w.device)
    return torch.stack(tf32_split(padded[:, order].contiguous()))


def _planes_shape(rows: int, length: int) -> tuple:
    return 2, rows, -(-length // 32) * 32


# --- the kernels ----------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def check_kernel_inputs(x2, w3, mul, add):
    """What K5-K8 require of x (M, K), w (TAPS, K, N) and the prologue's
    mul/add; returns (M, K, N, is_bf16). Shared with ``ops/conv_bn.py``."""
    if not (x2.is_cuda and w3.is_cuda and x2.device == w3.device):
        raise ValueError("x and w must be CUDA tensors on one device")
    if x2.dtype not in (torch.bfloat16, torch.float32) or w3.dtype != x2.dtype:
        raise ValueError(f"x {x2.dtype}, w {w3.dtype}: need both bfloat16 or both float32")
    m, k = x2.shape
    _, kw, n = w3.shape
    if kw != k or k % 8 or n % 8 or m < 1:
        raise ValueError(f"x (M={m}, K={k}), w K={kw}, N={n}: need M >= 1, K and N multiples of 8")
    if not (x2.is_contiguous() and w3.is_contiguous()) or x2.data_ptr() % 16 or w3.data_ptr() % 16:
        raise ValueError("x and w must be contiguous and 16-byte aligned")
    if (mul is None) != (add is None):
        raise ValueError("give both mul and add, or neither")
    for t in () if mul is None else (mul, add):
        if t.shape != (k,) or t.dtype != torch.float32 or t.device != x2.device or not t.is_contiguous():
            raise ValueError(f"mul/add must be contiguous float32 ({k},) on {x2.device}")
        if t.data_ptr() % 16:
            raise ValueError("mul/add must be 16-byte aligned")
    return m, k, n, int(x2.dtype == torch.bfloat16)


def check_cotangents(x2, y2, dy2, ds1, ds2, n: int) -> torch.Tensor:
    """What K6/K8 require of y and dy (M, N) beside x (M, K), and of ds1,
    ds2 (N,); returns ds = [ds1; ds2] (2, N), as the kernels take it."""
    m = x2.shape[0]
    for label, t in (("y", y2), ("dy", dy2)):
        if t.shape != (m, n) or t.dtype != x2.dtype or t.device != x2.device or not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous {x2.dtype} ({m}, {n}) on {x2.device}")
    ds = torch.stack([ds1, ds2])
    if ds.dtype != torch.float32 or ds.shape != (2, n) or ds.device != x2.device:
        raise ValueError(f"ds1/ds2 must be float32 ({n},) on {x2.device}")
    return ds


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load(_FWD_LIB)
    lib.ihpr_matmul_bn_fwd_groups.restype = ctypes.c_int
    lib.ihpr_matmul_bn_fwd_groups.argtypes = [ctypes.c_int] * 3
    lib.ihpr_matmul_bn_fwd.restype = ctypes.c_int
    lib.ihpr_matmul_bn_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.ihpr_matmul_bn_split.restype = ctypes.c_int
    lib.ihpr_matmul_bn_split.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_LIB)
    for suffix, nargs in (("dx_partials", 4), ("dw_partials", 4)):
        f = getattr(lib, f"ihpr_matmul_bn_bwd_{suffix}")
        f.restype, f.argtypes = ctypes.c_int, [ctypes.c_int] * nargs
    lib.ihpr_matmul_bn_bwd.restype = ctypes.c_int
    lib.ihpr_matmul_bn_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    return lib


def kernel_fwd(x: torch.Tensor, w: torch.Tensor, mul=None, add=None):
    """K5 on the same contract as ``plain``: x (M, K), w (K, N). Launches on
    the current stream without synchronizing; raises on any input the
    kernel does not take and on a refused launch. x of no rows (a spatial
    rank's empty shard) launches nothing: y is empty, s1 and s2 are 0."""
    global launches, f32_launches
    if x.is_cuda and x.dim() == 2 and x.shape[0] == 0:
        z = torch.zeros(w.shape[1], dtype=torch.float32, device=x.device)
        return x.new_empty((0, w.shape[1])), z, z.clone()
    m, k, n, is_bf16 = check_kernel_inputs(x, w.unsqueeze(0), mul, add)
    lib = _fwd_lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s = torch.empty((2, n), **f32)
    planes = None if is_bf16 else torch.empty(_planes_shape(n, k), **f32)  # w's split, K5-fp32's B
    with torch.cuda.device(x.device):  # partial counts follow this card's SM count
        parts = lib.ihpr_matmul_bn_fwd_groups(m, n, is_bf16)
        part = torch.empty((parts, 2, n), **f32)
        err = lib.ihpr_matmul_bn_fwd(
            x.data_ptr(), w.data_ptr(), _ptr(mul), _ptr(add), y.data_ptr(), _ptr(planes), part.data_ptr(),
            parts, s.data_ptr(), m, k, n, is_bf16, _stream(),
        )
    if err:
        raise RuntimeError(f"{_FWD_LIB} launch failed: CUDA error {err}")
    if is_bf16:
        launches += 1
    else:
        f32_launches += 1
    return y, s[0], s[1]


def kernel_bwd(x, w, mul, add, y, dy, ds1, ds2):
    """K6 on the same contract as ``plain_bwd`` (dw in fp32). Launches on
    the current stream without synchronizing; raises on any input the
    kernel does not take and on a refused launch. x of no rows launches
    nothing: dx is empty, dw, dmul and dadd are 0."""
    global bwd_launches, f32_bwd_launches
    if x.is_cuda and x.dim() == 2 and x.shape[0] == 0:
        f32 = dict(dtype=torch.float32, device=x.device)
        dw = torch.zeros(tuple(w.shape), **f32)
        if mul is None:
            return torch.empty_like(x), dw, None, None
        return torch.empty_like(x), dw, torch.zeros_like(mul), torch.zeros_like(add)
    m, k, n, is_bf16 = check_kernel_inputs(x, w.unsqueeze(0), mul, add)
    ds = check_cotangents(x, y, dy, ds1, ds2, n)
    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    planes = None if is_bf16 else torch.empty(_planes_shape(k, n), **f32)  # w's split, K6-fp32's dx B
    dx = torch.empty_like(x)
    dw = torch.empty((k, n), **f32)
    dmd = torch.empty((2, k), **f32)
    with torch.cuda.device(x.device):  # partial counts follow this card's SM count
        parts_x = lib.ihpr_matmul_bn_bwd_dx_partials(m, k, n, is_bf16)
        parts_w = lib.ihpr_matmul_bn_bwd_dw_partials(m, k, n, is_bf16)
        part_x = torch.empty((parts_x, 2, k), **f32)
        part_w = torch.empty((parts_w, k, n), **f32)
        err = lib.ihpr_matmul_bn_bwd(
            x.data_ptr(), w.data_ptr(), _ptr(mul), _ptr(add), y.data_ptr(), dy.data_ptr(),
            ds.data_ptr(), _ptr(planes), dx.data_ptr(), dw.data_ptr(), dmd.data_ptr(),
            part_x.data_ptr(), parts_x, part_w.data_ptr(), parts_w, m, k, n, is_bf16, _stream(),
        )
    if err:
        raise RuntimeError(f"{_BWD_LIB} launch failed: CUDA error {err}")
    if is_bf16:
        bwd_launches += 1
    else:
        f32_bwd_launches += 1
    if mul is None:
        return dx, dw, None, None
    return dx, dw, dmd[0], dmd[1]


class FusedMatmulBN(torch.autograd.Function):
    """(y, s1, s2) of (x, w, mul, add): K5 forward and K6 backward on CUDA
    tensors, ``plain`` and ``plain_bwd`` on CPU tensors. mul and add are
    both None (no prologue) or both given. dw comes back in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, mul, add):
        run = kernel_fwd if x.is_cuda else plain
        y, s1, s2 = run(x, w, mul, add)
        ctx.save_for_backward(x, w, mul, add, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, mul, add, y = ctx.saved_tensors
        run = kernel_bwd if x.is_cuda else plain_bwd
        dx, dw, dmul, dadd = run(x, w, mul, add, y, dy.contiguous(), ds1, ds2)
        return dx, dw.to(w.dtype), dmul, dadd


def fused_matmul_bn(x: torch.Tensor, w: torch.Tensor, mul=None, add=None):
    """(M, K) @ (K, N) with the optional relu(x*mul + add) prologue and the
    BN-statistics epilogue. Returns (y, s1, s2): y in x's dtype, s1 =
    colsum(y) and s2 = colsum(y^2) in fp32, taken before the cast.
    Gradients flow to x, w, mul and add; mean, variance and the running
    statistics belong outside, on the (N,) outputs. On the card x must
    already be contiguous: a copy would write the activation again."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused matmul + BN statistics for device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not (M, K) and (K, N)")
    if mul is not None:
        acc = _acc_dtype(x)
        mul, add = mul.to(acc), add.to(acc)
    return FusedMatmulBN.apply(x, w.contiguous(), mul, add)
