"""Integral soft-argmax over an existing logits volume, forward and
backward: the counterpart of ``ihpr_tpu/ops/integral_pallas.py``.

The volume is one (H*W, J*D) logits plane per sample, the layout the head's
NHWC heatmap has after a free reshape: lane l of row r is joint l div D at
depth bin l mod D and pixel (r mod W, r div W).

- K3, ``csrc/integral_volume_fwd.cu`` (the port of
  ``integral_pallas.py:_fwd_kernel``), reads the volume once and returns
  coords and the per-joint max m and normalizer s;
- K4, ``csrc/integral_volume_bwd.cu`` (the port of ``_bwd_kernel``),
  recomputes p from m and s and writes dv in the volume's dtype.

``SoftArgmaxVolume`` is the autograd Function around the pair; the
heatmap-logits path (``soft_argmax_from_heatmap``, ``soft_argmax_3d_fused``)
and the fused head op's shapes with no kernel plan
(``fused_head_integral.fused_final_conv_integral``) route through it. A
CUDA tensor goes to the kernels, which launch or raise; a CPU tensor goes
to the plain versions here (``plain``, ``plain_bwd``), which are also what
the kernels are held against on the card. JAX pads the joint axis with
-1e30 lanes to suit the TPU's 128-lane tiles; the kernels here take any J
and D, so nothing is padded.

``SoftArgmaxRowShards`` is the same integral over a volume whose rows are
split over the spatial ranks (``parallel/mesh.py``), evenly or not: K3 on
each rank's rows, the ranks' (coords, m, s) merged into the whole volume's,
and K4 on each rank's rows with the whole volume's (m, s). A volume of no
rows (a rank with an empty shard) launches neither kernel: its m is -inf
and its s 0, which the merge adds as exactly 0, and its dv is empty. Under a spatial mesh JAX
takes the plain-XLA soft-argmax (``coords_plain``: ``pallas_call`` has no
GSPMD rule); this is the same function with the kernels.

``use_kernels`` is the port of JAX's kernel switch ``IHPR_PALLAS``
(``integral_pallas.py:_use_pallas``), read at each call; every op module
of the port routes its autograd Functions through it:

- ``auto`` (the default) and ``interpret``: the kernels on CUDA tensors,
  the plain versions on CPU tensors. The port has no interpreter: its CPU
  route is already the plain version, and ``interpret`` (which the test
  suite sets for JAX's sake) routes as ``auto``;
- ``off``: on CPU tensors, JAX's triage routes: the fused head takes the
  no-plan route (``fused_head_integral.fused_final_conv_integral``), as
  JAX's ``j2 = None`` does, and everything else its plain versions, as on
  any CPU run. On a CUDA tensor ``off`` is refused (``ValueError``): on the
  card every dispatch launches its kernel, so no run there can report the
  plain versions' speed or accuracy as the port's;
- anything else raises ``ValueError``, on either device.

The kernel wrappers themselves (``kernel_stats``, ``kernel_bwd``, ...)
always launch: the switch chooses between them and the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.parallel.mesh import DataParallel, all_gather_rows, row_range

_FWD_LIB = "integral_volume_fwd"
_BWD_LIB = "integral_volume_bwd"

# Launches of K3 (``launches``) and K4 (``bwd_launches``) since the count
# was last set to 0; each wrapper adds one per launch and nothing else
# touches them.
launches = 0
bwd_launches = 0


KERNEL_MODES = ("auto", "interpret", "off")


def kernel_mode() -> str:
    """``IHPR_PALLAS`` as the environment sets it now (``auto`` when unset);
    raises ``ValueError`` for a value that is not one of ``KERNEL_MODES``."""
    mode = os.environ.get("IHPR_PALLAS", "auto")
    if mode not in KERNEL_MODES:
        raise ValueError(f"IHPR_PALLAS={mode!r}: expected one of {', '.join(KERNEL_MODES)}")
    return mode


def use_kernels(device) -> bool:
    """Whether a tensor on ``device`` goes to the hand-written kernels:
    every CUDA tensor does, no CPU tensor. Raises ``ValueError`` for
    ``IHPR_PALLAS=off`` on a CUDA device, and for an unknown value on
    either (``kernel_mode``)."""
    mode = kernel_mode()
    if torch.device(device).type != "cuda":
        return False
    if mode == "off":
        raise ValueError("IHPR_PALLAS=off is refused on CUDA tensors: the port runs its hand-written kernels "
                         "on every CUDA tensor (off is a triage of the CPU routes; unset it or set auto)")
    return True


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 accumulation, or fp64 for fp64 inputs (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _grid(hw: int, width: int, depth_dim: int, device, dtype):
    """x and y of each row (HW,), z of each depth bin (D,)."""
    rows = torch.arange(hw, device=device)
    x = (rows % width).to(dtype)
    y = torch.div(rows, width, rounding_mode="floor").to(dtype)
    return x, y, torch.arange(depth_dim, device=device, dtype=dtype)


def _no_rows(vol: torch.Tensor, joint_num: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The statistics of a volume with no rows: coords 0, m -inf, s 0."""
    acc = dict(dtype=_acc_dtype(vol), device=vol.device)
    b = vol.shape[0]
    return (torch.zeros((b, joint_num, 3), **acc), torch.full((b, joint_num), float("-inf"), **acc),
            torch.zeros((b, joint_num), **acc))


def plain(
    vol: torch.Tensor, joint_num: int, depth_dim: int, width: int, base2: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. vol (B, HW, J*D) -> coords (B, J, 3), per-joint
    max m (B, J) and normalizer s = sum exp(v - m) (B, J), fp32 (fp64 for
    fp64 inputs); coords 0, m -inf and s 0 where HW is 0. ``base2``: vol
    holds base-2 logits and the softmax takes exp2 (the fused head's
    ``IHPR_EXP2``), so s = sum exp2(v - m)."""
    b, hw, _ = vol.shape
    if hw == 0:
        return _no_rows(vol, joint_num)
    acc = _acc_dtype(vol)
    v = vol.to(acc).reshape(b, hw, joint_num, depth_dim).permute(0, 2, 1, 3)  # (B, J, HW, D)
    m = v.amax(dim=(2, 3))
    e = (torch.exp2 if base2 else torch.exp)(v - m[..., None, None])
    s = e.sum(dim=(2, 3))
    p = e / s[..., None, None]
    x, y, z = _grid(hw, width, depth_dim, vol.device, acc)
    p_rows = p.sum(-1)  # (B, J, HW)
    coords = torch.stack(
        [(p_rows * x).sum(-1), (p_rows * y).sum(-1), (p.sum(2) * z).sum(-1)], dim=-1
    )
    return coords, m, s


def fold_bwd_rows(
    m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor, base2: bool = False,
    g_scale: float = 1.0,
) -> torch.Tensor:
    """Per-joint backward constants, (B, J, 8): m + log s (the softmax
    normalizer folded into the exp argument, so p = exp(v - row0); s == 0
    gives +inf and p = 0), gx, gy, gz, cx, cy, cz, 0. The port of
    ``integral_pallas.fold_bwd_rows`` with per-joint m and s, so the rows
    are per joint where the TPU's are per lane. Shared by K2 and K4.
    ``base2``: m is a base-2 max, so row0 = m + log2 s and p = exp2(v -
    row0); ``g_scale`` multiplies g (the fused head's ``IHPR_EXP2`` passes
    ln 2)."""
    log_s = torch.where(s > 0, torch.log2(s) if base2 else torch.log(s), torch.full_like(s, float("inf")))
    g = g.to(m.dtype) * g_scale
    return torch.stack(
        [m + log_s, g[..., 0], g[..., 1], g[..., 2],
         coords[..., 0], coords[..., 1], coords[..., 2], torch.zeros_like(m)],
        dim=-1,
    ).contiguous()


def plain_dv(
    v: torch.Tensor, m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int, base2: bool = False, g_scale: float = 1.0,
    bexp: bool = False,
) -> torch.Tensor:
    """dv (B, HW, J*D) in v's dtype from logits v (B, HW, J*D) in the
    accumulation dtype: p * (gx (x - cx) + gy (y - cy) + gz (z - cz)).
    ``base2`` and ``g_scale`` as ``fold_bwd_rows``; ``bexp`` (the fused
    head's ``IHPR_BEXP``): the exp's argument is rounded to bf16, and so is
    p, before the arithmetic that follows."""
    b, hw, jd = v.shape
    row0, gx, gy, gz, cx, cy, cz, _ = fold_bwd_rows(m, s, coords, g, base2, g_scale).unbind(-1)  # (B, J)
    exp = torch.exp2 if base2 else torch.exp
    arg = v.view(b, hw, joint_num, depth_dim) - row0[:, None, :, None]
    if bexp:
        p = exp(arg.to(torch.bfloat16)).to(v.dtype)
    else:
        p = exp(arg)
    x, y, z = _grid(hw, width, depth_dim, v.device, v.dtype)
    tx = gx[:, None] * (x[None, :, None] - cx[:, None]) + gy[:, None] * (y[None, :, None] - cy[:, None])
    tz = gz[..., None] * (z - cz[..., None])  # (B, J, D)
    return (p * (tx[..., None] + tz[:, None])).view(b, hw, jd)


def plain_bwd(
    vol: torch.Tensor, m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> torch.Tensor:
    """Plain PyTorch version of the backward: dv with vol's shape and dtype,
    computed in fp32 (fp64 for fp64 inputs) and rounded once."""
    if vol.shape[1] == 0:
        return torch.zeros_like(vol)
    v = vol.to(_acc_dtype(vol))
    return plain_dv(v, m, s, coords, g, joint_num, depth_dim, width).to(vol.dtype)


def _check_volume(vol: torch.Tensor, joint_num: int, depth_dim: int, width: int):
    """What both kernels require of vol; returns (B, HW, is_bf16, vec):
    vec, the lanes one load moves, is the widest of 16 bytes or less whose
    size divides both the row pitch and the base address."""
    if vol.dim() != 3 or not vol.is_cuda:
        raise ValueError(f"vol must be a (B, H*W, J*D) CUDA tensor, got {vol.device} {tuple(vol.shape)}")
    b, hw, jd = vol.shape
    if joint_num < 1 or depth_dim < 1 or jd != joint_num * depth_dim:
        raise ValueError(f"vol has {jd} lanes per row: need J*D = {joint_num}*{depth_dim}")
    if width <= 0 or hw < 1 or hw % width:
        raise ValueError(f"width {width} does not divide H*W={hw}")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch {b} must be in [1, 65535]")
    if vol.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vol is {vol.dtype}: need bfloat16 or float32")
    if not vol.is_contiguous():
        raise ValueError("vol must be contiguous")
    size = vol.element_size()
    vec = 16 // size
    while jd % vec or vol.data_ptr() % (vec * size):
        vec //= 2
    return b, hw, int(vol.dtype == torch.bfloat16), vec


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load(_FWD_LIB)
    lib.ihpr_integral_volume_chunks.restype = ctypes.c_int
    lib.ihpr_integral_volume_chunks.argtypes = [ctypes.c_int] * 3
    lib.ihpr_integral_volume_fwd.restype = ctypes.c_int
    lib.ihpr_integral_volume_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    return lib


def kernel_stats(
    vol: torch.Tensor, joint_num: int, depth_dim: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on the same contract as ``plain``. Launches on the current stream
    without synchronizing; raises on any input the kernel does not take and
    on a refused launch. A CUDA volume of no rows launches nothing (a grid
    of no blocks is a launch error) and gives coords 0, m -inf, s 0."""
    global launches
    if vol.dim() == 3 and vol.is_cuda and vol.shape[1] == 0 and vol.shape[2] == joint_num * depth_dim:
        return _no_rows(vol, joint_num)
    b, hw, is_bf16, vec = _check_volume(vol, joint_num, depth_dim, width)
    jd = joint_num * depth_dim
    lib = _fwd_lib()
    f32 = dict(dtype=torch.float32, device=vol.device)
    part = torch.empty((b, lib.ihpr_integral_volume_chunks(hw, jd, vec), jd, 4), **f32)
    coords = torch.empty((b, joint_num, 3), **f32)
    m = torch.empty((b, joint_num), **f32)
    s = torch.empty((b, joint_num), **f32)
    with torch.cuda.device(vol.device):
        err = lib.ihpr_integral_volume_fwd(
            vol.data_ptr(), part.data_ptr(), coords.data_ptr(), m.data_ptr(), s.data_ptr(),
            b, hw, width, joint_num, depth_dim, is_bf16, vec,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_FWD_LIB} launch failed: CUDA error {err}")
    launches += 1
    return coords, m, s


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_BWD_LIB)
    lib.ihpr_integral_volume_bwd.restype = ctypes.c_int
    lib.ihpr_integral_volume_bwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    return lib


def kernel_bwd(
    vol: torch.Tensor, m: torch.Tensor, s: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
    joint_num: int, depth_dim: int, width: int,
) -> torch.Tensor:
    """K4 on the same contract as ``plain_bwd``. Checks vol as
    ``kernel_stats`` does, and m, s (B, J), coords, g (B, J, 3) as fp32
    contiguous tensors on vol's device. Launches on the current stream
    without synchronizing; raises on any input the kernel does not take and
    on a refused launch. A volume of no rows launches nothing: its dv is
    empty."""
    global bwd_launches
    if vol.dim() == 3 and vol.is_cuda and vol.shape[1] == 0:
        return torch.empty_like(vol)
    b, hw, is_bf16, vec = _check_volume(vol, joint_num, depth_dim, width)
    for name, t, shape in (("m", m, (b, joint_num)), ("s", s, (b, joint_num)),
                           ("coords", coords, (b, joint_num, 3)), ("g", g, (b, joint_num, 3))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}{tuple(t.shape)}: need float32{shape}")
        if t.device != vol.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vol.device}")
    rows = fold_bwd_rows(m, s, coords, g)
    dv = torch.empty_like(vol)  # a new allocation: aligned at least as vol
    with torch.cuda.device(vol.device):
        err = _bwd_lib().ihpr_integral_volume_bwd(
            vol.data_ptr(), rows.data_ptr(), dv.data_ptr(),
            b, hw, width, joint_num, depth_dim, is_bf16, vec,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_BWD_LIB} launch failed: CUDA error {err}")
    bwd_launches += 1
    return dv


class SoftArgmaxVolume(torch.autograd.Function):
    """coords of a (B, HW, J*D) logits volume: K3 forward and K4 backward on
    CUDA tensors, ``plain`` and ``plain_bwd`` on CPU tensors. Saves vol, m,
    s and coords for the backward; nothing when vol needs no gradient or
    ``grad_enabled`` (the caller's ``torch.is_grad_enabled()``) is False."""

    @staticmethod
    def forward(ctx, vol, joint_num: int, depth_dim: int, width: int, grad_enabled: bool):
        ctx.kernels = use_kernels(vol.device)  # the backward takes the forward's route
        coords, m, s = (kernel_stats if ctx.kernels else plain)(vol, joint_num, depth_dim, width)
        if grad_enabled and ctx.needs_input_grad[0]:
            ctx.save_for_backward(vol, m, s, coords)
            ctx.dims = (joint_num, depth_dim, width)
        return coords

    @staticmethod
    def backward(ctx, g):
        vol, m, s, coords = ctx.saved_tensors
        run = kernel_bwd if ctx.kernels else plain_bwd
        return run(vol, m, s, coords, g.to(m.dtype).contiguous(), *ctx.dims), None, None, None, None


def soft_argmax_volume(vol: torch.Tensor, joint_num: int, depth_dim: int, width: int) -> torch.Tensor:
    """(B, HW, J*D) logits volume -> (B, J, 3) voxel coords (x, y, z), fp32,
    differentiable through ``SoftArgmaxVolume``."""
    if vol.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no integral soft-argmax for device {vol.device}")
    if vol.dim() != 3 or vol.shape[-1] != joint_num * depth_dim or width <= 0 or vol.shape[1] % width:
        raise ValueError(
            f"vol {tuple(vol.shape)} is not (B, H*W, J*D) for J={joint_num}, D={depth_dim}, W={width}"
        )
    return SoftArgmaxVolume.apply(vol, joint_num, depth_dim, width, torch.is_grad_enabled())


def soft_argmax_from_heatmap(heatmap: torch.Tensor, joint_num: int, depth_dim: int) -> torch.Tensor:
    """The heatmap-logits path: (B, H, W, J*D) NHWC head output -> (B, J, 3)
    coords. Only a free view separates the head's output from the kernel:
    on the card the heatmap must be contiguous (a copy would write the
    whole volume again)."""
    b, h, w, c = heatmap.shape
    if c != joint_num * depth_dim:
        raise ValueError(f"heatmap has {c} channels: need J*D = {joint_num}*{depth_dim}")
    vol = heatmap.view(b, h * w, c) if heatmap.is_cuda else heatmap.reshape(b, h * w, c)
    return soft_argmax_volume(vol, joint_num, depth_dim, w)


def soft_argmax_3d_fused(logits: torch.Tensor) -> torch.Tensor:
    """Drop-in counterpart of ``integral.soft_argmax_3d`` through K3/K4:
    (B, J, D, H, W) -> (B, J, 3). Costs one transpose into the kernels'
    (B, HW, J*D) layout; ``soft_argmax_from_heatmap`` needs none."""
    b, j, d, h, w = logits.shape
    vol = logits.permute(0, 3, 4, 1, 2).reshape(b, h * w, j * d)
    return soft_argmax_volume(vol, j, d, w)


def merge_row_shards(
    coords: torch.Tensor, m: torch.Tensor, s: torch.Tensor, y0: int, rows: DataParallel
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole volume's (coords, m, s) from each spatial rank's over its
    rows, ``coords`` with y counted from the rank's first row ``y0``. The
    ranks' (coords + (0, y0, 0), m, s) are all-gathered over ``rows``, then
    merged in rank order, so every rank holds bitwise the same result:
    M = max m_r, w_r = s_r exp(m_r - M), S = sum w_r,
    coords = sum (w_r / S) (coords_r + (0, y0_r, 0)). A rank whose w_r is 0
    (its mass underflows beside another's) adds nothing, and no NaN."""
    shifted = coords + torch.tensor([0.0, float(y0), 0.0], dtype=coords.dtype, device=coords.device)
    stats = torch.cat([shifted, m[..., None], s[..., None]], dim=-1)  # (B, J, 5)
    parts = all_gather_rows(stats[None], rows)  # (S, B, J, 5)
    big_m = parts[..., 3].amax(dim=0)
    w = [torch.where(p[..., 4] > 0, p[..., 4] * torch.exp(p[..., 3] - big_m), 0.0) for p in parts]
    total = w[0]
    for wr in w[1:]:
        total = total + wr
    merged = torch.zeros_like(coords)
    for p, wr in zip(parts, w):
        merged = merged + torch.where(wr[..., None] > 0, (wr / total)[..., None] * p[..., :3], 0.0)
    return merged, big_m, total


class SoftArgmaxRowShards(torch.autograd.Function):
    """coords of the whole volume from this spatial rank's rows of it, a
    (B, h*W, J*D) logits volume whose first row is row ``y0`` of the image
    (h may be 0): K3 on the rank's rows (``plain`` on CPU tensors), then
    ``merge_row_shards``. The backward needs no communication: given the
    same cotangent g on every rank (the loss is computed on the merged
    coords), K4 (``plain_bwd``) on the rank's rows with the whole volume's
    (M, S) and coords - (0, y0, 0) is the rank's rows of the whole volume's
    dv, since dv = p g . (pos - coords) and K4 takes positions from the
    rank's first row."""

    @staticmethod
    def forward(ctx, vol, joint_num: int, depth_dim: int, width: int, y0: int, rows: DataParallel,
                grad_enabled: bool):
        ctx.kernels = use_kernels(vol.device)
        local, m, s = (kernel_stats if ctx.kernels else plain)(vol, joint_num, depth_dim, width)
        coords, big_m, total = merge_row_shards(local, m, s, y0, rows)
        if grad_enabled and ctx.needs_input_grad[0]:
            shift = torch.tensor([0.0, float(y0), 0.0], dtype=coords.dtype, device=coords.device)
            ctx.save_for_backward(vol, big_m, total, (coords - shift).contiguous())
            ctx.dims = (joint_num, depth_dim, width)
        return coords

    @staticmethod
    def backward(ctx, g):
        vol, big_m, total, coords = ctx.saved_tensors
        run = kernel_bwd if ctx.kernels else plain_bwd
        dv = run(vol, big_m, total, coords, g.to(big_m.dtype).contiguous(), *ctx.dims)
        return dv, None, None, None, None, None, None


def soft_argmax_row_shards(
    heatmap: torch.Tensor, joint_num: int, depth_dim: int, rows: DataParallel, total_rows: int
) -> torch.Tensor:
    """(B, h, W, J*D) NHWC head logits of this spatial rank's rows
    (``mesh.row_range`` of the heatmap's ``total_rows``) -> (B, J, 3) voxel
    coords of the whole image, the same on every rank of ``rows``,
    differentiable through ``SoftArgmaxRowShards``. As
    ``soft_argmax_from_heatmap``, a CUDA heatmap must be contiguous."""
    b, h, w, c = heatmap.shape
    if c != joint_num * depth_dim:
        raise ValueError(f"heatmap has {c} channels: need J*D = {joint_num}*{depth_dim}")
    y0, y1 = row_range(total_rows, rows.rank, rows.world)
    if h != y1 - y0:
        raise ValueError(f"rank {rows.rank} holds {h} heatmap rows: expected rows [{y0}, {y1}) of {total_rows}")
    vol = heatmap.view(b, h * w, c) if heatmap.is_cuda else heatmap.reshape(b, h * w, c)
    return SoftArgmaxRowShards.apply(vol, joint_num, depth_dim, w, y0, rows, torch.is_grad_enabled())
