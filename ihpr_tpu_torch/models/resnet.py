"""ResNet backbone (torchvision v1.5: the stride sits on the Bottleneck's
3x3 conv), counterpart of ``ihpr_tpu.models.resnet``.

Tensors are NCHW in ``channels_last`` memory format. Every parameter is an
fp32 master, as in the JAX package (``param_dtype=float32``); each conv
casts its weight to the compute dtype per call (autograd returns the fp32
gradient through the cast). BatchNorm parameters and running statistics
are fp32 and BatchNorm follows ``nn.Module.train()``/``eval()``. Module
names follow the JAX parameter tree (``layer{stage}_{i}.conv1``,
``down_bn``, ...), so ``models.convert`` maps one onto the other by name.

A Bottleneck in train mode with lean BN can take one of JAX's two fused
routes (``fused_1x1``: conv1/conv3 through ``ops.matmul_bn``, K5/K6;
``fused_conv3``: conv2 through ``ops.conv_bn``, K7/K8), chosen by JAX's own
shape predicates, so the port fuses exactly the blocks JAX fuses.

Data-parallel (``dp`` of world > 1, ``parallel/mesh.py``): train-mode BN
takes its statistics over the global batch, as XLA's reductions do under
JAX's mesh, by one differentiable all-reduce of the local per-channel sums
(``mesh.AllReduceSum``); its backward sums the statistics' cotangents over
the ranks, as the transpose of JAX's psum does. The conv3 route stays
single-device, as in JAX. With no ``dp`` or world 1, BN runs the
single-process code and no collective.

Row-sharded (``dp`` of spatial > 1): each rank holds its rows of every
image and stage, in GSPMD's layout (``mesh.row_range``: blocks of ceil(R /
S) rows, the last short or empty). Each module knows its stage's global
rows, from the grid's ``input_rows``. A conv of kernel k > 1 or stride 2
and the max-pool first take the input rows their windows read
(``mesh.halo_rows`` with ``mesh.conv_needs``; zeros for a conv, -inf for
the max-pool, past the image's edges), wherever they lie, and then run
with no padding in H: output rows [a, b) read rows [s*a - p, s*(b-1) - p
+ k). On rows split evenly that is ``padding`` rows above and ``k - s -
padding`` below (7x7/2: 3 and 2; 3x3/1: 1 and 1; 3x3/2 and the max-pool:
1 and 0), and a 1x1 conv of stride 2 takes none. A rank with no output
rows runs no cuDNN call and no max-pool: it returns the empty tensor of
the output's shape, still tied to its input and weight, so that the
backward runs every collective on every rank. The convs stay cuDNN calls.
BN's arithmetic is unchanged: the ranks' row counts are summed with its
statistics, so its count is the global (B, H, W) count.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ihpr_tpu_torch.ops import conv_bn, matmul_bn
from ihpr_tpu_torch.parallel.mesh import (
    DataParallel, all_reduce_sum, conv_needs, conv_rows, halo_rows, row_range, s2d_needs,
)

# resnet_type -> (block kind, stage depths, channel expansion)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
    152: ("bottleneck", (3, 8, 36, 3), 4),
}

_STAGE_WIDTHS = (64, 128, 256, 512)

# The BN arithmetics of JAX's ``_BN`` (ihpr_tpu/models/resnet.py:34-165).
# "lean_subN" stands for "lean_sub" followed by any N >= 1 (lean_sub4, ...).
BN_MODES = ("flax", "lean", "lean16", "lean_subN", "lean_sg", "lean_sgv", "frozen")


def bn_subsample(mode: str) -> int:
    """The row stride of ``mode``'s batch statistics (N of "lean_subN", else
    1); raises ValueError for a mode that is not one of ``BN_MODES``."""
    if mode.startswith("lean_sub") and mode[len("lean_sub"):].isdigit() and int(mode[len("lean_sub"):]) >= 1:
        return int(mode[len("lean_sub"):])
    if mode not in BN_MODES or mode == "lean_subN":
        raise ValueError(f"unknown bn_mode {mode!r}; use one of {BN_MODES} (lean_subN: lean_sub2, lean_sub4, ...)")
    return 1


class _Recompute(threading.local):
    depth = 0


_RECOMPUTE = _Recompute()


@contextlib.contextmanager
def recomputing(inner=None):
    """The recompute of a rematerialized block (``ResNetBackbone``'s
    ``block_remat``): BN leaves its running statistics alone inside it, as
    flax's lifted remat discards a recompute's variable updates. ``inner``:
    a context manager entered with it (selective checkpointing's)."""
    _RECOMPUTE.depth += 1
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _RECOMPUTE.depth -= 1


class BN(nn.Module):
    """BatchNorm in one of JAX's arithmetics (``BN_MODES``):

    - ``"flax"``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32,
      then cast to ``dtype`` (flax ``nn.BatchNorm``);
    - ``"lean"``: ``mul = scale * rsqrt(var + eps)`` and
      ``add = bias - mean * scale * rstd`` computed in fp32, both cast to
      ``dtype``, then ``x * mul + add`` in ``dtype`` (``_LeanBN``);
    - the measurement modes, each lean's apply with another treatment of
      the batch statistics: ``"lean16"`` takes them in ``dtype``;
      ``"lean_subN"`` from the image rows ``(N-1)//2::N`` where the stage
      has at least 2N rows; ``"lean_sg"`` detaches mean and var from the
      graph, ``"lean_sgv"`` var only; ``"frozen"`` normalizes with the
      running statistics in train mode too and never updates them.

    In train mode (``frozen`` aside) BN normalizes with the batch statistics,
    taken in fp32 over (N, H, W) as ``mean = E[x]`` and the biased ``var =
    max(E[x^2] - mean^2, 0)``, with gradients through both, and updates the
    running statistics as ``momentum * old + (1 - momentum) * batch`` (flax
    momentum 0.9; the running variance gets the biased variance too), except
    inside ``recomputing``. In eval mode it normalizes with the running
    statistics.

    With ``dp`` of world > 1 the train-mode statistics are the global
    batch's: the local fp32 sums of x and x^2 (or the sums handed to
    ``from_sums``) and the rank's row count are summed over the ranks by one
    all-reduce, and the count is the global one: a rank's samples times
    its width times the ranks' rows (each data index's spatial peers hold
    the same samples and together every row, in shares that may differ).
    On a spatial grid ``rows`` is the stage's global row count, and
    ``lean_subN`` takes the global rows its stride picks, wherever they lie
    (GSPMD slices the global tensor).
    """

    momentum = 0.9  # flax momentum: the share of the old running statistic

    def __init__(self, channels: int, mode: str, dtype: torch.dtype, eps: float = 1e-5, device=None,
                 dp: DataParallel | None = None, rows: int | None = None):
        super().__init__()
        self.dp = dp
        self.sub = bn_subsample(mode)
        self.mode = mode
        self.lean = mode != "flax"
        self.stats_dtype = dtype if mode == "lean16" else torch.float32
        self.stop_grad = {"lean_sg": "all", "lean_sgv": "var"}.get(mode, "")
        self.dtype = dtype
        self.eps = eps
        self.rows = rows
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        if _RECOMPUTE.depth:
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _synced(self) -> bool:
        return self.dp is not None and self.dp.world > 1

    def _global_sums(self, s1: torch.Tensor, s2: torch.Tensor, per_row: int, rows: int):
        """(s1, s2, count) over the ranks: the sums and this rank's ``rows``
        summed in one all-reduce; count = ``per_row`` (samples times width,
        the same on every rank) times the summed rows, in float64 (exact)."""
        c = s1.shape[0]
        s = all_reduce_sum(torch.cat([s1, s2, s1.new_full((1,), float(rows))]), self.dp)
        return s[:c], s[c:2 * c], s[2 * c].detach().double() * per_row

    def _stat_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of ``x`` (N, C, H, W) the batch statistics read: all of
        them, or for ``lean_subN`` the stage's rows ``(N-1)//2::N`` where it
        has at least 2N (on a spatial grid, the global rows of that stride
        that this rank holds)."""
        s = self.sub
        grid = self.dp.row_axis if self.dp is not None else None
        total = x.shape[2] if grid is None else self.rows
        if s == 1 or total < 2 * s:
            return x
        first = (s - 1) // 2
        if grid is None:
            return x[:, :, first::s]
        lo, hi = row_range(total, grid.rank, grid.world)
        start = first + max(0, -(-(lo - first) // s)) * s
        return x[:, :, min(start, hi) - lo:hi - lo:s]

    def _batch_stats(self, x: torch.Tensor):
        xf = self._stat_rows(x).to(self.stats_dtype)
        if self._synced():
            b, _, h, w = xf.shape
            f32 = torch.float32
            s1, s2, count = self._global_sums(xf.sum(dim=(0, 2, 3), dtype=f32),
                                              (xf * xf).sum(dim=(0, 2, 3), dtype=f32), b * w, h)
            mean = (s1 / count).to(xf.dtype)
            var = ((s2 / count).to(xf.dtype) - mean * mean).clamp_min(0.0)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        self._update_running(mean, var)
        if self.stop_grad:
            var = var.detach()
            if self.stop_grad == "all":
                mean = mean.detach()
        return mean, var

    def from_sums(self, s1: torch.Tensor, s2: torch.Tensor, per_row: int, rows: int):
        """Train-mode BN from precomputed per-channel sums (JAX's ``_SumBN``)
        over ``per_row`` (samples times width) x ``rows`` values: the fp32
        (mul, add) of the folded normalize, from mean = s1 / count and the
        biased var = max(s2 / count - mean^2, 0); the running statistics are
        updated as in ``forward``. Data-parallel, the sums and ``rows`` are
        this rank's and are summed over the ranks first (the psum of JAX's
        ``matmul_bn._sharded_call``), so K6 and K8 receive the cotangents of
        the global sums. Only the lean mode's blocks take the fused routes
        that call this (JAX's ``fusable_bn``)."""
        if self._synced():
            s1, s2, count = self._global_sums(s1, s2, per_row, rows)
        else:
            count = float(per_row * rows)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp_min(0.0)
        self._update_running(mean, var)
        return self._fold(mean, var)

    def _fold(self, mean: torch.Tensor, var: torch.Tensor):
        """The lean normalize as one per-channel (mul, add) pair (fp32, or
        lean16's statistics promoted against the fp32 scale and bias)."""
        rstd = torch.rsqrt(var + self.eps)
        return self.weight * rstd, self.bias - mean * self.weight * rstd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mode != "frozen":
            mean, var = self._batch_stats(x)
        else:
            mean, var = self.running_mean, self.running_var
        if self.lean:
            mul, add = (t.to(self.dtype)[:, None, None] for t in self._fold(mean, var))
            # One rounding of x*mul + add, as XLA's fused multiply-add gives.
            return torch.addcmul(add, x.to(self.dtype), mul)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(torch.float32) - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


def _no_rows(shape, *inputs: torch.Tensor) -> torch.Tensor:
    """The empty output of ``shape`` (its rows 0) of a layer on this rank,
    computed without the layer's op but tied to ``inputs``, so that autograd
    still runs the backward of every op before it (halos, BN's all-reduce),
    whose collectives the other ranks wait on. Its gradients are 0."""
    tie = sum(t.sum() for t in inputs) * 0
    return tie.expand(shape)


def _stage_rows(rows_in, kernel: int, stride: int, pad: int):
    return None if rows_in is None else conv_rows(rows_in, kernel, stride, pad)


class Conv(nn.Conv2d):
    """Bias-free conv with an fp32 master weight, cast to ``compute_dtype``
    on each call (a no-op once the weight is stored in that dtype, as in
    ``pose_net.inference_copy``). ``rows`` (``DataParallel.row_axis``): the
    input is this rank's rows of a stage of ``rows_in`` rows (default: the
    grid's ``input_rows``), and a kernel of more than one row or a stride
    of 2 takes its halo first (module docstring)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, compute_dtype, device=None,
                 rows: DataParallel | None = None, rows_in: int | None = None):
        super().__init__(
            cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
            dtype=torch.float32, device=device,
        )
        self.compute_dtype = compute_dtype
        self.rows = rows if kernel > 1 or stride > 1 else None
        self.rows_in = None if self.rows is None else (rows_in if rows_in is not None else rows.input_rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.compute_dtype)
        (k, kw), (s, sw), (p, pw) = self.kernel_size, self.stride, self.padding
        if self.rows is not None:
            x = halo_rows(x, self.rows_in, conv_needs(self.rows_in, k, s, p, self.rows.world), 0.0, self.rows)
        if x.shape[2] == 0:  # an empty shard (a 1x1 conv of stride 1 takes the rank's own rows)
            return _no_rows((x.shape[0], self.out_channels, 0, (x.shape[3] + 2 * pw - kw) // sw + 1), x, w)
        if self.rows is None:
            return self._conv_forward(x, w, None)
        return F.conv2d(x, w, None, self.stride, (0, pw))


def _conv(cin: int, cout: int, kernel: int, stride: int, dtype, device, dp: DataParallel | None = None,
          rows_in: int | None = None) -> Conv:
    return Conv(cin, cout, kernel, stride, dtype, device, dp.row_axis if dp is not None else None, rows_in)


def max_pool_rows(x: torch.Tensor, rows_in: int, rows: DataParallel) -> torch.Tensor:
    """The stem's 3x3/2 max-pool (padding 1) of this rank's rows of a stage
    of ``rows_in`` rows, its halo taken first (-inf past the image)."""
    x = halo_rows(x, rows_in, conv_needs(rows_in, 3, 2, 1, rows.world), float("-inf"), rows)
    if x.shape[2] == 0:
        return _no_rows((x.shape[0], x.shape[1], 0, (x.shape[3] - 1) // 2 + 1), x)
    return F.max_pool2d(x, 3, stride=2, padding=(0, 1))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) in channels_last -> its (B*H*W, C) rows, without a copy
    (``view`` raises if one would be needed)."""
    return t.permute(0, 2, 3, 1).view(-1, t.shape[1])


def _nchw(rows: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """(B*H*W, C) rows -> (B, C, H, W) in channels_last, a view."""
    return rows.view(b, h, w, -1).permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, dtype, bn_mode: str, device=None,
                 fused_1x1: bool = False, fused_conv3: bool = False, dp: DataParallel | None = None,
                 rows_in: int | None = None):
        # No 1x1 convs to fuse: the flags are accepted and ignored, as in JAX.
        super().__init__()
        self.rows_out = _stage_rows(rows_in, 3, stride, 1)
        bn = dict(device=device, dp=dp, rows=self.rows_out)
        self.conv1 = _conv(cin, features, 3, stride, dtype, device, dp, rows_in)
        self.bn1 = BN(features, bn_mode, dtype, **bn)
        self.conv2 = _conv(features, features, 3, 1, dtype, device, dp, self.rows_out)
        self.bn2 = BN(features, bn_mode, dtype, **bn)
        if stride != 1 or cin != features:
            self.down_conv = _conv(cin, features, 1, stride, dtype, device, dp, rows_in)
            self.down_bn = BN(features, bn_mode, dtype, **bn)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision v1.5 Bottleneck. In train mode with lean BN it routes as
    JAX's ``Bottleneck.__call__`` does: ``fused_conv3`` first (stride 1,
    ``conv_bn.profitable`` and ``conv_bn.supported``), then ``fused_1x1``
    (``matmul_bn.supported`` for conv1), else the plain path. The
    parameters and buffers are the same on every route. Data-parallel
    (world > 1) it never takes the conv3 route (JAX requires
    ``mesh.size == 1`` for it), and decides ``fused_1x1`` on the local rows,
    as JAX does, on ``m // nshard``: the global rows over the ranks that
    split them (the spatial peers hold one sample's rows in shares that may
    differ, so every peer decides on the same number and calls the same
    collectives)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, dtype, bn_mode: str, device=None,
                 fused_1x1: bool = False, fused_conv3: bool = False, dp: DataParallel | None = None,
                 rows_in: int | None = None):
        super().__init__()
        self.features, self.stride, self.bn_mode = features, stride, bn_mode
        self.fused_1x1, self.fused_conv3 = fused_1x1, fused_conv3
        self.world = 1 if dp is None else dp.world
        self.spatial = 1 if dp is None else dp.spatial
        self.rows_in, self.rows_out = rows_in, _stage_rows(rows_in, 3, stride, 1)
        out = features * 4
        bn = dict(device=device, dp=dp, rows=self.rows_out)
        self.conv1 = _conv(cin, features, 1, 1, dtype, device)
        self.bn1 = BN(features, bn_mode, dtype, device=device, dp=dp, rows=rows_in)
        self.conv2 = _conv(features, features, 3, stride, dtype, device, dp, rows_in)
        self.bn2 = BN(features, bn_mode, dtype, **bn)
        self.conv3 = _conv(features, out, 1, 1, dtype, device)
        self.bn3 = BN(out, bn_mode, dtype, **bn)
        if stride != 1 or cin != out:
            self.down_conv = _conv(cin, out, 1, stride, dtype, device, dp, rows_in)
            self.down_bn = BN(out, bn_mode, dtype, **bn)

    def _route(self, x: torch.Tensor) -> str:
        if self.bn_mode != "lean" or not self.training:
            return "plain"
        b, cin, h, w = x.shape
        e, itemsize = self.features, self.conv1.compute_dtype.itemsize
        if (self.fused_conv3 and self.world == 1 and self.stride == 1 and conv_bn.profitable(e, e)
                and conv_bn.supported(b, h, w, e, e, 1, itemsize)):
            return "conv3"
        m = b * (h if self.rows_in is None else self.rows_in) * w
        if self.fused_1x1 and m % self.spatial == 0 and matmul_bn.supported(m // self.spatial, cin, e, itemsize):
            return "1x1"
        return "plain"

    def forward(self, x):
        route = self._route(x)
        if route == "1x1":
            y = self._fused_1x1(x)
        elif route == "conv3":
            y = self._fused_conv3(x)
        else:
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
        residual = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        return F.relu(y + residual)

    def _fused_1x1(self, x):
        """JAX's ``_fused_call``: conv1 and conv3 as ``fused_matmul_bn``
        (conv3 with the bn2-apply + ReLU prologue), bn1/bn3 from the
        kernels' sums, bn2's sums from the conv2 output upcast to fp32.
        Returns bn3's output, before the residual."""
        dt = self.conv1.compute_dtype
        b, _, h, w = x.shape
        y1, s1, s2 = matmul_bn.fused_matmul_bn(_rows(x.to(dt)), self.conv1.weight.to(dt)[:, :, 0, 0].t())
        mul1, add1 = self.bn1.from_sums(s1, s2, b * w, h)
        a1 = torch.relu(torch.addcmul(add1.to(dt), y1, mul1.to(dt)))
        c2 = self.conv2(_nchw(a1, b, h, w))
        b2, _, h2, w2 = c2.shape
        c2f = c2.to(torch.float32)
        mul2, add2 = self.bn2.from_sums(c2f.sum((0, 2, 3)), (c2f * c2f).sum((0, 2, 3)), b2 * w2, h2)
        y3, s1, s2 = matmul_bn.fused_matmul_bn(
            _rows(c2), self.conv3.weight.to(dt)[:, :, 0, 0].t(), mul2, add2
        )
        mul3, add3 = self.bn3.from_sums(s1, s2, b2 * w2, h2)
        return _nchw(torch.addcmul(add3.to(dt), y3, mul3.to(dt)), b2, h2, w2)

    def _fused_conv3(self, x):
        """JAX's ``_fused3_call``: conv2 as ``fused_conv3x3_bn`` with the
        bn1-apply + ReLU prologue, bn1's sums from the conv1 output upcast
        to fp32, bn2 from the kernel's sums; conv3 and bn3 plain. Returns
        bn3's output, before the residual."""
        dt = self.conv1.compute_dtype
        b, _, h, w = x.shape
        c1 = self.conv1(x)
        c1f = c1.to(torch.float32)
        mul1, add1 = self.bn1.from_sums(c1f.sum((0, 2, 3)), (c1f * c1f).sum((0, 2, 3)), b * w, h)
        c2, s1, s2 = conv_bn.fused_conv3x3_bn(
            c1.permute(0, 2, 3, 1), self.conv2.weight.to(dt).permute(2, 3, 1, 0), mul1, add1
        )
        mul2, add2 = self.bn2.from_sums(s1, s2, b * w, h)
        a2 = torch.relu(torch.addcmul(add2.to(dt), c2, mul2.to(dt)))
        return self.bn3(self.conv3(a2.permute(0, 3, 1, 2)))


class S2DStem(Conv):
    """The stem as JAX's ``s2d_stem`` computes it: space-to-depth 2 (channel
    ``(py * 2 + px) * C + c`` of a half-size image holds pixel (2y + py,
    2x + px) of channel c), then a 4x4 stride-1 conv on the 4C channels,
    padded 2 above and left and 1 below and right. With weights from
    ``s2d_stem_kernel`` it equals the 7x7 stride-2 stem exactly. An fp32
    master weight (64, 4C, 4, 4), cast to ``compute_dtype`` on each call.

    ``rows``: the input is this rank's rows of images of ``rows_in`` rows
    (even, as JAX's reshape needs). For its output rows [a, b) a rank
    takes image rows [2a - 4, 2b + 2) (``mesh.s2d_needs``, zeros past the
    image), whose first is even, so the local block pairs rows as the whole
    image does; then the conv runs without padding in H."""

    def __init__(self, cin: int, cout: int, compute_dtype, device=None,
                 rows: DataParallel | None = None, rows_in: int | None = None):
        super().__init__(4 * cin, cout, 4, 1, compute_dtype, device, rows, rows_in)
        if self.rows is not None and self.rows_in % 2:
            raise ValueError(f"s2d_stem needs an even input height, not {self.rows_in}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.compute_dtype)
        pad = (2, 1, 2, 1)
        if self.rows is not None:
            x = halo_rows(x, self.rows_in, s2d_needs(self.rows_in, self.rows.world), 0.0, self.rows)
            if x.shape[2] == 0:
                return _no_rows((x.shape[0], self.out_channels, 0, x.shape[3] // 2), x, w)
            pad = (2, 1, 0, 0)
        b, c, h, wd = x.shape
        x = x.reshape(b, c, h // 2, 2, wd // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, wd // 2)
        x = F.pad(x.contiguous(memory_format=torch.channels_last), pad)
        return F.conv2d(x, w)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """A torch (F, C, 7, 7) stride-2 stem weight -> the exact (F, 4C, 4, 4)
    weight of ``S2DStem`` (the port's copy of JAX's ``s2d_stem_kernel``, in
    torch's layout): tap u of the 7x7 lands on tap (u - 3) // 2 + 2 of the
    4x4, in the channel block of phase (u - 3) mod 2; unused taps stay 0."""
    f, c, k, _ = w7.shape
    if k != 7:
        raise ValueError(f"s2d_stem_kernel takes a 7x7 stem, not {tuple(w7.shape)}")
    out = w7.new_zeros(f, 4 * c, 4, 4)
    for u in range(7):
        a, py = (u - 3) // 2 + 2, (u - 3) % 2
        for v in range(7):
            bb, px = (v - 3) // 2 + 2, (v - 3) % 2
            out[:, (py * 2 + px) * c:(py * 2 + px + 1) * c, a, bb] = w7[:, :, u, v]
    return out


REMAT_POLICIES = ("full", "conv_outs")

_CONV_OPS = (torch.ops.aten.convolution.default,)


def _save_conv_outs(ctx, op, *args, **kwargs):
    """``conv_outs``'s policy: keep every conv's output, recompute the rest
    (JAX's ``save_only_these_names("conv_out")``)."""
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _CONV_OPS else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class ResNetBackbone(nn.Module):
    """(B, 3, H, W) image -> (B, C, H/32, W/32) features, C = 512 for
    ResNet-18/34 and 2048 for 50/101/152.

    ``s2d_stem``: the stem is ``S2DStem`` (JAX's space-to-depth stem, conv1
    of shape (64, 12, 4, 4)). ``block_remat`` (JAX's ``nn.remat`` of each
    block): with gradients on, each residual block runs under
    ``torch.utils.checkpoint`` (non-reentrant), its forward recomputed in
    the backward; ``remat_policy`` ``"full"`` keeps only the block's input,
    ``"conv_outs"`` (selective checkpointing) also every cuDNN conv's output
    and recomputes the rest (BN, ReLU; a fused route's kernels run again).
    The recompute leaves BN's running statistics alone (``recomputing``);
    its collectives (BN's all-reduce, halos) run again in the backward on
    every rank, block by block in the same order."""

    def __init__(self, resnet_type: int, dtype: torch.dtype, bn_mode: str, device=None,
                 fused_1x1: bool = False, fused_conv3: bool = False, dp: DataParallel | None = None,
                 s2d_stem: bool = False, block_remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        if resnet_type not in RESNET_SPECS:
            raise ValueError(f"resnet_type {resnet_type} not in {sorted(RESNET_SPECS)}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; use one of {REMAT_POLICIES}")
        kind, depths, expansion = RESNET_SPECS[resnet_type]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.dtype = dtype
        self.out_features = 512 * expansion
        self.block_remat, self.remat_policy = block_remat, remat_policy
        self.rows = dp.row_axis if dp is not None else None
        # The global rows of each stage on a spatial grid (None: whole images).
        r = self.rows.input_rows if self.rows is not None else None
        if s2d_stem:
            self.conv1 = S2DStem(3, 64, dtype, device, self.rows, r)
        else:
            self.conv1 = _conv(3, 64, 7, 2, dtype, device, dp, r)
        self.pool_rows = _stage_rows(r, 7, 2, 3)
        self.bn1 = BN(64, bn_mode, dtype, device=device, dp=dp, rows=self.pool_rows)
        r = _stage_rows(self.pool_rows, 3, 2, 1)
        self.block_names = []
        cin = 64
        for stage, (width, depth) in enumerate(zip(_STAGE_WIDTHS, depths)):
            for i in range(depth):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                block = block_cls(cin, width, stride, dtype, bn_mode, device, fused_1x1, fused_conv3, dp, r)
                self.add_module(name, block)
                self.block_names.append(name)
                cin, r = width * expansion, block.rows_out
        self.rows_out = r

    def _remat_contexts(self):
        if self.remat_policy == "conv_outs":
            fwd, rec = ckpt.create_selective_checkpoint_contexts(_save_conv_outs)
            return fwd, recomputing(rec)
        return contextlib.nullcontext(), recomputing()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        if self.rows is None:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        else:
            x = max_pool_rows(x, self.pool_rows, self.rows)
        remat = self.block_remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = ckpt.checkpoint(block, x, use_reentrant=False, context_fn=self._remat_contexts) if remat else block(x)
        return x
