"""Data and spatial parallelism over ``torch.distributed``, counterpart of
``ihpr_tpu.parallel.mesh`` (``make_mesh``'s ``(data, spatial)`` grid).

One rank is one process on one device, the counterpart of one JAX device.
Parameters are replicated on every rank. The W ranks form a D x S grid:
rank r sits at data index r // S and spatial index r % S (spatial is the
minor axis, as in JAX's ``grid.reshape(data, spatial)``).

- Along the data axis each rank takes its samples of the global batch
  (``data/pipeline.py``); gradients are reduced by
  ``DistributedDataParallel`` (``parallel/train_step.py``), and BatchNorm's
  statistics by ``AllReduceSum`` over the world (``models/resnet.py:BN``),
  so a step on W ranks is the step of one process on the global batch.
- Along the spatial axis (``spatial > 1``) the S peers of a data index load
  the same samples and each keeps its rows of every image and of every
  stage after it, in GSPMD's layout (``row_range``: blocks of ceil(R / S)
  rows in rank order, so the last ranks' blocks may be short or empty).
  Each conv of more than one row or of stride 2, the max-pool and each
  deconv first take the rows their windows read from other ranks
  (``halo_rows``, the halo exchanges GSPMD inserts under JAX), and the
  integral merges the peers' softmax statistics
  (``ops/integral_volume.py:soft_argmax_row_shards``). Each rank then holds
  its rows' share of every parameter gradient: DDP sums them over the world
  and divides by D, not W (``train_step._ddp``). BN sums its ranks' row
  counts with its statistics, so its count is the global (B, H, W) count
  however the rows split.

A ``DataParallel`` of world 1 and no group is one process: nothing here then
runs a collective. ``spatial == 1`` runs the data-parallel code alone and
creates no group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the grid: ``rank`` of ``world``, the process
    group of the whole world (None on one process), and the spatial axis:
    ``spatial`` = S ranks split each sample's rows, ``spatial_group`` holds
    this rank's S peers (its data index), ``data_group`` its D peers (its
    spatial index), ``input_rows`` the rows of the images the grid splits
    (every later stage's rows follow from it). A group of one rank is
    None."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    spatial: int = 1
    spatial_group: Optional[Any] = None
    data_group: Optional[Any] = None
    input_rows: Optional[int] = None

    def __deepcopy__(self, memo):
        # The group is a handle on this process's communicator: a copied
        # model (``pose_net.inference_copy``) shares it.
        return self

    @property
    def data_axis(self) -> "DataParallel":
        """The data axis alone: data index of D over ``data_group``. The
        loader, the aug draw, the metrics and the Tester's gather use it.
        Itself when S is 1."""
        if self.spatial == 1:
            return self
        return DataParallel(self.rank // self.spatial, self.world // self.spatial, self.data_group)

    @property
    def row_axis(self) -> Optional["DataParallel"]:
        """The spatial axis alone: spatial index of S over
        ``spatial_group``, or None when S is 1 (whole images)."""
        if self.spatial == 1:
            return None
        return DataParallel(self.rank % self.spatial, self.spatial, self.spatial_group,
                            input_rows=self.input_rows)


SINGLE = DataParallel()


def check_row_shards(spatial: int, world: int, input_rows: int):
    """Raise ValueError unless ``world`` ranks form a D x ``spatial`` grid:
    S must divide the world, as JAX's ``make_mesh`` requires. Any
    ``input_rows`` splits: where S does not divide a stage's rows, its
    last ranks hold shorter blocks or none (``row_range``), as GSPMD pads
    them."""
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial_axis_size={spatial} does not divide the {world} rank(s)")
    if input_rows < 1:
        raise ValueError(f"an input of {input_rows} rows has nothing to split")


def row_range(rows: int, rank: int, world: int) -> Tuple[int, int]:
    """The global rows [lo, hi) that spatial rank ``rank`` of ``world``
    holds of a stage of ``rows`` rows: GSPMD's layout, blocks of
    ceil(rows / world) rows in rank order, the last ones short or empty
    (lo == hi == rows)."""
    block = -(-rows // world)
    return min(rank * block, rows), min((rank + 1) * block, rows)


def conv_rows(rows: int, kernel: int, stride: int, pad: int) -> int:
    """Output rows of a conv (or max-pool) over ``rows`` input rows."""
    return (rows + 2 * pad - kernel) // stride + 1


def conv_needs(rows_in: int, kernel: int, stride: int, pad: int, world: int) -> Tuple[Tuple[int, int], ...]:
    """For each rank, the input rows [lo, hi) a conv's output rows on that
    rank read (``row_range`` of the output): [stride*a - pad,
    stride*(b-1) - pad + kernel) for output rows [a, b), empty where the
    rank has no output rows. Rows outside [0, rows_in) are padding."""
    rows_out = conv_rows(rows_in, kernel, stride, pad)
    needs = []
    for r in range(world):
        a, b = row_range(rows_out, r, world)
        needs.append((stride * a - pad, stride * (b - 1) - pad + kernel) if b > a else (0, 0))
    return tuple(needs)


def deconv_needs(rows_in: int, world: int) -> Tuple[Tuple[int, int], ...]:
    """For each rank, the input rows [lo, hi) a ConvTranspose2d(4, stride 2,
    padding 1)'s output rows on that rank (``row_range`` of the 2 *
    rows_in output rows) receive taps from: output row o sums input rows
    ceil((o - 2) / 2) ... floor((o + 1) / 2)."""
    needs = []
    for r in range(world):
        a, b = row_range(2 * rows_in, r, world)
        needs.append(((a - 1) // 2, b // 2 + 1) if b > a else (0, 0))
    return tuple(needs)


def s2d_needs(rows_in: int, world: int) -> Tuple[Tuple[int, int], ...]:
    """For each rank, the image rows [lo, hi) the space-to-depth stem's
    output rows on that rank (``row_range`` of the rows_in / 2 output rows)
    read: output rows [a, b) take space-to-depth rows [a - 2, b + 1) (the
    4x4 conv's padding of 2 above and 1 below), image rows [2a - 4, 2b + 2),
    whose first is even."""
    needs = []
    for r in range(world):
        a, b = row_range(rows_in // 2, r, world)
        needs.append((2 * a - 4, 2 * b + 2) if b > a else (0, 0))
    return tuple(needs)


def make_grid(dp: DataParallel, spatial: int, input_rows: int) -> DataParallel:
    """``dp`` (the world) as a D x ``spatial`` grid (``check_row_shards``)
    of images of ``input_rows`` rows. Creates one spatial group per data index, then one data group per
    spatial index (``dist.new_group``, which every rank must call alike:
    call this on every rank at the same point). ``spatial`` 1 returns
    ``dp``; ``spatial`` equal to the world uses the world's group for the
    rows and creates none."""
    check_row_shards(spatial, dp.world, input_rows)
    if spatial == 1:
        return dp
    d = dp.world // spatial
    spatial_group = data_group = None
    if d == 1:
        spatial_group = dp.group
    else:
        for i in range(d):
            g = dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
            if i == dp.rank // spatial:
                spatial_group = g
        for j in range(spatial):
            g = dist.new_group(list(range(j, dp.world, spatial)))
            if j == dp.rank % spatial:
                data_group = g
    return DataParallel(dp.rank, dp.world, dp.group, spatial, spatial_group, data_group, input_rows)


def data_parallel(cfg=None) -> DataParallel:
    """The default process group as a ``DataParallel``, or ``SINGLE`` when
    none is initialized, made a grid of ``cfg.parallel.spatial_axis_size``
    (``make_grid``: every rank must call it alike). ``data_axis_size`` None
    means the world size over S; any other value must equal it."""
    par = cfg.parallel if cfg is not None else None
    if dist.is_available() and dist.is_initialized():
        dp = DataParallel(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    else:
        dp = SINGLE
    if par is None:
        return dp
    grid = make_grid(dp, par.spatial_axis_size, cfg.data.input_shape[0])
    if par.data_axis_size is not None and par.data_axis_size != grid.data_axis.world:
        raise ValueError(
            f"parallel.data_axis_size={par.data_axis_size}, but the process group has "
            f"{dp.world} rank(s) over spatial_axis_size={par.spatial_axis_size}"
        )
    return grid


def init_process_group(
    device_type: str = "cuda",
    rank: Optional[int] = None,
    world: Optional[int] = None,
    store=None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the default process group and return this rank's device.

    Without ``rank`` / ``world`` / ``store`` it reads torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``). The backend is NCCL on ``cuda:LOCAL_RANK`` and gloo on
    the CPU unless ``backend`` says otherwise; gloo on CUDA tensors (several
    ranks on one card) maps ``LOCAL_RANK`` onto the cards there are, since
    NCCL refuses two ranks on one device."""
    if rank is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        index = local if backend == "nccl" else local % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    kw = {} if store is None else {"store": store}
    dist.init_process_group(backend, rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    return device


def comm_device(dp: DataParallel) -> torch.device:
    """Where a tensor made for a collective must live: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend(dp.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group`` whose backward is the same sum: each
    rank's gradient of the summed tensor is the sum of every rank's. A plain
    ``dist.all_reduce`` carries no gradient, so sync-BN's weight gradients
    would miss the other ranks' terms without an error."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (``AllReduceSum``)."""
    return AllReduceSum.apply(x, dp.group)


def all_gather_rows(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0
    in rank order, on every rank, on ``x``'s device; ``x`` itself on one
    process. The gather runs on ``comm_device`` (gloo gathers host tensors)."""
    if dp.group is None:
        return x
    return torch.cat(_gathered(x, dp)).to(x.device)


def _gathered(x: torch.Tensor, dp: DataParallel) -> list:
    """Every rank's ``x`` (one shape on all) in rank order, on ``comm_device``."""
    local = x.to(comm_device(dp)).contiguous()
    parts = [torch.empty_like(local) for _ in range(dp.world)]
    dist.all_gather(parts, local, group=dp.group)
    return parts


def row_shard(image: torch.Tensor, rows: Optional[DataParallel]) -> torch.Tensor:
    """This rank's rows (``row_range``) of (B, H, W, C) images, contiguous
    (``rows``: ``DataParallel.row_axis``); the images when None."""
    if rows is None:
        return image
    lo, hi = row_range(image.shape[1], rows.rank, rows.world)
    return image[:, lo:hi].contiguous()


def _span(lo: int, hi: int) -> Tuple[int, int]:
    return (lo, max(lo, hi))


def _cap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    return _span(max(a[0], b[0]), min(a[1], b[1]))


def _hull(spans) -> Tuple[int, int]:
    spans = [s for s in spans if s[1] > s[0]]
    return (min(s[0] for s in spans), max(s[1] for s in spans)) if spans else (0, 0)


def halo_plan(rows_in: int, needs: Tuple[Tuple[int, int], ...]) -> dict:
    """What each of the ``len(needs)`` ranks sends and takes when rank r
    needs input rows ``needs[r]`` of a stage of ``rows_in`` rows laid out
    by ``row_range``. Every rank computes the same plan, so each knows
    where every row it takes sits in the gathered buffers:

    - ``own[r]``: the rows r holds; ``above[r]`` / ``below[r]``: the rows
      of ``needs[r]`` that ranks before / after r hold (in the image);
    - ``to_before[r]`` / ``to_after[r]``: the rows of ``own[r]`` that some
      rank before / after r needs (the hull of their ``below`` /
      ``above`` within ``own[r]``), the forward's two pieces, each padded
      to its largest over the ranks (``pad_before``, ``pad_after``);
    - ``pad_above`` / ``pad_below``: the largest ``above`` / ``below``,
      the padded pieces of the backward, which sends each rank's halo
      rows' gradients back to their owners."""
    world = len(needs)
    own = [row_range(rows_in, r, world) for r in range(world)]
    above = [_cap(n, (0, own[r][0])) if n[1] > n[0] else (0, 0) for r, n in enumerate(needs)]
    below = [_cap(n, (own[r][1], rows_in)) if n[1] > n[0] else (0, 0) for r, n in enumerate(needs)]
    to_before = [_hull(_cap(below[q], own[r]) for q in range(r)) for r in range(world)]
    to_after = [_hull(_cap(above[q], own[r]) for q in range(r + 1, world)) for r in range(world)]
    size = lambda spans: max(s[1] - s[0] for s in spans)
    return dict(own=own, above=above, below=below, to_before=to_before, to_after=to_after,
                pad_before=size(to_before), pad_after=size(to_after), pad_above=size(above),
                pad_below=size(below))


def _rows_nhwc(t: torch.Tensor, lo: int, hi: int, pad: int) -> torch.Tensor:
    """Rows [lo, hi) of NHWC ``t`` followed by zero rows up to ``pad``."""
    part = t[:, lo:hi]
    if hi - lo == pad:
        return part
    return torch.cat([part, part.new_zeros((t.shape[0], pad - (hi - lo)) + tuple(t.shape[2:]))], dim=1)


class HaloRows(torch.autograd.Function):
    """(B, C, h, W) rows of one spatial rank (its ``row_range`` of a stage of
    ``rows_in`` rows) -> (B, C, hi - lo, W): the rows [lo, hi) =
    ``needs[rank]`` of the whole stage, ``fill`` where they lie past the
    image's first or last row. Each rank sends the rows of its own that
    ranks before it need and those that ranks after it need, padded to a
    common size, in one all-gather over the spatial group (gloo and NCCL
    both take it); with no rank needing another's rows it sends nothing.
    The backward is the adjoint: each halo row's gradient goes back to the
    rank that owns the row and is added to that row's gradient, by one
    all-gather too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, rows_in: int, needs: Tuple[Tuple[int, int], ...], fill: float,
                rows: DataParallel):
        plan = halo_plan(rows_in, needs)
        s, n = rows.rank, rows.world
        (own_lo, own_hi), (lo, hi) = plan["own"][s], needs[s]
        if x.shape[2] != own_hi - own_lo:
            raise ValueError(f"rank {s} holds {x.shape[2]} rows of a {rows_in}-row stage: "
                             f"expected rows [{own_lo}, {own_hi})")
        ctx.rows_in, ctx.needs, ctx.rows = rows_in, needs, rows
        nhwc = x.permute(0, 2, 3, 1)
        pieces = []
        pb, pa = plan["pad_before"], plan["pad_after"]
        if pb + pa:
            (b0, b1), (a0, a1) = plan["to_before"][s], plan["to_after"][s]
            send = torch.cat([_rows_nhwc(nhwc, b0 - own_lo, b1 - own_lo, pb),
                              _rows_nhwc(nhwc, a0 - own_lo, a1 - own_lo, pa)], dim=1)
            parts = _gathered(send, rows)
        edge = nhwc.new_full((nhwc.shape[0], 1) + tuple(nhwc.shape[2:]), fill)
        if min(hi, 0) > lo:
            pieces.append(edge.expand(-1, min(hi, 0) - lo, -1, -1))
        for q in range(n):  # the rows above this rank's, from the ranks before it
            if q == s:
                m0, m1 = _cap((lo, hi), (own_lo, own_hi))
                pieces.append(nhwc[:, m0 - own_lo:m1 - own_lo])
                continue
            span = _cap(plan["above"][s] if q < s else plan["below"][s], plan["own"][q])
            if span[1] > span[0]:
                base, off = (plan["to_after"][q][0], pb) if q < s else (plan["to_before"][q][0], 0)
                pieces.append(parts[q][:, off + span[0] - base:off + span[1] - base].to(x.device))
        if hi > max(lo, rows_in):
            pieces.append(edge.expand(-1, hi - max(lo, rows_in), -1, -1))
        out = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        plan = halo_plan(ctx.rows_in, ctx.needs)
        s, n, rows = ctx.rows.rank, ctx.rows.world, ctx.rows
        (own_lo, own_hi), (lo, hi) = plan["own"][s], ctx.needs[s]
        g = g.permute(0, 2, 3, 1)
        m0, m1 = _cap((lo, hi), (own_lo, own_hi))
        dx = g.new_zeros((g.shape[0], own_hi - own_lo) + tuple(g.shape[2:]))
        if m1 > m0:
            dx[:, m0 - own_lo:m1 - own_lo] += g[:, m0 - lo:m1 - lo]
        pu, pd = plan["pad_above"], plan["pad_below"]
        if pu + pd:
            (u0, u1), (d0, d1) = plan["above"][s], plan["below"][s]
            send = torch.cat([_rows_nhwc(g, u0 - lo, u1 - lo, pu), _rows_nhwc(g, d0 - lo, d1 - lo, pd)], dim=1)
            parts = _gathered(send, rows)
            for q in range(n):  # the gradients of this rank's rows that rank q took
                if q == s:
                    continue
                span = _cap(plan["below"][q] if q < s else plan["above"][q], (own_lo, own_hi))
                if span[1] > span[0]:
                    base, off = (plan["below"][q][0], pu) if q < s else (plan["above"][q][0], 0)
                    dx[:, span[0] - own_lo:span[1] - own_lo] += \
                        parts[q][:, off + span[0] - base:off + span[1] - base].to(dx.device)
        return dx.permute(0, 3, 1, 2), None, None, None, None


def halo_rows(x: torch.Tensor, rows_in: int, needs: Sequence[Tuple[int, int]], fill: float,
              rows: DataParallel) -> torch.Tensor:
    """``HaloRows``: this rank's rows ``needs[rows.rank]`` of a stage of
    ``rows_in`` rows (``conv_needs``, ``deconv_needs``), differentiably."""
    return HaloRows.apply(x, rows_in, tuple(tuple(n) for n in needs), fill, rows)


def any_rank(flag: bool, dp: DataParallel) -> bool:
    """True on every rank when ``flag`` is True on any (an all-reduce MAX).
    Every rank must call it at the same point."""
    if dp.group is None:
        return bool(flag)
    t = torch.tensor([int(flag)], device=comm_device(dp))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.group)
    return bool(t.item())


def barrier(dp: DataParallel):
    """Wait for every rank (nothing on one process)."""
    if dp.group is not None:
        dist.barrier(group=dp.group)
