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
  the same samples and each keeps rows [s*H/S, (s+1)*H/S) of every image.
  Each conv, the max-pool and each deconv first take their neighbours'
  boundary rows (``halo_rows``, the halo exchanges GSPMD inserts under JAX),
  and the integral merges the peers' softmax statistics
  (``ops/integral_volume.py:soft_argmax_row_shards``). Each rank then holds
  its rows' share of every parameter gradient: DDP sums them over the world
  and divides by D, not W (``train_step._ddp``). BN needs no change: its
  count is the local count times the world, the global (B, H, W) count.

A ``DataParallel`` of world 1 and no group is one process: nothing here then
runs a collective. ``spatial == 1`` runs the data-parallel code alone and
creates no group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

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
    spatial index). A group of one rank is None."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    spatial: int = 1
    spatial_group: Optional[Any] = None
    data_group: Optional[Any] = None

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
        return DataParallel(self.rank % self.spatial, self.spatial, self.spatial_group)


SINGLE = DataParallel()


def check_row_shards(spatial: int, world: int, input_rows: int):
    """Raise ValueError unless a D x ``spatial`` grid of ``world`` ranks
    splits every stage's rows of a ``input_rows``-row image evenly: S must
    divide the world and the rows at stride 32, so every stride-2 layer's
    local rows start on an even global row. JAX also takes uneven shards
    (GSPMD pads them); the port does not yet."""
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial_axis_size={spatial} does not divide the {world} rank(s)")
    if spatial > 1 and (input_rows % 32 or (input_rows // 32) % spatial):
        raise ValueError(
            f"spatial_axis_size={spatial} gives uneven row shards of a {input_rows}-row input: "
            f"the rows at stride 32 ({input_rows / 32:g}) must split evenly over the {spatial} ranks"
        )


def make_grid(dp: DataParallel, spatial: int, input_rows: int) -> DataParallel:
    """``dp`` (the world) as a D x ``spatial`` grid (``check_row_shards``).
    Creates one spatial group per data index, then one data group per
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
    return DataParallel(dp.rank, dp.world, dp.group, spatial, spatial_group, data_group)


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
    """This rank's rows [s*H/S, (s+1)*H/S) of (B, H, W, C) images, contiguous
    (``rows``: ``DataParallel.row_axis``); the images when None."""
    if rows is None:
        return image
    h = image.shape[1] // rows.world
    return image[:, rows.rank * h : (rows.rank + 1) * h].contiguous()


class HaloRows(torch.autograd.Function):
    """(B, C, h, W) rows of one spatial rank -> (B, C, above + h + below, W):
    the last ``above`` rows of the rank before it on top, the first
    ``below`` rows of the rank after it below, ``fill`` past the image's
    first and last rows. One all-gather of every rank's boundary rows over
    the spatial group (gloo and NCCL both take it). The backward is the
    adjoint: each halo row's gradient goes back to the rank that owns the
    row and is added to that row's gradient, by one all-gather too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, above: int, below: int, fill: float, rows: DataParallel):
        ctx.above, ctx.below, ctx.rows = above, below, rows
        h, s, n = x.shape[2], rows.rank, rows.world
        # NHWC order, contiguous for a channels_last x: what the ranks around
        # this one need of it, its first `below` rows and its last `above`.
        nhwc = x.permute(0, 2, 3, 1)
        parts = _gathered(torch.cat([nhwc[:, :below], nhwc[:, h - above:]], dim=1), rows)
        edge = torch.full_like(nhwc[:, :1], fill)
        top = parts[s - 1][:, below:].to(x.device) if s > 0 else edge.expand(-1, above, -1, -1)
        bottom = parts[s + 1][:, :below].to(x.device) if s < n - 1 else edge.expand(-1, below, -1, -1)
        return torch.cat([top, nhwc, bottom], dim=1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        above, below, rows = ctx.above, ctx.below, ctx.rows
        h, s, n = g.shape[2] - above - below, rows.rank, rows.world
        g = g.permute(0, 2, 3, 1)
        dx = g[:, above:above + h].clone()
        # The gradients of this rank's halo rows: of the rank before it's last
        # `above` rows, and of the rank after it's first `below` rows.
        parts = _gathered(torch.cat([g[:, :above], g[:, above + h:]], dim=1), rows)
        if s > 0:
            dx[:, :below] += parts[s - 1][:, above:].to(dx.device)
        if s < n - 1:
            dx[:, h - above:] += parts[s + 1][:, :above].to(dx.device)
        return dx.permute(0, 3, 1, 2), None, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, fill: float, rows: DataParallel) -> torch.Tensor:
    """``HaloRows``: x with ``above`` rows of the rank before it and
    ``below`` of the rank after it, differentiably."""
    return HaloRows.apply(x, above, below, fill, rows)


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
