"""Data parallelism over ``torch.distributed``, counterpart of
``ihpr_tpu.parallel.mesh`` (``make_mesh``'s data axis).

One rank is one process on one device, the counterpart of one JAX process.
Parameters are replicated on every rank and each rank takes its rows of the
global batch (``data/pipeline.py``); gradients are summed by
``DistributedDataParallel`` (``parallel/train_step.py``), and BatchNorm's
statistics by ``AllReduceSum`` over the group (``models/resnet.py:BN``), so
a step on W ranks is the step of one process on the global batch, as under
JAX's mesh. The ``spatial`` axis (GSPMD halo exchanges) is not ported.

A ``DataParallel`` of world 1 and no group is one process: nothing here then
runs a collective.
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
    """This process's place on the data axis: ``rank`` of ``world``, and the
    process group the collectives run on (None on one process)."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None

    def __deepcopy__(self, memo):
        # The group is a handle on this process's communicator: a copied
        # model (``pose_net.inference_copy``) shares it.
        return self


SINGLE = DataParallel()


def data_parallel(cfg=None) -> DataParallel:
    """The default process group as a ``DataParallel``, or ``SINGLE`` when
    none is initialized. ``cfg.parallel.data_axis_size`` None means the world
    size; any other value must equal it. ``spatial_axis_size > 1`` raises."""
    par = cfg.parallel if cfg is not None else None
    if par is not None and par.spatial_axis_size > 1:
        raise NotImplementedError("spatial_axis_size > 1 (--spatial) is not ported to ihpr_tpu_torch")
    if dist.is_available() and dist.is_initialized():
        dp = DataParallel(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    else:
        dp = SINGLE
    if par is not None and par.data_axis_size is not None and par.data_axis_size != dp.world:
        raise ValueError(
            f"parallel.data_axis_size={par.data_axis_size}, but the process group has "
            f"{dp.world} rank(s)"
        )
    return dp


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
    local = x.to(comm_device(dp)).contiguous()
    parts = [torch.empty_like(local) for _ in range(dp.world)]
    dist.all_gather(parts, local, group=dp.group)
    return torch.cat(parts).to(x.device)


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
