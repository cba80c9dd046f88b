"""The train and eval steps, counterpart of ``ihpr_tpu.parallel.train_step``.

One step: ``finalize_patch`` on the host-warped uint8 patch (colour scale,
clip, ImageNet normalize), or ``make_patch_batch``'s warp and augmentation
on the device for a canvas batch, ``PoseNet.coords`` in train mode (batch-stat BN;
the fused head op runs K1 forward and K2 backward on the card), the masked
L1 loss, ``backward()``, and Adam with the step-decay schedule. The forward
and the backward both run inside the model's precision scope, so a
``"highest"`` config has no TF32 anywhere in the step.

Optimizer semantics are optax's (``make_optimizer`` in the JAX package):
``clip_by_global_norm`` before Adam, Adam with b1 0.9, b2 0.999, eps 1e-8,
and ``add_decayed_weights(-wd)`` after it, which subtracts ``wd * p`` from
every parameter *without* the learning rate. The learning rate of update k
(counted from 0) is the schedule at k: ``piecewise_constant_schedule``
scales apply at ``count >= boundary``.

Data-parallel (``dp`` with a process group, ``parallel/mesh.py``), the step
runs the model through one ``DistributedDataParallel`` per model, which
averages the gradients over the ranks; the loss is the mean over B*J*3, so
the average of the ranks' local means is the global loss, as under JAX's
mesh. ``cfg.parallel.shard_opt_state`` is ZeRO-1 (JAX's ``state_shardings``
with ``shard_opt_state=True``): ``ZeroOptaxAdam`` keeps the Adam moments of
each rank's share of the parameters there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from torch.optim.lr_scheduler import LambdaLR

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.augment import (
    PatchBatch,
    finalize_patch,
    no_aug_params,
    patch_batch_from_params,
    sample_aug_params,
)
from ihpr_tpu_torch.models.pose_net import PoseNet
from ihpr_tpu_torch.ops.loss import (
    components_from_sums,
    joint_location_loss,
    joint_location_loss_components,
    joint_location_loss_sums,
)
from ihpr_tpu_torch.parallel.mesh import DataParallel


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """count -> learning rate: ``cfg.optim.lr`` times every scale whose
    boundary is <= count (reference ``common/base.py:set_lr``). Boundaries
    are built as the JAX package builds optax's ``boundaries_and_scales``,
    one entry per distinct step."""
    bounds = sorted(
        {int(e * steps_per_epoch): 1.0 / cfg.optim.lr_dec_factor for e in cfg.optim.lr_dec_epoch}.items()
    )

    def schedule(count: int) -> float:
        lr = cfg.optim.lr
        for boundary, scale in bounds:
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


def _clip_by_global_norm_(grads: List[torch.Tensor], clip_norm: float):
    """optax ``clip_by_global_norm``: g if |g| < clip else g / |g| * clip,
    in place, without a host sync."""
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    torch._foreach_mul_(grads, torch.where(norm < clip_norm, 1.0, clip_norm / norm))


class OptaxAdam(torch.optim.Adam):
    """``torch.optim.Adam`` with optax's chain around it:
    ``clip_by_global_norm(clip_norm)`` on the gradients first, and
    ``add_decayed_weights(-weight_decay)`` after: ``p += adam_update -
    weight_decay * p``, not scaled by the learning rate (neither torch's L2
    ``weight_decay`` nor AdamW's decoupled one). The decay is applied before
    the Adam update, which equals optax's order because Adam's update does
    not depend on p."""

    def __init__(self, params, lr: float, clip_norm: float | None = None, weight_decay: float = 0.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.clip_norm = clip_norm
        self.decay = weight_decay

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for grp in self.param_groups for p in grp["params"] if p.grad is not None]

    def global_norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient (optax ``global_norm``)."""
        return torch.nn.utils.get_total_norm(self._grads(), norm_type=2.0)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam.step takes no closure")
        if self.clip_norm:
            _clip_by_global_norm_(self._grads(), self.clip_norm)
        if self.decay:
            params = [p for grp in self.param_groups for p in grp["params"] if p.grad is not None]
            torch._foreach_mul_(params, 1.0 - self.decay)
        return super().step()


@functools.cache
def zero_optax_adam() -> type:
    """The class ``ZeroOptaxAdam``, made at first use: importing
    ``torch.distributed.optim`` takes seconds (it imports FSDP), which every
    process of the port would pay at import."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    class ZeroOptaxAdam(ZeroRedundancyOptimizer):
        """ZeRO-1 over ``OptaxAdam``: each rank keeps the Adam moments of its
        share of the parameters, steps them, and the updated parameters are
        broadcast from their owners.

        - The clip uses the global norm of every gradient (all of them, reduced
          by DDP), taken here before the sharded step: an inner ``OptaxAdam``
          with ``clip_norm`` would clip by its own shard's norm. The decay stays
          in the inner optimizers, per shard.
        - The inner optimizers get the decay through ``functools.partial``, not
          as a ZeRO default: ZeRO copies its defaults into the inner param
          groups, where ``weight_decay`` would turn on torch Adam's L2 term.
        - The learning rate is set on this optimizer's param groups (the
          ``LambdaLR``), which ZeRO copies into the inner ones at each step.
        - ``state_dict`` (after ``consolidate_state_dict``, a collective) and
          ``load_state_dict`` use ``OptaxAdam``'s single-process format, so a
          snapshot resumes with or without ZeRO, on any world size."""

        def __init__(self, params, lr: float, clip_norm: float | None, weight_decay: float, group):
            super().__init__(
                params, functools.partial(OptaxAdam, weight_decay=weight_decay), process_group=group, lr=lr
            )
            self.clip_norm = clip_norm

        _grads = OptaxAdam._grads
        global_norm = OptaxAdam.global_norm

        @torch.no_grad()
        def step(self, closure=None):
            if closure is not None:
                raise ValueError("ZeroOptaxAdam.step takes no closure")
            if self.clip_norm:
                _clip_by_global_norm_(self._grads(), self.clip_norm)
            return super().step()

        def state_dict(self) -> dict:
            sd = super().state_dict()
            group = {k: v for k, v in self.optim.param_groups[0].items() if k != "params"}
            return {"state": sd["state"], "param_groups": [{**group, "params": list(range(len(self._all_params)))}]}

        def load_state_dict(self, state_dict: dict):
            # ZeRO clears the entries of other ranks' parameters in what it is given.
            super().load_state_dict({**state_dict, "state": dict(state_dict["state"])})

    return ZeroOptaxAdam


def make_optimizer(model: PoseNet, cfg: Config, steps_per_epoch: int, dp: Optional[DataParallel] = None):
    """(optimizer, scheduler): ``OptaxAdam`` over the model's parameters (or
    ``ZeroOptaxAdam`` with ``cfg.parallel.shard_opt_state`` on a process
    group) and a ``LambdaLR`` giving update k the rate
    ``make_lr_schedule(...)(k)``; call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    o = cfg.optim
    if cfg.parallel.shard_opt_state and dp is not None and dp.group is not None:
        opt = zero_optax_adam()(model.parameters(), o.lr, o.grad_clip_norm, o.weight_decay, dp.group)
    else:
        opt = OptaxAdam(model.parameters(), lr=o.lr, clip_norm=o.grad_clip_norm, weight_decay=o.weight_decay)
    sched = make_lr_schedule(cfg, steps_per_epoch)
    return opt, LambdaLR(opt, lambda k: sched(k) / cfg.optim.lr)


@dataclasses.dataclass
class TrainState:
    model: PoseNet
    optimizer: OptaxAdam
    scheduler: LambdaLR
    step: int = 0  # optimizer updates taken

    def state_dict(self) -> dict:
        """What a resumed run needs: the model's state_dict (fp32 master
        weights, BN running statistics), the optimizer's (Adam moments and
        counts), the schedule's (its count) and the update count. The
        tensors are the live ones, which the next step updates in place:
        ``CheckpointManager.save`` copies them. Under ZeRO, call the
        optimizer's ``consolidate_state_dict`` on every rank first."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state_dict: dict):
        """Copy ``state_dict`` into this state, onto the model's device. The
        rate of the next update is this state's schedule at the restored
        count, as optax's schedule is a function of its count: a snapshot
        taken with another epoch length, or converted from JAX, resumes on
        this run's schedule."""
        self.model.load_state_dict(state_dict["model"])
        self.optimizer.load_state_dict(state_dict["optimizer"])
        self.scheduler.load_state_dict(state_dict["scheduler"])
        count = self.scheduler.last_epoch
        for group, base, fn in zip(
            self.optimizer.param_groups, self.scheduler.base_lrs, self.scheduler.lr_lambdas
        ):
            group["lr"] = base * fn(count)
        self.step = int(state_dict["step"])


def create_train_state(
    model: PoseNet, cfg: Config, steps_per_epoch: int, dp: Optional[DataParallel] = None
) -> TrainState:
    opt, sched = make_optimizer(model, cfg, steps_per_epoch, dp)
    return TrainState(model, opt, sched)


class _Coords(torch.nn.Module):
    """``PoseNet.coords`` as a module's forward, for DDP: DDP sets up its
    gradient reduction only in its own ``__call__``, so a call of
    ``ddp.module.coords`` would skip it."""

    def __init__(self, model: PoseNet):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.model.coords(image)


# id(model) -> the one DistributedDataParallel of that model, shared by its
# step functions (the full and the lean step, and those rebuilt by
# ``Trainer.cap_steps_per_epoch``): each DDP hooks every parameter.
_DDP: Dict[int, DistributedDataParallel] = {}


def _ddp(model: PoseNet, dp: DataParallel) -> DistributedDataParallel:
    if id(model) not in _DDP:
        device = next(model.parameters()).device
        # No buffer broadcast: the all-reduced BN statistics keep the
        # running ones equal on every rank.
        _DDP[id(model)] = DistributedDataParallel(
            _Coords(model), device_ids=[device.index] if device.type == "cuda" else None,
            process_group=dp.group, broadcast_buffers=False,
        )
    return _DDP[id(model)]


def _mean_over_ranks(t: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    if dp is None or dp.group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=dp.group)
    return t / dp.world


def _error_components(coords, pb: PatchBatch, dp: Optional[DataParallel]):
    labels = (pb.joint_img, pb.joint_vis, pb.joints_have_depth)
    if dp is None or dp.group is None:
        return joint_location_loss_components(coords, *labels)
    sums = joint_location_loss_sums(coords, *labels)  # ratios: sum the sums
    dist.all_reduce(sums, group=dp.group)
    return components_from_sums(sums)


def aug_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The CPU generator of a canvas batch's augmentation: update ``step``
    (counted over the run) of ``epoch`` of a run seeded ``seed``, as JAX's
    ``fold_in(fold_in(data_rng, epoch), state.step)``. The draws depend on
    these three numbers alone, so a resumed run, any device and any number
    of ranks draw the same."""
    hi, lo = np.random.SeedSequence([seed, epoch, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def patch_batch(
    batch: Dict[str, torch.Tensor],
    cfg: Config,
    flip_perm,
    train: bool,
    aug_key: Optional[Tuple[int, int]] = None,
    dp: Optional[DataParallel] = None,
) -> PatchBatch:
    """The model's input and labels from either kind of batch of
    ``pipeline.prefetch_to_device``. A host-warped batch (``patch``) goes
    through ``finalize_patch``. A canvas batch (``canvas``) is warped on its
    device by ``patch_batch_from_params``; with ``train`` and
    ``cfg.data.use_aug``, the augmentation is drawn for the global batch from
    ``aug_generator(cfg.seed, *aug_key)`` and this rank's rows are taken, so
    W ranks augment as one process."""
    if "canvas" not in batch:
        return PatchBatch(
            image=finalize_patch(batch["patch"], batch["color_scale"], cfg.data),
            joint_img=batch["joint_img"],
            joint_vis=batch["joint_vis"],
            joints_have_depth=batch["joints_have_depth"],
        )
    b = batch["canvas"].shape[0]
    if train and cfg.data.use_aug:
        if aug_key is None:
            raise ValueError("a canvas batch with augmentation needs its (epoch, step)")
        rank, world = (dp.rank, dp.world) if dp is not None else (0, 1)
        drawn = sample_aug_params(aug_generator(cfg.seed, *aug_key), b * world, cfg.data)
        params = tuple(p[rank * b : (rank + 1) * b] for p in drawn)
    else:
        params = no_aug_params(b)
    return patch_batch_from_params(
        batch["canvas"], batch["canvas_origin"], batch["canvas_scale"], batch["bbox"],
        batch["joints"], batch["joint_vis"], batch["joints_have_depth"], flip_perm, cfg.data, *params,
    )


def make_train_step(
    model: PoseNet, optimizer: OptaxAdam, cfg: Config, lean: bool = False, scheduler=None,
    dp: Optional[DataParallel] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch, epoch=None, global_step=None) -> metrics``, one
    update of ``model`` in place.

    ``batch``: tensors on the model's device from ``pipeline.prefetch_to_device``,
    host-warped (``patch`` (B, H, W, 3) uint8, ``color_scale`` (B, 3),
    ``joint_img`` (B, J, 3), ``joint_vis`` (B, J), ``joints_have_depth``
    (B,)) or canvases (``HostBatch``'s fields; ``patch_batch``), whose
    augmentation is drawn for (``epoch``, ``global_step``): the Trainer
    passes the epoch and the number of updates taken before. Metrics are
    0-dim device tensors (no host sync): ``loss``, and unless ``lean`` also
    ``grad_norm`` (before clipping), ``err_xy_voxels`` and ``err_z_voxels``.
    ``scheduler.step()`` follows each update when a scheduler is given.

    ``dp`` with a process group: ``batch`` is this rank's rows, the model
    runs through its ``DistributedDataParallel``, and the metrics are the
    global batch's on every rank: the loss averaged over the ranks, the
    error components from the ranks' summed sums, ``grad_norm`` of the
    reduced gradients."""
    coords_fn = _ddp(model, dp) if dp is not None and dp.group is not None else model.coords
    flip_perm = skeletons.get_skeleton(cfg.data.trainset[0]).flip_permutation()

    def step(
        batch: Dict[str, torch.Tensor], epoch: Optional[int] = None, global_step: Optional[int] = None
    ) -> Dict[str, torch.Tensor]:
        aug_key = None if epoch is None or global_step is None else (epoch, global_step)
        pb = patch_batch(batch, cfg, flip_perm, train=True, aug_key=aug_key, dp=dp)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with model.precision():
            coords = coords_fn(pb.image)
            loss = joint_location_loss(coords, pb.joint_img, pb.joint_vis, pb.joints_have_depth)
            loss.backward()
        metrics = {"loss": _mean_over_ranks(loss.detach(), dp)}
        if not lean:
            metrics["grad_norm"] = optimizer.global_norm()
            with torch.no_grad():
                metrics["err_xy_voxels"], metrics["err_z_voxels"] = _error_components(coords, pb, dp)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return metrics

    return step


def flip_test_coords(
    coords_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    flip_perm: Sequence[int] | torch.Tensor,
    out_w: int,
) -> torch.Tensor:
    """The reference's flip-test: ``coords_fn`` of the (B, H, W, 3) images
    and their W-mirrors as one 2B forward (a model's ``coords``, or its
    ``coords_plain`` in an exported program, which cannot trace the fused
    kernel); the mirrored coords are remapped
    (x -> out_w - 1 - x, then the joints' flip permutation) and averaged
    with the plain ones. -> (B, J, 3). JAX interleaves the two halves for
    shard locality; per-sample results do not depend on the order, so one
    device concatenates."""
    b = image.shape[0]
    both = coords_fn(torch.cat([image, image.flip(2)], dim=0))
    coords, cf = both[:b], both[b:]
    x = out_w - 1.0 - cf[..., 0]
    cf = torch.cat([x[..., None], cf[..., 1:]], dim=-1)[:, flip_perm]
    return (coords + cf) * 0.5


def make_eval_step(
    model: PoseNet, cfg: Config
) -> Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``eval_step(batch) -> (coords, joint_img, joint_vis)``: the
    model's input (``patch_batch``, no augmentation), then (B, J, 3) voxel
    coords of ``model`` (in eval mode, e.g. ``pose_net.inference_copy``)
    through ``PoseNet.coords``, with the reference's flip-test averaging when
    ``cfg.eval.flip_test``. ``batch`` as the train step's, from
    ``pipeline.prefetch_to_device``. Runs under ``inference_mode``."""
    skel = skeletons.get_skeleton(cfg.data.testset)
    flip_perm = torch.as_tensor(skel.flip_permutation())
    out_w = cfg.data.output_shape[1]

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]):
        pb = patch_batch(batch, cfg, flip_perm, train=False)
        if cfg.eval.flip_test:
            coords = flip_test_coords(model.coords, pb.image, flip_perm.to(pb.image.device), out_w)
        else:
            coords = model.coords(pb.image)
        return coords, pb.joint_img, pb.joint_vis

    return eval_step
