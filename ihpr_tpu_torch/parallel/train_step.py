"""The single-GPU train and eval steps, counterpart of
``ihpr_tpu.parallel.train_step``.

One step: ``finalize_patch`` on the host-warped uint8 patch (colour scale,
clip, ImageNet normalize), ``PoseNet.coords`` in train mode (batch-stat BN;
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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.models.pose_net import PoseNet
from ihpr_tpu_torch.ops.loss import joint_location_loss, joint_location_loss_components


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
            grads = self._grads()
            norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
            # optax: g if |g| < clip else g / |g| * clip, without a host sync.
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        if self.decay:
            params = [p for grp in self.param_groups for p in grp["params"] if p.grad is not None]
            torch._foreach_mul_(params, 1.0 - self.decay)
        return super().step()


def make_optimizer(model: PoseNet, cfg: Config, steps_per_epoch: int):
    """(optimizer, scheduler): ``OptaxAdam`` over the model's parameters and
    a ``LambdaLR`` giving update k the rate ``make_lr_schedule(...)(k)``;
    call ``scheduler.step()`` after each ``optimizer.step()``."""
    opt = OptaxAdam(
        model.parameters(), lr=cfg.optim.lr, clip_norm=cfg.optim.grad_clip_norm,
        weight_decay=cfg.optim.weight_decay,
    )
    sched = make_lr_schedule(cfg, steps_per_epoch)
    return opt, LambdaLR(opt, lambda k: sched(k) / cfg.optim.lr)


@dataclasses.dataclass
class TrainState:
    model: PoseNet
    optimizer: OptaxAdam
    scheduler: LambdaLR
    step: int = 0  # optimizer updates taken


def create_train_state(model: PoseNet, cfg: Config, steps_per_epoch: int) -> TrainState:
    opt, sched = make_optimizer(model, cfg, steps_per_epoch)
    return TrainState(model, opt, sched)


def make_train_step(
    model: PoseNet, optimizer: OptaxAdam, cfg: Config, lean: bool = False, scheduler=None
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics``, one update of ``model`` in place.

    ``batch``: tensors on the model's device from ``pipeline.prefetch_to_device``:
    ``patch`` (B, H, W, 3) uint8, ``color_scale`` (B, 3), ``joint_img``
    (B, J, 3), ``joint_vis`` (B, J), ``joints_have_depth`` (B,). Metrics are
    0-dim device tensors (no host sync): ``loss``, and unless ``lean`` also
    ``grad_norm`` (before clipping), ``err_xy_voxels`` and ``err_z_voxels``.
    ``scheduler.step()`` follows each update when a scheduler is given."""

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with model.precision():
            coords = model.coords(image)
            loss = joint_location_loss(
                coords, batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"]
            )
            loss.backward()
        metrics = {"loss": loss.detach()}
        if not lean:
            metrics["grad_norm"] = optimizer.global_norm()
            with torch.no_grad():
                metrics["err_xy_voxels"], metrics["err_z_voxels"] = joint_location_loss_components(
                    coords, batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"]
                )
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return metrics

    return step


def flip_test_coords(
    model: PoseNet, image: torch.Tensor, flip_perm: Sequence[int] | torch.Tensor, out_w: int
) -> torch.Tensor:
    """The reference's flip-test: ``model.coords`` of the (B, H, W, 3) images
    and their W-mirrors as one 2B forward; the mirrored coords are remapped
    (x -> out_w - 1 - x, then the joints' flip permutation) and averaged
    with the plain ones. -> (B, J, 3). JAX interleaves the two halves for
    shard locality; per-sample results do not depend on the order, so one
    device concatenates."""
    b = image.shape[0]
    both = model.coords(torch.cat([image, image.flip(2)], dim=0))
    coords, cf = both[:b], both[b:]
    x = out_w - 1.0 - cf[..., 0]
    cf = torch.cat([x[..., None], cf[..., 1:]], dim=-1)[:, flip_perm]
    return (coords + cf) * 0.5


def make_eval_step(
    model: PoseNet, cfg: Config
) -> Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``eval_step(batch) -> (coords, joint_img, joint_vis)``:
    ``finalize_patch``, then (B, J, 3) voxel coords of ``model`` (in eval
    mode, e.g. ``pose_net.inference_copy``) through ``PoseNet.coords``, with
    the reference's flip-test averaging when ``cfg.eval.flip_test``.
    ``batch`` as the train step's, from ``pipeline.prefetch_to_device``.
    Runs under ``inference_mode``."""
    skel = skeletons.get_skeleton(cfg.data.testset)
    flip_perm = torch.as_tensor(skel.flip_permutation())
    out_w = cfg.data.output_shape[1]

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]):
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        if cfg.eval.flip_test:
            coords = flip_test_coords(model, image, flip_perm.to(image.device), out_w)
        else:
            coords = model.coords(image)
        return coords, batch["joint_img"], batch["joint_vis"]

    return eval_step
