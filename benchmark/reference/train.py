"""The reference's first training steps: the forward in train mode (batch
statistics), the masked L1 loss, its gradient by autograd, and Adam with the
configuration's step schedule, all in float32 with TF32 off.

Adam as optax composes it: b1 0.9, b2 0.999, eps 1e-8 outside the square
root, bias-corrected moments, update k (counted from 0) at the rate the
schedule gives k: ``lr`` divided by ``lr_dec_factor`` at each boundary
``epoch * steps_per_epoch`` that k has reached.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from . import pose_net

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN while the
    block runs, restored after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32, cudnn.allow_tf32 = False, False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = prev


def learning_rate(sizes: Dict, steps_per_epoch: int, count: int) -> float:
    lr = sizes["lr"]
    for epoch in sizes["lr_dec_epoch"]:
        if count >= int(epoch * steps_per_epoch):
            lr /= sizes["lr_dec_factor"]
    return lr


def leaf_names(sizes: Dict) -> List[str]:
    """The trained tensors (every tensor of the state but the running statistics)."""
    return [n for n, _, kind in pose_net.param_specs(sizes) if kind not in ("bn_mean", "bn_var")]


def train_steps(sizes: Dict, state: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
                steps_per_epoch: int, quant=None) -> Dict:
    """Follow ``len(batches)`` steps from ``state``. Returns the loss of each
    step, each leaf's first gradient norm, and each leaf's change norm after
    the last step, and the first step's coords. ``quant``: the precision control."""
    if sizes.get("weight_decay", 0.0) or sizes.get("grad_clip_norm") is not None:
        raise ValueError("the reference's Adam has no weight decay and no clipping")
    names = leaf_names(sizes)
    p = {k: v.detach().to(torch.float32).clone() for k, v in state.items()}
    leaves = [p[n].requires_grad_(True) for n in names]
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    net = pose_net.PoseNetRef(sizes, quant)
    losses, first, coords0 = [], None, None
    with no_tf32():
        for k, batch in enumerate(batches):
            image = pose_net.normalize(batch["patch"], batch["color_scale"], sizes)
            coords = net.coords(p, image, train=True)
            loss = pose_net.masked_l1(coords, batch["joint_img"].float(), batch["joint_vis"].float(),
                                      batch["joints_have_depth"].float())
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if first is None:
                first = [float(g.norm()) for g in grads]
                coords0 = coords.detach().clone()
            lr = learning_rate(sizes, steps_per_epoch, k)
            with torch.no_grad():
                for t, g, m_, v_ in zip(leaves, grads, m, v):
                    m_.mul_(B1).add_(g, alpha=1 - B1)
                    v_.mul_(B2).addcmul_(g, g, value=1 - B2)
                    mhat = m_ / (1 - B1 ** (k + 1))
                    vhat = v_ / (1 - B2 ** (k + 1))
                    t.sub_(lr * mhat / (vhat.sqrt() + EPS))
            del coords, loss, grads
    change = [float((t.detach() - s).norm()) for t, s in zip(leaves, start)]
    return {"losses": losses, "grad_norms": dict(zip(names, first)), "change_norms": dict(zip(names, change)),
            "coords": coords0}


def loss_at(sizes: Dict, state: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], quant=None) -> float:
    """The loss of ``batch`` at ``state``, the forward in train mode (batch
    statistics), in float32 (``quant``: the precision control)."""
    p = {k: v.detach().to(torch.float32) for k, v in state.items()}
    with torch.no_grad(), no_tf32():
        image = pose_net.normalize(batch["patch"], batch["color_scale"], sizes)
        coords = pose_net.PoseNetRef(sizes, quant).coords(p, image, train=True)
        return float(pose_net.masked_l1(coords, batch["joint_img"].float(), batch["joint_vis"].float(),
                                        batch["joints_have_depth"].float()))


def calibrate(sizes: Dict, state: Dict[str, torch.Tensor], images: torch.Tensor,
              logit_std: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """``state`` with each BatchNorm's running statistics set to its batch
    statistics over ``images`` (normalized, (B, H, W, 3)), so that the
    network in inference mode normalizes as in training; with ``logit_std``
    the final conv is scaled so that its logits over ``images`` have that
    deviation (a head whose heatmaps are not flat)."""
    record = {}
    net = pose_net.PoseNetRef(sizes)
    with torch.no_grad(), no_tf32():
        feat = net.features(state, images, train=True, record=record)
        out = dict(state)
        for name, (mean, var) in record.items():
            out[f"{name}.running_mean"] = mean.clone()
            out[f"{name}.running_var"] = var.clone()
        if logit_std is not None:
            logits = feat @ state["head.final.weight"]
            out["head.final.weight"] = state["head.final.weight"] * (logit_std / logits.std())
    return out
