"""Weights for the port's PoseNet: the JAX package's initialization scheme
drawn from a ``torch.Generator`` (JAX's own values come from
``models.jax_random``), conversion of a JAX parameter tree and of a
JAX train state (parameters, Adam moments, counts), and the way back: the
port's weights as numpy trees in flax's layout and names
(``to_jax_params``), for a JAX Tester to score.

Layout mapping from the JAX (flax) tree:

- conv kernel (kh, kw, in, out) -> (out, in, kh, kw);
- deconv kernel (kh, kw, in, out) -> (in, out, kh, kw) with the spatial
  taps flipped back (torch's transposed conv correlates where
  ``lax.conv_transpose`` convolves);
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var;
- final conv kernel (1, 1, C, J*D) -> (C, J*D), bias (J*D,) as is.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.models.head import FinalConv
from ihpr_tpu_torch.models.jax_random import TRUNC_STD
from ihpr_tpu_torch.models.resnet import BN, RESNET_SPECS


def init_state_dict(
    model: nn.Module, generator: torch.Generator, init_std: float = 0.001
) -> Dict[str, torch.Tensor]:
    """fp32 CPU state_dict for ``model`` drawn from ``generator`` with the
    JAX package's scheme: convs lecun-normal (truncated at 2 std), deconvs
    and the final conv normal(``init_std``), zero final bias, BN scale 1,
    bias 0, running mean 0, running var 1. The distributions are JAX's, the
    values are not: ``build_pose_net`` takes this draw only for a caller
    that passes a ``generator``; the rest get JAX's own values
    (``jax_random.jax_init_params``)."""
    sd: Dict[str, torch.Tensor] = {}

    def normal(shape, std):
        return torch.empty(shape).normal_(0.0, std, generator=generator)

    for name, mod in model.named_modules():
        p = f"{name}."
        if isinstance(mod, nn.ConvTranspose2d):
            sd[p + "weight"] = normal(mod.weight.shape, init_std)
        elif isinstance(mod, nn.Conv2d):
            fan_in = math.prod(mod.weight.shape[1:])
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            sd[p + "weight"] = nn.init.trunc_normal_(
                torch.empty(mod.weight.shape), 0.0, std, -2 * std, 2 * std, generator=generator
            )
        elif isinstance(mod, FinalConv):
            sd[p + "weight"] = normal(mod.weight.shape, init_std)
            sd[p + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, BN):
            c = mod.weight.shape[0]
            sd[p + "weight"] = torch.ones(c)
            sd[p + "bias"] = torch.zeros(c)
            sd[p + "running_mean"] = torch.zeros(c)
            sd[p + "running_var"] = torch.ones(c)
    return sd


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def jax_tree_to_state_dict(prefix: str, params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX module's ``params`` / ``batch_stats`` subtree -> fp32 tensors
    under the port's names, each prefixed with ``prefix`` (the layout map
    of the module docstring)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, p: Mapping, s: Mapping):
        for name, sub in p.items():
            key = f"{prefix}{name}"
            if "BatchNorm_0" in sub:
                bp, bs = sub["BatchNorm_0"], s[name]["BatchNorm_0"]
                sd[key + ".weight"] = _t(bp["scale"])
                sd[key + ".bias"] = _t(bp["bias"])
                sd[key + ".running_mean"] = _t(bs["mean"])
                sd[key + ".running_var"] = _t(bs["var"])
            elif name == "final":
                sd[key + ".weight"] = _t(np.asarray(sub["kernel"])[0, 0])
                sd[key + ".bias"] = _t(sub["bias"])
            elif name.startswith("deconv"):
                k = np.asarray(sub["kernel"])[::-1, ::-1]
                sd[key + ".weight"] = _t(k.transpose(2, 3, 0, 1))
            elif "kernel" in sub:
                sd[key + ".weight"] = _t(np.asarray(sub["kernel"]).transpose(3, 2, 0, 1))
            else:
                walk(key + ".", sub, s.get(name, {}))

    walk(prefix, params, batch_stats)
    return sd


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def state_dict_to_jax_tree(prefix: str, state_dict: Mapping[str, torch.Tensor]):
    """The inverse of ``jax_tree_to_state_dict``: the tensors of
    ``state_dict`` under ``prefix`` -> (``params``, ``batch_stats``), nested
    dicts of float32 numpy arrays in flax's layout and names (deconv taps
    flipped back, BN under ``BatchNorm_0``)."""
    trees = {"params": {}, "batch_stats": {}}
    keys = [k[len(prefix):] for k in state_dict if k.startswith(prefix)]
    bns = {k.rsplit(".", 1)[0] for k in keys if k.endswith(".running_mean")}

    def put(tree, path, leaf, value):
        node = trees[tree]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value

    for key in keys:
        module, leaf = key.rsplit(".", 1)
        path = module.split(".")
        v = state_dict[prefix + key].detach().to("cpu", torch.float32).numpy()
        if module in bns:
            if leaf in _BN_LEAVES:
                tree, name = _BN_LEAVES[leaf]
                put(tree, path + ["BatchNorm_0"], name, v)
        elif path[-1] == "final":
            put("params", path, "kernel" if leaf == "weight" else leaf, v[None, None] if leaf == "weight" else v)
        elif path[-1].startswith("deconv"):
            put("params", path, "kernel", np.ascontiguousarray(v.transpose(2, 3, 0, 1)[::-1, ::-1]))
        else:
            put("params", path, "kernel", np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
    return trees["params"], trees["batch_stats"]


def to_jax_params(model_or_state_dict) -> tuple:
    """A port PoseNet (or its ``state_dict``) -> JAX PoseNet ``params`` and
    ``batch_stats``, numpy trees that ``from_jax_params`` maps back to the
    same tensors bitwise (float32; a bf16 inference copy's weights widen
    exactly)."""
    sd = model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module) else model_or_state_dict
    params, stats = {}, {}
    for part in ("backbone", "head"):
        params[part], stats[part] = state_dict_to_jax_tree(f"{part}.", sd)
    return params, stats


_STEMS = {False: (7, 7, 3), True: (4, 4, 12)}  # s2d_stem -> the JAX stem kernel's (kh, kw, in)


def check_stem(backbone_params: Mapping, s2d_stem: bool | None = None):
    """Raise unless the JAX stem kernel is the 7x7x3 layout or, with
    ``s2d_stem``, the space-to-depth (4, 4, 12) one (None: either)."""
    stem = np.asarray(backbone_params["conv1"]["kernel"]).shape[:3]
    allowed = list(_STEMS.values()) if s2d_stem is None else [_STEMS[s2d_stem]]
    if stem not in allowed:
        raise ValueError(f"stem kernel {stem} is not one of {allowed} (s2d_stem={s2d_stem})")


def from_jax_params(
    params: Mapping, batch_stats: Mapping, cfg: Config
) -> Dict[str, torch.Tensor]:
    """JAX PoseNet ``params`` / ``batch_stats`` (nested dicts of arrays) ->
    the port's fp32 PoseNet ``state_dict``."""
    check_stem(params["backbone"], cfg.model.s2d_stem)
    _, depths, _ = RESNET_SPECS[cfg.model.resnet_type]
    blocks = [k for k in params["backbone"] if k.startswith("layer")]
    if len(blocks) != sum(depths):
        raise ValueError(
            f"{len(blocks)} residual blocks in params, ResNet-{cfg.model.resnet_type} has {sum(depths)}"
        )
    return {
        **jax_tree_to_state_dict("backbone.", params["backbone"], batch_stats["backbone"]),
        **jax_tree_to_state_dict("head.", params["head"], batch_stats["head"]),
    }


def _optax_states(tree):
    """The optax state tuples (namedtuples) in an ``opt_state`` tree."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _optax_states(sub)


def from_jax_train_state(
    params: Mapping, batch_stats: Mapping, opt_state, step, cfg: Config
) -> Dict:
    """A JAX ``TrainState``'s trees (numpy, as JAX's ``CheckpointManager``
    restores them) -> the port's ``TrainState.state_dict()``, so that a JAX
    snapshot resumes in the port.

    ``opt_state`` is the chain of ``ihpr_tpu.parallel.train_step.make_optimizer``:
    ``scale_by_adam``'s ``mu`` / ``nu`` / ``count`` become each parameter's
    ``exp_avg`` / ``exp_avg_sq`` / ``step`` through the parameters' layout map
    (``from_jax_params``, the deconv tap flip included); the schedule's count
    becomes ``LambdaLR.last_epoch``; the clip and decay states are empty.
    A snapshot of a JAX Trainer on a multi-device mesh converts the same
    way, with or without ``shard_opt_state``: its manager restores every
    leaf as a full host array (``device_get``), and the port's snapshot
    resumes on any number of ranks."""
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel.train_step import create_train_state

    states = list(_optax_states(opt_state))
    adam = [s for s in states if s._fields == ("count", "mu", "nu")]
    sched = [s for s in states if s._fields == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(
            f"opt_state is not make_optimizer's chain: {[type(s).__name__ for s in states]}"
        )
    (adam,), (sched,) = adam, sched
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict=from_jax_params(params, batch_stats, cfg))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    mu = from_jax_params(adam.mu, batch_stats, cfg)
    nu = from_jax_params(adam.nu, batch_stats, cfg)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        # torch keeps each moment in its parameter's memory format.
        state.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name]),
        }
    state.scheduler.last_epoch = int(np.asarray(sched.count))
    state.step = int(np.asarray(step))
    return state.state_dict()
