"""ImageNet backbone weights for ``--pretrained`` (JAX
``Trainer.load_pretrained_backbone``; the reference downloads them from
torchvision's model zoo).

Two file formats:

- a torchvision ResNet ``state_dict`` (``.pth`` or ``.pt``), the
  reference's own format, read with ``torch.load(weights_only=True)``; its
  names map onto the port's as in ``tools/convert_torch_ckpt.py:
  convert_backbone`` (``layer{s}.{i}`` -> ``layer{s}_{i}``, ``downsample.0`` /
  ``.1`` -> ``down_conv`` / ``down_bn``; the layouts are torch's on both
  sides); ``fc.*`` and ``num_batches_tracked`` are ignored;
- any other name: the flax msgpack that ``tools/convert_torch_ckpt.py
  --kind backbone`` writes, ``{"params": ..., "batch_stats": ...}`` of JAX's
  ``ResNetBackbone``, read by the port's own decoder (``utils/msgpack.py``)
  and mapped through ``models/convert.py``'s layout map.

A backbone with the space-to-depth stem (``s2d_stem``) takes a file's 7x7
stem embedded by ``resnet.s2d_stem_kernel``, as JAX's converter embeds it
(``tools/convert_torch_ckpt.py --s2d_stem``), or a stem already in that
form. A key the backbone lacks, a key of the backbone that the file lacks,
or a shape that differs raises ``ValueError`` naming them. Loading copies into
the backbone's parameters and BN statistics in place, and touches nothing
else.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
from torch import nn

from ihpr_tpu_torch.models.convert import check_stem, jax_tree_to_state_dict
from ihpr_tpu_torch.models.resnet import S2DStem, s2d_stem_kernel
from ihpr_tpu_torch.utils import msgpack

_TORCH_SUFFIXES = (".pth", ".pt")
_IGNORED = re.compile(r"^fc\.|\.num_batches_tracked$")


def from_torchvision(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``state_dict`` -> the port's ``ResNetBackbone``
    names (fp32 tensors); ``fc.*`` and ``num_batches_tracked`` dropped."""
    out = {}
    for key, value in sd.items():
        if _IGNORED.search(key):
            continue
        name = re.sub(r"^layer(\d)\.(\d+)\.", r"layer\1_\2.", key)
        name = name.replace(".downsample.0.", ".down_conv.").replace(".downsample.1.", ".down_bn.")
        out[name] = value.detach().to(torch.float32)
    return out


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return tree.to(torch.float32).numpy()


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of JAX's ``ResNetBackbone`` (as
    ``utils.msgpack.unpackb`` decodes it) -> the port's backbone names."""
    if set(tree) != {"params", "batch_stats"}:
        raise ValueError(f"a backbone msgpack holds params and batch_stats, not {sorted(tree)}")
    params, stats = _as_numpy(tree["params"]), _as_numpy(tree["batch_stats"])
    check_stem(params)
    return jax_tree_to_state_dict("", params, stats)


def read(path: str) -> Dict[str, torch.Tensor]:
    """The backbone tensors of a pretrained file, under the port's names."""
    if path.endswith(_TORCH_SUFFIXES):
        return from_torchvision(torch.load(path, map_location="cpu", weights_only=True))
    with open(path, "rb") as f:
        return from_flax(msgpack.unpackb(f.read()))


def load_backbone(backbone: nn.Module, path: str):
    """Copy a pretrained file's weights into ``backbone`` (the port's
    ``ResNetBackbone``): every parameter and BN statistic, each of the same
    shape, and nothing more."""
    got = read(path)
    if isinstance(backbone.conv1, S2DStem) and got.get("conv1.weight", torch.empty(0)).shape[-2:] == (7, 7):
        got["conv1.weight"] = s2d_stem_kernel(got["conv1.weight"])
    want = backbone.state_dict()
    missing, unknown = sorted(want.keys() - got.keys()), sorted(got.keys() - want.keys())
    if missing or unknown:
        raise ValueError(f"{path}: missing backbone keys {missing[:8]}, unknown keys {unknown[:8]}")
    shapes = [f"{k} {tuple(got[k].shape)} != {tuple(t.shape)}" for k, t in want.items() if got[k].shape != t.shape]
    if shapes:
        raise ValueError(f"{path}: mis-shaped keys: {shapes[:8]}")
    with torch.no_grad():
        for key, tensor in want.items():
            tensor.copy_(got[key])
