"""The benchmark's initializer: one state dictionary drawn on the device from
the seed, handed to the program (``build_pose_net(..., state_dict=...)``)
and to the reference alike.

The configuration's scheme: each conv lecun-normal (deviation 1 / sqrt(fan
in)), each deconv and the final conv normal with ``head_final_init_std``,
the final bias 0, BatchNorm scale 1 and bias 0, running mean 0 and variance
1. One normal draw covers every weight; each tensor is a scaled slice of it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import common
from benchmark.reference import pose_net


def draw(sizes: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = pose_net.param_specs(sizes)
    drawn = [s for s in specs if s[2] in ("conv", "deconv", "final_w")]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    z = torch.randn(total, generator=common.generator(seed, common.WEIGHTS, device), device=device)
    sd, at = {}, 0
    init_std = sizes["head_final_init_std"]
    for name, shape, kind in specs:
        if kind in ("conv", "deconv", "final_w"):
            n = math.prod(shape)
            std = 1.0 / math.sqrt(math.prod(shape[1:])) if kind == "conv" else init_std
            sd[name] = z[at:at + n].view(shape) * std
            at += n
        elif kind in ("bn_w", "bn_var"):
            sd[name] = torch.ones(shape, device=device)
        else:
            sd[name] = torch.zeros(shape, device=device)
    return sd
