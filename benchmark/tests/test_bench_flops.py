"""The counts behind ``mfu.*`` and ``*_roofline`` against multiply-adds
counted with forward hooks on the port's model."""

import json

import pytest
import torch

from benchmark.harness import flops
from benchmark.tests.conftest import ROOT, TINY_CONFIG


def _hooked_macs(sizes) -> int:
    from benchmark.harness.cells import port_config
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from benchmark.harness import weights

    cfg = port_config(sizes)
    model = build_pose_net(cfg, device="cpu", state_dict=weights.draw(sizes, 0, "cpu"))
    macs = []

    def conv(mod, inp, out):
        k = mod.weight.shape[2] * mod.weight.shape[3]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs.append(inp[0].numel() * mod.out_channels * k)
        else:
            macs.append(out.numel() * mod.in_channels * k)

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            mod.register_forward_hook(conv)
    h, w = sizes["input_shape"]
    with torch.no_grad():
        feat = model.head.features(model.backbone(torch.zeros(1, 3, h, w)))
    final = feat.shape[1] * feat.shape[2] * feat.shape[3] * model.head.final.weight.shape[1]
    return sum(macs) + final


@pytest.mark.parametrize("config", ["h36m3d_r50", "tiny"])
def test_forward_macs_match_the_ports_layers(config):
    name = "h36m3d_r50" if config == "tiny" else config
    sizes = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    if config == "tiny":
        sizes.update(TINY_CONFIG)
    assert flops.forward_macs(sizes) == _hooked_macs(sizes)
    assert flops.train_flops(sizes) == 6 * flops.forward_macs(sizes)


def test_head_counts():
    sizes = json.loads((ROOT / "benchmark/configs/h36m3d_r50.json").read_text())
    ops, nbytes = flops.head_forward(sizes, 64)
    assert ops == 2 * 64 * 4096 * 256 * 1152
    assert nbytes == 2 * (64 * 4096 * 256 + 256 * 1152 + 1152) + 4 * 64 * 18 * 3
    ops, nbytes = flops.head_backward(sizes, 128)
    assert ops == 4 * 128 * 4096 * 256 * 1152 + 128 * 4096 * 1152
    peak = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert flops.bound_s(ops, nbytes, peak) == pytest.approx(ops / 989e12)
