"""tools/k1_ring_check.py on the CPU: the K1 source still declares its ring
as the tool rewrites it, and the tool refuses a host without CUDA."""

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.tools import k1_ring_check


def test_k1_source_declares_the_ring_the_tool_rewrites():
    src = (_build.CSRC / f"{fhi._LIB}.cu").read_text()
    assert src.count(k1_ring_check._RING + k1_ring_check._ASSERT) == 1


def test_k1_ring_check_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_ring_check.main(["--launches", "1", "--rounds", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
