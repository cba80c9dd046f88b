"""tools/f32_breakdown.py on the CPU: its stripped builds name macros the
fp32 kernels' sources read, and it refuses to time without a card."""

import pytest

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.tools import f32_breakdown


@pytest.mark.parametrize("variant", sorted(f32_breakdown.VARIANTS))
def test_variant_macros_are_read_by_the_sources(variant):
    """Every -D macro of a variant is tested by an #ifdef in the fp32
    kernels' sources or csrc/fused_head_f32.cuh, the header they (and
    K5/K6-fp32's matmul_bn_f32.cuh, which K7/K8-fp32's conv3_f32.cuh
    includes) include, so no variant silently times the full kernel."""
    texts = [(_build.CSRC / n).read_text() for n in
             ("fused_head_f32.cuh", "fused_head_integral_fwd_f32.cu", "fused_head_integral_bwd_f32.cu",
              "matmul_bn_f32.cuh", "conv3_f32.cuh")]
    assert all('#include "fused_head_f32.cuh"' in t for t in texts[1:4])
    assert '#include "matmul_bn_f32.cuh"' in texts[4]
    for macro in f32_breakdown.VARIANTS[variant]:
        assert any(f"#ifdef {macro}" in t for t in texts), macro


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert f32_breakdown.main(["--batch", "2"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
