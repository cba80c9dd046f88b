"""ihpr_tpu_torch ops vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The JAX
fused op runs its Pallas kernel in interpret mode (IHPR_PALLAS=interpret,
set by conftest). The final-conv weights have std 10/sqrt(C) (the JAX op
test uses 0.05), so logits have std ~5 and the heatmaps are peaked: flat
heatmaps put every coordinate at the volume centre, where any two
implementations agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.ops.fused_head_integral import fused_final_conv_integral as jax_fused
from ihpr_tpu.ops.integral import soft_argmax_3d as jax_soft_argmax_3d
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops.integral import soft_argmax_3d

torch.set_num_threads(1)

# (B, H, W, C, J, D): J*D = 128 runs the JAX kernel as is; J=18, D=16
# (J*D = 288) makes JAX pad the joints to 24 with -1e30 bias lanes.
ALIGNED = (2, 16, 16, 128, 4, 32)
PADDED = (2, 16, 16, 128, 18, 16)


def _head_inputs(shape, seed=0):
    b, h, w, c, j, d = shape
    rng = np.random.RandomState(seed)
    feat = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    kernel = (rng.randn(c, j * d) / np.sqrt(c) * 10.0).astype(np.float32)
    bias = (rng.randn(j * d) * 0.1).astype(np.float32)
    return feat, kernel, bias


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 and back, so both frameworks see identical values."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 16), (1, 18, 8, 12, 10)])
def test_soft_argmax_3d_matches_jax(shape):
    logits = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    ref = np.asarray(jax_soft_argmax_3d(jnp.asarray(logits)))
    out = soft_argmax_3d(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("shape", [ALIGNED, PADDED], ids=["aligned", "padded"])
def test_fused_plain_matches_jax(shape):
    j, d = shape[4:]
    feat, kernel, bias = _head_inputs(shape)
    ref = np.asarray(jax_fused(jnp.asarray(feat), jnp.asarray(kernel), jnp.asarray(bias), j, d))
    assert np.abs(ref - ref.mean()).max() > 1.0  # not a flat volume
    out = fhi.fused_final_conv_integral(
        torch.from_numpy(feat), torch.from_numpy(kernel), torch.from_numpy(bias), j, d
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4)


@pytest.mark.parametrize("shape", [ALIGNED, PADDED], ids=["aligned", "padded"])
def test_fused_plain_bf16_matches_jax(shape):
    """bf16 operands: both sides multiply the same bf16 values (products
    exact in fp32) and accumulate in fp32, so the bound stays 5e-4 voxel."""
    j, d = shape[4:]
    feat, kernel, bias = (_bf16(a) for a in _head_inputs(shape, seed=2))
    ref = np.asarray(
        jax_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (feat, kernel, bias)), j, d)
    )
    out = fhi.fused_final_conv_integral(
        *(torch.from_numpy(a).bfloat16() for a in (feat, kernel, bias)), j, d
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_plain_stats_match_numpy():
    """m is the per-joint max logit and s = sum exp(v - m), which the
    backward will read; checked in float64 on the host."""
    b, h, w, c, j, d = PADDED
    feat, kernel, bias = _head_inputs(PADDED, seed=3)
    coords, m, s = fhi.plain(
        torch.from_numpy(feat.reshape(b, h * w, c)), torch.from_numpy(kernel),
        torch.from_numpy(bias), j, d, w,
    )
    v = (feat.reshape(b, h * w, c).astype(np.float64) @ kernel + bias).reshape(b, h * w, j, d)
    m_ref = v.max(axis=(1, 3))
    e = np.exp(v - m_ref[:, None, :, None])
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), e.sum(axis=(1, 3)), rtol=1e-4)
    p = e / e.sum(axis=(1, 3), keepdims=True)
    z_ref = (p * np.arange(d)).sum(axis=(1, 3))
    np.testing.assert_allclose(coords[..., 2].numpy(), z_ref, atol=5e-4)


def test_launch_counter_stays_zero_on_cpu():
    fhi.launches = 0
    feat, kernel, bias = (torch.from_numpy(a) for a in _head_inputs(ALIGNED))
    fhi.fused_final_conv_integral(feat, kernel, bias, *ALIGNED[4:])
    assert fhi.launches == 0


def test_fused_rejects_bad_inputs():
    feat, kernel, bias = (torch.from_numpy(a) for a in _head_inputs(ALIGNED))
    j, d = ALIGNED[4:]
    with pytest.raises(ValueError, match="do not match"):
        fhi.fused_final_conv_integral(feat, kernel[:, :-1], bias, j, d)
    with pytest.raises(ValueError, match="do not match"):
        fhi.fused_final_conv_integral(feat, kernel, bias, j + 1, d)
    # The kernel entry point takes CUDA tensors only: no quiet CPU path.
    with pytest.raises(ValueError, match="CUDA"):
        fhi.kernel_stats(feat.reshape(2, 256, 128), kernel, bias, j, d, 16)

