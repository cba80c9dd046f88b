"""The port's standalone integral (``ops/integral_volume.py``, plain on the
CPU) and the fused op's no-plan route against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The JAX
integral runs its Pallas kernels (K3/K4) in interpret mode
(IHPR_PALLAS=interpret, set by conftest) where it launches them: J*D = 128
as is, J=18 with D=16 padded to 24 joints of -1e30 lanes; at D=1 JAX takes
its plain path. Logits have std ~5, so heatmaps are peaked and coordinates
sit away from the volume centre, where any two implementations agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.ops.fused_head_integral import fused_final_conv_integral as jax_fused
from ihpr_tpu.ops.integral_pallas import soft_argmax_3d_fused as jax_3d_fused
from ihpr_tpu.ops.integral_pallas import soft_argmax_from_heatmap as jax_from_heatmap
from ihpr_tpu_torch import ops
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import integral_volume as iv
from test_torch_ops import _bf16

torch.set_num_threads(1)

# (B, H, W, J, D)
VOL_SHAPES = [(2, 16, 16, 4, 32), (2, 16, 16, 18, 16), (2, 12, 10, 16, 1)]
VOL_IDS = ["aligned", "padded", "d1"]


def _heatmap(shape, seed=0):
    b, h, w, j, d = shape
    return (np.random.RandomState(seed).randn(b, h, w, j * d) * 5.0).astype(np.float32)


def _away_from_centre(coords, shape):
    _, h, w, _, d = shape
    return np.abs(np.asarray(coords) - ((w - 1) / 2, (h - 1) / 2, (d - 1) / 2)).max() > 1.0


@pytest.mark.parametrize("shape", VOL_SHAPES, ids=VOL_IDS)
def test_soft_argmax_from_heatmap_matches_jax(shape):
    j, d = shape[3:]
    hm = _heatmap(shape)
    ref = np.asarray(jax_from_heatmap(jnp.asarray(hm), j, d))
    assert _away_from_centre(ref, shape)
    out = iv.soft_argmax_from_heatmap(torch.from_numpy(hm), j, d).numpy()
    assert out.dtype == np.float32 and out.shape == (shape[0], j, 3)
    np.testing.assert_allclose(out, ref, atol=5e-4)


@pytest.mark.parametrize("shape", VOL_SHAPES, ids=VOL_IDS)
def test_soft_argmax_3d_fused_matches_jax(shape):
    b, h, w, j, d = shape
    logits = _heatmap(shape, seed=1).reshape(b, h, w, j, d).transpose(0, 3, 4, 1, 2).copy()
    ref = np.asarray(jax_3d_fused(jnp.asarray(logits)))
    assert _away_from_centre(ref, shape)
    out = ops.soft_argmax_3d_fused(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4)
    # the plain composition agrees too (same exported names as ihpr_tpu.ops)
    np.testing.assert_allclose(ops.soft_argmax_3d(torch.from_numpy(logits)).numpy(), out, atol=5e-4)


def test_bf16_volume_matches_jax():
    """A bf16 volume: both sides widen the same bf16 values to fp32 and
    reduce in fp32, so the bound stays 5e-4 voxel."""
    shape = VOL_SHAPES[1]
    j, d = shape[3:]
    hm = _bf16(_heatmap(shape, seed=2))
    ref = np.asarray(jax_from_heatmap(jnp.asarray(hm, jnp.bfloat16), j, d))
    out = iv.soft_argmax_from_heatmap(torch.from_numpy(hm).bfloat16(), j, d)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)


@pytest.mark.parametrize("shape", VOL_SHAPES, ids=VOL_IDS)
def test_heatmap_gradient_matches_jax(shape):
    """torch.autograd.grad of sum(w * coords) against jax.grad: fp32 within
    1e-4 of the largest |dv| (exp and sum order only)."""
    b, _, _, j, d = shape
    hm = _heatmap(shape, seed=3)
    wgt = np.random.RandomState(4).randn(b, j, 3).astype(np.float32)
    ref = np.asarray(jax.grad(lambda v: (jax_from_heatmap(v, j, d) * wgt).sum())(jnp.asarray(hm)))
    x = torch.from_numpy(hm).requires_grad_()
    (got,) = torch.autograd.grad((iv.soft_argmax_from_heatmap(x, j, d) * torch.from_numpy(wgt)).sum(), x)
    assert got.shape == hm.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_bf16_heatmap_gradient_keeps_the_dtype():
    """dv comes back in the volume's dtype (bf16), rounded once from fp32:
    within 1e-2 of the largest |dv| of JAX's bf16 gradient."""
    shape = VOL_SHAPES[1]
    b, _, _, j, d = shape
    hm = _bf16(_heatmap(shape, seed=5))
    wgt = np.random.RandomState(6).randn(b, j, 3).astype(np.float32)
    ref = jax.grad(lambda v: (jax_from_heatmap(v, j, d) * wgt).sum())(jnp.asarray(hm, jnp.bfloat16))
    x = torch.from_numpy(hm).bfloat16().requires_grad_()
    (got,) = torch.autograd.grad((iv.soft_argmax_from_heatmap(x, j, d) * torch.from_numpy(wgt)).sum(), x)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_plain_stats_match_float64():
    """m is each joint's max logit and s = sum exp(v - m); coords from
    float64 numpy."""
    b, h, w, j, d = VOL_SHAPES[1]
    vol = _heatmap(VOL_SHAPES[1], seed=7).reshape(b, h * w, j * d)
    coords, m, s = iv.plain(torch.from_numpy(vol), j, d, w)
    v = vol.astype(np.float64).reshape(b, h * w, j, d)
    m_ref = v.max(axis=(1, 3))
    e = np.exp(v - m_ref[:, None, :, None])
    np.testing.assert_array_equal(m.numpy(), m_ref.astype(np.float32))
    np.testing.assert_allclose(s.numpy(), e.sum(axis=(1, 3)), rtol=1e-5)
    p = e / e.sum(axis=(1, 3), keepdims=True)
    rows = np.arange(h * w)
    ref = np.stack([(p.sum(-1) * (rows % w)[None, :, None]).sum(1),
                    (p.sum(-1) * (rows // w)[None, :, None]).sum(1),
                    (p.sum(1) * np.arange(d)).sum(-1)], -1)
    np.testing.assert_allclose(coords.numpy(), ref, atol=5e-5)


def test_soft_argmax_volume_gradcheck_float64():
    b, h, w, j, d = 2, 3, 4, 3, 5
    vol = torch.from_numpy(np.random.RandomState(8).randn(b, h * w, j * d)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: iv.soft_argmax_volume(v, j, d, w), (vol,))


# --- the fused op's route when K1/K2 have no plan -------------------------------

# (B, H, W, C, J, D): C=72 is not a multiple of 16; D=80 is more than 64.
NO_PLAN = [(2, 8, 8, 72, 18, 16), (2, 8, 8, 128, 18, 80)]


def _head(shape, seed):
    b, h, w, c, j, d = shape
    rng = np.random.RandomState(seed)
    feat = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    kernel = (rng.randn(c, j * d) / np.sqrt(c) * 10.0).astype(np.float32)  # logits std ~5
    bias = (rng.randn(j * d) * 0.1).astype(np.float32)
    return feat, kernel, bias


@pytest.mark.parametrize("shape", NO_PLAN, ids=["c72", "d80"])
def test_fused_op_without_a_plan_matches_jax(shape):
    """Where K1/K2 take no such shape, the port forms fp32 logits and runs
    the standalone integral (K3/K4 on the card): coords within 5e-4 voxel
    of JAX's fused_final_conv_integral, and the gradients in feat, kernel
    and bias within 1e-4 of each one's largest (fp32, exp and sum order)."""
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head(shape, seed=9)
    g = np.random.RandomState(10).randn(b, j, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda f, k, bb: jax_fused(f, k, bb, j, d), *map(jnp.asarray, (feat, kernel, bias)))
    ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    ref = np.asarray(ref)
    assert _away_from_centre(ref, (b, h, w, j, d))

    assert not fhi.fused_supported(c, d, torch.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, kernel, bias)]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    assert "SoftArgmaxVolume" in type(coords.grad_fn).__name__  # the route taken
    np.testing.assert_allclose(coords.detach().numpy(), ref, atol=5e-4)
    grads = torch.autograd.grad(coords, leaves, torch.from_numpy(g))
    for name, got, want in zip(("feat", "kernel", "bias"), grads, ref_grads):
        assert got.shape == want.shape, name
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max(), name


def test_fused_op_without_a_plan_bf16_gradients_keep_dtypes():
    b, h, w, c, j, d = NO_PLAN[0]
    leaves = [torch.from_numpy(_bf16(a)).bfloat16().requires_grad_() for a in _head(NO_PLAN[0], seed=11)]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    assert coords.dtype == torch.float32
    grads = torch.autograd.grad(coords.sum(), leaves)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert all(torch.isfinite(t.float()).all() for t in grads)


def test_fused_op_without_a_plan_gradcheck_float64():
    b, h, w, c, j, d = 2, 3, 4, 8, 3, 5
    rng = np.random.RandomState(12)
    leaves = [
        torch.from_numpy(rng.randn(*shape) * scale).requires_grad_()
        for shape, scale in (((b, h, w, c), 0.5), ((c, j * d), 1.0), ((j * d,), 0.1))
    ]
    assert torch.autograd.gradcheck(lambda f, k, bb: fhi.fused_final_conv_integral(f, k, bb, j, d), leaves)


def test_fused_supported_mirrors_the_kernels_limits():
    assert fhi.fused_supported(256, 64, torch.bfloat16)
    assert fhi.fused_supported(16, 1, torch.float32)
    assert not fhi.fused_supported(72, 64, torch.bfloat16)  # C % 16
    assert not fhi.fused_supported(272, 64, torch.float32)  # more than K2's 256 channels
    assert not fhi.fused_supported(256, 65, torch.float32)  # D > 64
    assert not fhi.fused_supported(256, 64, torch.float16)  # a dtype the kernels do not take


def test_launch_counters_stay_zero_on_cpu():
    iv.launches = iv.bwd_launches = fhi.launches = fhi.bwd_launches = 0
    shape = VOL_SHAPES[0]
    x = torch.from_numpy(_heatmap(shape)).requires_grad_()
    iv.soft_argmax_from_heatmap(x, *shape[3:]).sum().backward()
    leaves = [torch.from_numpy(a).requires_grad_() for a in _head(NO_PLAN[0], seed=13)]
    fhi.fused_final_conv_integral(*leaves, *NO_PLAN[0][4:]).sum().backward()
    assert (iv.launches, iv.bwd_launches, fhi.launches, fhi.bwd_launches) == (0, 0, 0, 0)


def test_volume_ops_reject_bad_inputs():
    hm = torch.from_numpy(_heatmap(VOL_SHAPES[0]))
    with pytest.raises(ValueError, match="channels"):
        iv.soft_argmax_from_heatmap(hm, 4, 31)
    with pytest.raises(ValueError, match="B, H\\*W, J\\*D"):
        iv.soft_argmax_volume(hm.reshape(2, 256, 128), 4, 32, 15)
    with pytest.raises(ValueError, match="B, H\\*W, J\\*D"):
        iv.soft_argmax_volume(hm, 4, 32, 16)
    # The kernel entry points take CUDA tensors only: no quiet CPU path.
    with pytest.raises(ValueError, match="CUDA"):
        iv.kernel_stats(hm.reshape(2, 256, 128), 4, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        iv.kernel_bwd(hm.reshape(2, 256, 128), *[torch.zeros(2, 4)] * 2, *[torch.zeros(2, 4, 3)] * 2, 4, 32, 16)
    feat, kernel, bias = (torch.from_numpy(a) for a in _head(NO_PLAN[0], seed=14))
    with pytest.raises(ValueError, match="do not match"):
        fhi.fused_final_conv_integral(feat, kernel[:, :-1], bias, 18, 16)
