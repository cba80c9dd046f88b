"""The port's standalone integral (``ops/integral_volume.py``, plain on the
CPU) and the fused op's routes against the JAX package, on the CPU.

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

from ihpr_tpu.ops.fused_head_integral import _pad_plan as jax_pad_plan
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

    assert not fhi.fused_supported(j, d, h * w, c, torch.float32)
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


# (B, H, W, C, J, D) of fp32 heads JAX runs its fused kernel on (J*D = 128
# as is; J = 18, D = 16 padded to 24 joints): the port takes FusedHeadIntegral
# (K1/K2-fp32 on the card).
FP32_HEADS = [(2, 16, 16, 128, 4, 32), (2, 16, 16, 128, 18, 16)]
# fp32 heads JAX has no fused plan for: D = 1 (mpii2d_r50's head: J*D = 16
# would pad to 128 joints, more than 2J), C = 72 (not a multiple of 128).
FP32_NO_PLAN = [(2, 8, 8, 256, 16, 1), (2, 8, 8, 72, 18, 16)]


def _route_matches_jax(shape, route, seed):
    """The fused op on fp32 numpy inputs against JAX's fused op on the same
    ones: the route the port took (by its autograd node), coords within 2e-3
    voxel, each gradient within 1e-4 of its largest."""
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head(shape, seed=seed)
    g = np.random.RandomState(seed + 1).randn(b, j, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda f, k, bb: jax_fused(f, k, bb, j, d), *map(jnp.asarray, (feat, kernel, bias)))
    ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    ref = np.asarray(ref)
    assert _away_from_centre(ref, (b, h, w, j, d))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, kernel, bias)]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    assert route in type(coords.grad_fn).__name__  # the route taken
    np.testing.assert_allclose(coords.detach().numpy(), ref, atol=2e-3)
    grads = torch.autograd.grad(coords, leaves, torch.from_numpy(g))
    for name, got, want in zip(("feat", "kernel", "bias"), grads, ref_grads):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        if name == "bias" and d == 1:
            # At D = 1, db = sum p (gx (x - cx) + gy (y - cy)) is 0 exactly
            # (x and y are centred on the coords), so both sides hold fp32
            # noise: each within 1e-4 of the bound on its terms, sum_r |dv|
            # <= |gx| (w - 1) + |gy| (h - 1) per sample and joint.
            bound = 1e-4 * (np.abs(g[..., 0]) * (w - 1) + np.abs(g[..., 1]) * (h - 1)).sum(0).max()
            assert max(np.abs(got.numpy()).max(), np.abs(want).max()) <= bound, name
            continue
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max(), name


@pytest.mark.parametrize("shape", FP32_HEADS, ids=["aligned", "padded"])
def test_fp32_head_takes_the_no_plan_route_and_matches_jax(shape):
    """An fp32 head JAX runs its fused kernel on (in fp32 HIGHEST; here in
    interpret mode) now takes FusedHeadIntegral, K1/K2-fp32's route (their
    plain versions on the CPU), where it used to take the no-plan route:
    coords within 2e-3 voxel of JAX's fused_final_conv_integral on the same
    weights, gradients within 1e-4 of each one's largest."""
    b, h, w, c, j, d = shape
    assert fhi.jax_plan(j, d, h * w, c) is not None
    assert fhi.fused_supported(j, d, h * w, c, torch.float32)
    _route_matches_jax(shape, "FusedHeadIntegral", seed=15)


@pytest.mark.parametrize("shape", FP32_NO_PLAN, ids=["j16_d1", "c72"])
def test_fp32_head_without_a_jax_plan_takes_the_no_plan_route(shape):
    """An fp32 head JAX computes the logits of outside any kernel keeps the
    port's no-plan route (fp32 logits, then K3/K4 on the card), within the
    same bars of JAX's fused op."""
    b, h, w, c, j, d = shape
    assert fhi.jax_plan(j, d, h * w, c) is None
    assert not fhi.fused_supported(j, d, h * w, c, torch.float32)
    _route_matches_jax(shape, "SoftArgmaxVolume", seed=17)


def test_fused_supported_mirrors_the_kernels_limits():
    hw = 64 * 64
    assert fhi.fused_supported(18, 64, hw, 256, torch.bfloat16)
    assert fhi.fused_supported(16, 1, hw, 16, torch.bfloat16)  # bf16: J and H*W free
    assert fhi.fused_supported(18, 64, hw, 256, torch.float32)  # the fp32 flagship: K1/K2-fp32
    assert fhi.fused_supported(18, 32, 32 * 32, 256, torch.float32)  # the tiny accuracy preset
    assert fhi.fused_supported(18, 64, hw, 128, torch.float32)
    assert not fhi.fused_supported(16, 1, hw, 256, torch.float32)  # no JAX plan: logits + K3/K4
    assert not fhi.fused_supported(17, 1, hw, 256, torch.float32)  # coco2d_r50's head
    assert not fhi.fused_supported(18, 64, hw, 64, torch.float32)  # no JAX plan (C % 128)
    assert not fhi.fused_supported(2, 128, hw, 256, torch.float32)  # a JAX plan, but D > 64
    assert not fhi.fused_supported(18, 64, hw, 384, torch.float32)  # a JAX plan, but C > 256
    assert not fhi.fused_supported(18, 64, hw, 72, torch.bfloat16)  # C % 16
    assert not fhi.fused_supported(18, 64, hw, 272, torch.bfloat16)  # more than K2's 256 channels
    assert not fhi.fused_supported(18, 65, hw, 256, torch.bfloat16)  # D > 64
    assert not fhi.fused_supported(18, 64, hw, 256, torch.float16)  # a dtype the kernels do not take
    assert not fhi.fused_supported(18, 64, hw, 256, torch.float64)


PLAN_J = (1, 2, 4, 14, 16, 17, 18, 24, 33, 64, 100, 128, 129)
PLAN_D = (1, 2, 3, 8, 16, 24, 32, 48, 64, 80, 128)
PLAN_HW = (9, 64, 256, 1000, 1024, 2304, 4096, 4097, 6912)
PLAN_C = (64, 72, 128, 256, 384)


def test_jax_plan_equals_jax_pad_plan():
    """The port's copy of JAX's plan against ihpr_tpu's own _pad_plan on
    every (J, D, HW, C) of the grid (the joint count as well as whether one
    exists), and the fp32 route it gives against ``_pad_plan(...) is not
    None`` within the fp32 kernels' limits (C <= 256, D <= 64)."""
    planned = 0
    for j in PLAN_J:
        for d in PLAN_D:
            for hw in PLAN_HW:
                for c in PLAN_C:
                    want = jax_pad_plan(j, d, hw, c)
                    assert fhi.jax_plan(j, d, hw, c) == want, (j, d, hw, c)
                    if c <= 256 and d <= 64:
                        assert fhi.fused_supported(j, d, hw, c, torch.float32) == (want is not None), (j, d, hw, c)
                    planned += want is not None
    assert 0 < planned < len(PLAN_J) * len(PLAN_D) * len(PLAN_HW) * len(PLAN_C)


def test_launch_counters_stay_zero_on_cpu():
    iv.launches = iv.bwd_launches = fhi.launches = fhi.bwd_launches = 0
    fhi.f32_launches = fhi.f32_bwd_launches = 0
    shape = VOL_SHAPES[0]
    x = torch.from_numpy(_heatmap(shape)).requires_grad_()
    iv.soft_argmax_from_heatmap(x, *shape[3:]).sum().backward()
    for head in (NO_PLAN[0], FP32_HEADS[0]):  # the no-plan route, then the fused one
        leaves = [torch.from_numpy(a).requires_grad_() for a in _head(head, seed=13)]
        fhi.fused_final_conv_integral(*leaves, *head[4:]).sum().backward()
    counts = (iv.launches, iv.bwd_launches, fhi.launches, fhi.bwd_launches, fhi.f32_launches, fhi.f32_bwd_launches)
    assert counts == (0,) * 6


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


# --- the fp32 kernels' split pre-pass (ops/fused_head_integral.py:split_planes) ---

# (C, J, D): the fp32 flagship head, a ragged J at D = 64, D = 32, C % 64 == 32 with D = 24
SPLIT_SHAPES = [(256, 18, 64), (64, 17, 64), (128, 4, 32), (96, 5, 24)]
SPLIT_IDS = ["flagship", "j17", "d32", "c96_d24"]


def _split_inputs(shape, seed=11):
    c, j, d = shape
    rng = np.random.RandomState(seed)
    # magnitudes over many binades, so the rounding sees every exponent
    w = rng.randn(c, j * d) * 10.0 ** rng.randint(-6, 7, (c, j * d))
    return torch.from_numpy(w.astype(np.float32))


def _unpermuted(shape, wt, w):
    """Each plane back in natural order: (2, C, J, 64) from wt and from w."""
    c, j, _ = shape
    inv32 = torch.argsort(torch.tensor(fhi._PERM32))
    inv8 = torch.argsort(torch.tensor(fhi._PERM8))
    chans = torch.tensor([32 * (k // 32) + int(inv32[k % 32]) for k in range(c)])
    bins = torch.tensor([8 * (z // 8) + int(inv8[z % 8]) for z in range(64)])
    from_wt = wt[..., chans].view(2, j, 64, c).permute(0, 3, 1, 2)
    from_w = w.view(2, c, j, 64)[..., bins]
    return from_wt, from_w


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=SPLIT_IDS)
def test_split_planes_are_tf32_and_within_2_22(shape):
    """Both layouts' hi and lo planes are TF32 (the low 13 bits zero, so
    the tensor cores drop nothing); hi + lo is within 2^-22 |W| of W, with
    zeros past D; and both layouts hold the same values."""
    c, j, d = shape
    kernel = _split_inputs(shape)
    wt, w = fhi.split_planes(kernel, j, d)
    assert wt.shape == (2, j * 64, c) and w.shape == (2, c, j * 64)
    for plane in (wt, w):
        assert int((plane.view(torch.int32) & 0x1FFF).abs().max()) == 0
    from_wt, from_w = _unpermuted(shape, wt, w)
    assert torch.equal(from_wt, from_w)
    whole = from_w[0].double() + from_w[1].double()  # (C, J, 64)
    assert int(torch.count_nonzero(whole[..., d:])) == 0
    x = kernel.double().view(c, j, d)
    assert bool(((whole[..., :d] - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert bool((from_w[0][..., :d].double() != x).any())  # lo is not all zero: hi alone is not x


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=SPLIT_IDS)
def test_split_planes_permuted_products_give_the_head(shape):
    """The products the kernels form from the planes, emulated in float64
    with the planes as stored: dfeat = dv W^T with A relabelled as as_a does
    (k-slot t of an 8-bin group is bin 2t, slot t + 4 is bin 2t + 1, so A's
    slot q holds bin _PERM8[q]), and S = F W with A taken as load_a does
    (slot q of k-step s of a 32-channel block is channel _PERM32[8s + q]):
    each within 2^-20 of the sum of |terms| of the float64 product of the
    fp32 operands."""
    c, j, d = shape
    rng = np.random.RandomState(12)
    kernel = torch.from_numpy((rng.randn(c, j * d) * 0.1).astype(np.float32))
    wt, w = fhi.split_planes(kernel, j, d)
    k64 = kernel.double()
    dv = torch.from_numpy(rng.randn(40, j * d).astype(np.float32)).double()
    dv_pad = torch.zeros(40, j, 64, dtype=torch.float64)
    dv_pad[..., :d] = dv.view(40, j, d)
    bins = torch.tensor([8 * (p // 8) + fhi._PERM8[p % 8] for p in range(64)])
    a = dv_pad[..., bins].reshape(40, j * 64)  # A's k-slots, as_a's order
    got = a @ (w[0].double() + w[1].double()).t()
    want = dv @ k64.t()
    assert bool(((got - want).abs() <= 2.0 ** -20 * (dv.abs() @ k64.abs().t())).all())

    feat = torch.from_numpy(rng.randn(40, c).astype(np.float32)).double()
    chans = torch.tensor([32 * (p // 32) + fhi._PERM32[p % 32] for p in range(c)])
    s = feat[:, chans] @ (wt[0].double() + wt[1].double()).t()  # (40, J*64)
    s = s.view(40, j, 64)[..., :d].reshape(40, j * d)
    want = feat @ k64
    assert bool(((s - want).abs() <= 2.0 ** -20 * (feat.abs() @ k64.abs())).all())


def test_split_planes_perms_match_the_kernels():
    """_PERM32 and _PERM8 are the orders csrc/fused_head_f32.cuh writes
    (perm32, perm8 and their inverses inv32, inv8, copied here as
    formulas): each a permutation, each inverse its inverse."""
    inv32 = [8 * ((c & 7) >> 1) + (c >> 3) + 4 * (c & 1) for c in range(32)]
    inv8 = [(z >> 1) + 4 * (z & 1) for z in range(8)]
    assert sorted(fhi._PERM32) == list(range(32)) and sorted(fhi._PERM8) == list(range(8))
    assert [inv32[fhi._PERM32[p]] for p in range(32)] == list(range(32))
    assert [inv8[fhi._PERM8[q]] for q in range(8)] == list(range(8))
    # load_a: thread t, k-step s takes channels 8t + 2s (slot t) and 8t + 2s + 1 (slot t + 4)
    for s in range(4):
        for t in range(4):
            assert fhi._PERM32[8 * s + t] == 8 * t + 2 * s
            assert fhi._PERM32[8 * s + t + 4] == 8 * t + 2 * s + 1
    # as_a: slot t is column 2t, slot t + 4 is column 2t + 1
    assert fhi._PERM8 == [0, 2, 4, 6, 1, 3, 5, 7]
