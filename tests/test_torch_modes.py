"""The JAX package's model and kernel modes in the port, against JAX on the
CPU: the five measurement BN modes (``models/resnet.py:BN``),
``block_remat`` with both policies, the ``s2d_stem``, the
``SubpixelConvTranspose``, the fused head's ``IHPR_EXP2`` / ``IHPR_BEXP``
in its plain versions (JAX's kernel in interpret mode), the integral
helpers, the Timer and ``tools/bwd_experiments.py``.

Inputs are made with numpy from a seed and fed to both sides; JAX's
parameters go through ``models/convert.py`` into the port.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.engine.timer import Timer as JaxTimer
from ihpr_tpu.models.head import SubpixelConvTranspose as JaxSubpixel
from ihpr_tpu.models.resnet import _BN as JaxBN
from ihpr_tpu.models.resnet import ResNetBackbone as JaxBackbone
from ihpr_tpu.models.resnet import s2d_stem_kernel as jax_s2d_stem_kernel
from ihpr_tpu.ops import integral as jax_integral
from ihpr_tpu.ops.fused_head_integral import fused_final_conv_integral as jax_fused
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.engine.timer import Timer
from ihpr_tpu_torch.models import pretrained
from ihpr_tpu_torch.models.convert import from_jax_params, jax_tree_to_state_dict, to_jax_params
from ihpr_tpu_torch.models.head import Deconv, SubpixelConvTranspose
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.models.resnet import BN, ResNetBackbone, S2DStem, s2d_stem_kernel
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import integral
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from test_torch_ops import ALIGNED, PADDED, _bf16, _head_inputs
from test_torch_train import _jax_step, _port_step, _rel_err, _step_cfg, _train_batch
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

# --- BatchNorm's modes -------------------------------------------------------------------------------

MODES = ["flax", "lean", "lean16", "lean_sub2", "lean_sub4", "lean_sub8", "lean_sg", "lean_sgv", "frozen"]


def _rb(a):
    """Round to bf16 (round to nearest even) and back to float64."""
    return np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float64)


def _bn_inputs(seed=16, shape=(3, 8, 5, 6)):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    x = (rng.randn(b, h, w, c) * 2 + 0.5).astype(np.float32)
    r = rng.randn(b, h, w, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    return x, r, scale, bias, mean, var


def _jax_bn(mode, dtype, x, r, scale, bias, mean, var):
    """JAX's _BN in train mode: output, updated running statistics and the
    gradients of sum(y * r) in x, scale and bias, as float32 numpy."""
    jbn = JaxBN(dtype, mode)
    params = {"BatchNorm_0": {"scale": scale, "bias": bias}}
    stats = {"BatchNorm_0": {"mean": mean, "var": var}}

    def f(xx, p):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, True, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * r).sum(), (y, upd)

    (_, (y, upd)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(x, dtype), params)
    new = upd["batch_stats"]["BatchNorm_0"]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(y), f32(new["mean"]), f32(new["var"]), f32(gx), f32(gp["BatchNorm_0"]["scale"]),
            f32(gp["BatchNorm_0"]["bias"]))


def _port_bn(mode, dtype, x, r, scale, bias, mean, var):
    """The port's BN in train mode on the same values, as ``_jax_bn``."""
    c = x.shape[-1]
    bn = BN(c, mode, dtype)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)})
    bn.train()
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).detach().requires_grad_()
    y = bn(xt)
    (y.float().permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    f32 = lambda t: t.detach().float().numpy()  # noqa: E731
    return (f32(y.permute(0, 2, 3, 1)), f32(bn.running_mean), f32(bn.running_var), f32(xt.grad.permute(0, 2, 3, 1)),
            f32(bn.weight.grad), f32(bn.bias.grad))


@pytest.mark.parametrize("mode", MODES)
def test_bn_mode_matches_jax_fp32(mode):
    """Each mode's train-mode output, running statistics and the gradients of
    a scalar in (x, scale, bias) against JAX's _BN in fp32, at the bars of
    ``test_torch_train.test_bn_train_mode_matches_jax``: 1e-5, statistics
    1e-6. Rows 8: lean_sub2 and lean_sub4 subsample, lean_sub8 (8 < 16)
    takes every row, as JAX does."""
    args = _bn_inputs()
    ref, got = _jax_bn(mode, jnp.float32, *args), _port_bn(mode, torch.float32, *args)
    for name, a, b in zip(("y", "running_mean", "running_var", "dx", "dscale", "dbias"), got, ref):
        tol = 1e-6 if name.startswith("running") else 1e-5
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{mode} {name}")
    x, _, _, _, mean, var = args
    if mode == "frozen":  # running statistics in train mode, and no update
        np.testing.assert_array_equal(got[1], mean)
        np.testing.assert_array_equal(got[2], var)
    if mode in ("lean_sub2", "lean_sub4"):  # the statistics of rows (s-1)//2::s alone
        s = int(mode[-1])
        sub = x[:, (s - 1) // 2::s].astype(np.float64)
        want = 0.9 * mean + 0.1 * sub.mean(axis=(0, 1, 2))
        np.testing.assert_allclose(got[1], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["lean", "lean16", "lean_sgv", "flax"])
def test_bn_mode_matches_jax_bf16(mode):
    """The bf16 compute dtype, where lean16 takes its statistics in bf16.
    The frameworks round to bf16 at other places (XLA keeps excess
    precision inside its fusions), so, as
    ``test_bf16_lean_train_step_matches_jax``: per output, the port's bf16
    result within twice JAX's own bf16 error (2-norm) of JAX's fp32 result
    on the same bf16 inputs, plus 1e-6 of that result's norm."""
    args = _bn_inputs(seed=18)
    args = (_bf16(args[0]), *args[1:])
    ref, got = _jax_bn(mode, jnp.bfloat16, *args), _port_bn(mode, torch.bfloat16, *args)
    f32 = _jax_bn(mode, jnp.float32, *args)
    for name, a, b, c in zip(("y", "running_mean", "running_var", "dx", "dscale", "dbias"), got, ref, f32):
        bar = 2 * np.linalg.norm(b - c) + 1e-6 * np.linalg.norm(c)
        assert np.linalg.norm(a - b) <= bar, (mode, name, np.linalg.norm(a - b), bar)


def test_lean16_takes_its_statistics_in_bf16():
    """lean16 in bf16 against the semantics of JAX's ``stats_in_dtype``,
    which ``test_bn_mode_matches_jax_bf16``'s bar cannot tell from lean's
    fp32 statistics: the batch mean and biased variance are the float64
    reference rounded where bf16 arithmetic rounds (x*x, both means, mean^2,
    the difference), bitwise, and the running statistics are updated from
    them, 1e-6. lean's statistics, from the same bf16 input, lie within 1e-6
    of float64's, and lean16's differ from them by more than 1e-4. (JAX on
    the CPU keeps XLA's excess precision in the momentum update's bf16
    product, so its running statistics sit up to one bf16 step of 0.1 x the
    statistic from these.)"""
    x, _, scale, bias, mean, var = _bn_inputs(seed=18)
    x = _bf16(x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    x64 = x.astype(np.float64)
    mean64 = x64.mean(axis=(0, 1, 2))
    var64 = np.maximum((x64 * x64).mean(axis=(0, 1, 2)) - mean64 * mean64, 0)
    m16 = _rb(mean64)
    v16 = np.maximum(_rb(_rb(_rb(x64 * x64).mean(axis=(0, 1, 2))) - _rb(m16 * m16)), 0)
    got = {}
    for mode in ("lean16", "lean"):
        bn = BN(x.shape[-1], mode, torch.bfloat16)
        bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                            "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)})
        bn.train()
        stats = bn._batch_stats(xt.to(torch.bfloat16))
        got[mode] = [t.double().numpy() for t in (*stats, bn.running_mean, bn.running_var)]
    m, v, rm, rv = got["lean16"]
    np.testing.assert_array_equal(m, m16)
    np.testing.assert_array_equal(v, v16)
    np.testing.assert_allclose(rm, 0.9 * mean + _rb(0.1 * m16), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rv, 0.9 * var + _rb(0.1 * v16), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["lean"][0], mean64, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["lean"][1], var64, rtol=1e-6, atol=1e-6)
    for i in range(4):
        assert np.abs(got["lean16"][i] - got["lean"][i]).max() > 1e-4, i


def test_bn_refuses_an_unknown_mode():
    for mode in ("lean_sub0", "lean_subx", "lean_sub", "fused", "lean_subN"):
        with pytest.raises(ValueError, match="unknown bn_mode"):
            BN(4, mode, torch.float32)


# lean_subN on a spatial grid: (name, mode, rows) at S = 2, odd rows splitting unevenly.
GRID_CASES = [("sub2_odd", "lean_sub2", 9), ("sub4_even", "lean_sub4", 10), ("lean_odd", "lean", 9)]


@pytest.fixture(scope="module")
def bn_grid():
    """On two gloo ranks (S = 2), in one spawn: every GRID_CASES BN, and an
    R18 train-mode step with and without block_remat; the BN inputs."""
    import torch_dp_ranks as R

    from ihpr_tpu_torch.parallel import launch

    cases = []
    for name, mode, h in GRID_CASES:
        x, r, scale, bias, mean, var = _bn_inputs(seed=21, shape=(2, h, 3, 4))
        cases.append((name, mode, x.transpose(0, 3, 1, 2).copy(), r.transpose(0, 3, 1, 2).copy(),
                      scale, bias, mean, var))
    jcfg = _step_cfg(matmul_precision="highest", bn_mode="lean")
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    cfg = to_port_cfg(jcfg)
    model_sd = {k: v.numpy() for k, v in from_jax_params(params, stats, cfg).items()}
    jobs = [("bn", "bn_rows_ranks", (cases,)), ("remat", "remat_grid_ranks", (cfg, model_sd, _train_batch()))]
    ranks = launch.spawn(R.run_jobs, 2, "gloo", jobs)
    return cases, [r["bn"] for r in ranks], [r["remat"] for r in ranks]


@pytest.mark.parametrize("case", [c[0] for c in GRID_CASES])
def test_lean_subN_on_a_spatial_grid_matches_one_process(bn_grid, case):
    """lean_subN on an S = 2 grid picks the global rows its stride picks
    (GSPMD slices the global tensor), wherever they lie: each rank's output
    rows, dx rows, the running statistics and the summed scale / bias
    gradients equal one process's BN on the whole tensor to 1e-5."""
    from torch_dp_ranks import rows_of

    cases, ranks, _ = bn_grid
    name, mode, x, r, scale, bias, mean, var = next(c for c in cases if c[0] == case)
    bn = BN(x.shape[1], mode, torch.float32)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn.train()(xt)
    (y * torch.from_numpy(r)).sum().backward()
    for rank, got in enumerate(ranks):
        got = got[name]
        np.testing.assert_allclose(got["y"], rows_of(y.detach().numpy(), rank, 2), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], rows_of(xt.grad.numpy(), rank, 2), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["running_mean"], bn.running_mean.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["running_var"], bn.running_var.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["dscale"], bn.weight.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dbias"], bn.bias.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["full", "conv_outs"])
def test_block_remat_on_a_spatial_grid_matches_the_plain_grid(bn_grid, policy):
    """block_remat on an S = 2 grid (the recompute runs the halo exchanges
    and BN's all-reduce again inside the backward, on both ranks): every
    rank's loss, gradients and BN statistics equal those of the same grid
    without remat (1e-6 of each tensor's largest)."""
    _, _, ranks = bn_grid
    for got in ranks:
        plain, remat = got["none"], got[policy]
        assert remat["loss"] == pytest.approx(plain["loss"], rel=1e-6)
        for k, g in plain["grads"].items():
            assert _rel_err(remat["grads"][k], g) <= 1e-6, k
        for k, v in plain["stats"].items():
            np.testing.assert_allclose(remat["stats"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)


# --- the fused head's exp modes ----------------------------------------------------------------------

EXP_MODES = {"exp2": {"IHPR_EXP2": "1"}, "bexp": {"IHPR_BEXP": "1"}, "exp2_bexp": {"IHPR_EXP2": "1", "IHPR_BEXP": "1"}}


def _jax_vjp(feat, kernel, bias, g, j, d, dtype):
    """JAX's fused op and its VJP for g, as float32 numpy, in the exp modes
    the environment sets now."""
    args = [jnp.asarray(a, jnp.dtype(dtype)) for a in (feat, kernel, bias)]
    coords, vjp = jax.vjp(lambda f, k, bb: jax_fused(f, k, bb, j, d), *args)
    return np.asarray(coords, np.float32), [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]


def _np_head_bwd(feat, kernel, bias, g, j, d, w, exp2, bexp, bf16, jax_cpu=False):
    """The fused head's backward in float64 from the same inputs (feat
    (B, HW, C)), rounded where its semantics round: ``exp2`` W and b scaled
    by log2 e in fp32 and rounded to the compute dtype, the rows' ln 2, and
    dW, db times log2 e; ``bexp`` exp's argument rounded to bf16 and its
    result too; in bf16, dv rounded before both contractions and the
    outputs rounded to bf16 (fp32 otherwise). ``jax_cpu``: ``bexp`` as JAX's
    kernel computes it in interpret mode on the CPU, where XLA keeps exp's
    bf16 result in fp32 and ``jnp.exp2`` of a bf16 array is exp(bf16(ln 2 *
    a)) with ln 2 rounded to bf16."""
    b, hw, c = feat.shape
    cd = ml_dtypes.bfloat16 if bf16 else np.float32
    k, bb = kernel.astype(np.float64), bias.astype(np.float64)
    if exp2:
        k, bb = ((a.astype(np.float32) * np.float32(fhi._LOG2E)).astype(cd).astype(np.float64) for a in (kernel, bias))
    ex, lg = (np.exp2, np.log2) if exp2 else (np.exp, np.log)
    v = (feat.astype(np.float64) @ k + bb).reshape(b, hw, j, d)
    m = v.max(axis=(1, 3), keepdims=True)
    s = ex(v - m).sum(axis=(1, 3), keepdims=True)
    p = ex(v - m) / s
    x = (np.arange(hw) % w).astype(np.float64)[None, :, None, None]
    y = (np.arange(hw) // w).astype(np.float64)[None, :, None, None]
    z = np.arange(d, dtype=np.float64)[None, None, None, :]
    cx, cy, cz = ((p * t).sum(axis=(1, 3), keepdims=True) for t in (x, y, z))
    gx, gy, gz = (g.astype(np.float64)[:, None, :, i, None] * (fhi._LN2 if exp2 else 1.0) for i in range(3))
    arg = v - (m + lg(s))
    if not bexp:
        pp = ex(arg)
    elif not jax_cpu:
        pp = _rb(ex(_rb(arg)))
    else:
        pp = np.exp(_rb(_rb(fhi._LN2) * _rb(arg))) if exp2 else np.exp(_rb(arg))
    dv = (pp * (gx * (x - cx) + gy * (y - cy) + gz * (z - cz))).reshape(b, hw, j * d)
    dvc = _rb(dv) if bf16 else dv
    scale = fhi._LOG2E if exp2 else 1.0
    out = (dvc @ k.T, feat.reshape(b * hw, c).astype(np.float64).T @ dvc.reshape(b * hw, -1) * scale,
           dv.sum(axis=(0, 1)) * scale)
    return [_rb(o) if bf16 else o.astype(np.float32).astype(np.float64) for o in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [ALIGNED, PADDED], ids=["aligned", "padded"])
@pytest.mark.parametrize("mode", sorted(EXP_MODES))
def test_exp_modes_plain_match_jax_kernel(mode, shape, dtype, monkeypatch):
    """``plain`` / ``plain_bwd`` in each exp mode against jax.vjp of JAX's
    fused op with the same environment (its kernel in interpret mode; JAX
    reads the flags when it traces, the port when it is called): coords
    within 1e-5 voxel in fp32 (5e-4 in bf16, as
    ``test_plain_bwd_matches_jax_vjp``); without IHPR_BEXP, gradients
    within 1e-4 of the largest in fp32 and 1e-2 in bf16.

    IHPR_BEXP moves each gradient by one bf16 rounding of p, below those
    bars, so it is held at a bar below its own effect E (2-norm, the
    float64 reference ``_np_head_bwd`` with and without it): plain_bwd
    within E / 20 of the reference with it, and at least E / 2 from its
    own result without it. JAX's kernel is held the same way against the
    arithmetic it runs on the CPU (``jax_cpu``): E / 20 of that. The
    autograd route through ``fused_final_conv_integral`` reads the same
    environment and gives ``plain``'s results bitwise."""
    for k, v in EXP_MODES[mode].items():
        monkeypatch.setenv(k, v)
    exp2, bexp = fhi.exp_modes()
    assert (exp2, bexp) == ("exp2" in mode, "bexp" in mode)
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, seed=11)
    if dtype == "bfloat16":
        feat, kernel, bias = (_bf16(a) for a in (feat, kernel, bias))
    g = np.random.RandomState(12).randn(b, j, 3).astype(np.float32)
    coords_ref, grads_ref = _jax_vjp(feat, kernel, bias, g, j, d, dtype)
    assert np.abs(coords_ref - ((w - 1) / 2, (h - 1) / 2, (d - 1) / 2)).max() > 1.0

    tdt = getattr(torch, dtype)
    f, k, bb = (torch.from_numpy(a).to(tdt) for a in (feat.reshape(b, h * w, c), kernel, bias))
    coords, m, s = fhi.plain(f, k, bb, j, d, w, exp2)
    np.testing.assert_allclose(coords.numpy(), coords_ref, atol=1e-5 if dtype == "float32" else 5e-4)
    got = fhi.plain_bwd(f, k, bb, m, s, coords, torch.from_numpy(g), j, d, w, exp2, bexp)
    assert [t.dtype for t in got] == [tdt] * 3
    if bexp:
        args = (feat.reshape(b, h * w, c), kernel, bias, g, j, d, w, exp2)
        want, without, jax_cpu = ([r.reshape(ref.shape) for r, ref in zip(_np_head_bwd(*args, *flags), grads_ref)]
                                  for flags in ((True, dtype == "bfloat16"), (False, dtype == "bfloat16"),
                                                (True, dtype == "bfloat16", True)))
        own = fhi.plain_bwd(f, k, bb, m, s, coords, torch.from_numpy(g), j, d, w, exp2, False)
    for i, (name, a, ref) in enumerate(zip(("dfeat", "dW", "db"), got, grads_ref)):
        a = a.double().numpy().reshape(ref.shape)
        if bexp:
            effect = np.linalg.norm(want[i] - without[i])
            assert np.linalg.norm(a - want[i]) <= effect / 20, (name, np.linalg.norm(a - want[i]) / effect)
            moved = np.linalg.norm(a - own[i].double().numpy().reshape(ref.shape))
            assert moved >= effect / 2, (name, moved / effect)
            jax_effect = np.linalg.norm(jax_cpu[i] - without[i])
            assert np.linalg.norm(ref - jax_cpu[i]) <= jax_effect / 20, (name, np.linalg.norm(ref - jax_cpu[i]) / jax_effect)
        else:
            assert _rel_err(a, ref) <= (1e-4 if dtype == "float32" else 1e-2), (name, _rel_err(a, ref))

    ft = torch.from_numpy(feat).to(tdt).requires_grad_()
    kt, bt = k.clone().requires_grad_(), bb.clone().requires_grad_()
    out = fhi.fused_final_conv_integral(ft, kt, bt, j, d)
    out.backward(torch.from_numpy(g))
    assert torch.equal(out.detach(), coords)
    for a, want in zip((ft.grad.reshape(b, h * w, c), kt.grad, bt.grad), got):
        assert torch.equal(a, want)


def test_exp2_mode_keeps_the_softmax():
    """IHPR_EXP2 changes the base, not the function: in float64 the plain
    coords and gradients of both bases agree to 1e-9 (m differs by the
    factor log2 e, s is the same sum); in fp32 the base-2 coords lie within
    1e-4 voxel of float64's, as the natural base's do."""
    b, h, w, c, j, d = ALIGNED
    feat, kernel, bias = (torch.from_numpy(a).double() for a in _head_inputs(ALIGNED, seed=3))
    f = feat.reshape(b, h * w, c)
    c0, m0, s0 = fhi.plain(f, kernel, bias, j, d, w)
    c2, m2, s2 = fhi.plain(f, kernel, bias, j, d, w, exp2=True)
    np.testing.assert_allclose(c2.numpy(), c0.numpy(), atol=1e-9)
    np.testing.assert_allclose(m2.numpy(), m0.numpy() * fhi._LOG2E, rtol=1e-9)
    np.testing.assert_allclose(s2.numpy(), s0.numpy(), rtol=1e-9)
    g = torch.from_numpy(np.random.RandomState(4).randn(b, j, 3))
    want = fhi.plain_bwd(f, kernel, bias, m0, s0, c0, g, j, d, w)
    got = fhi.plain_bwd(f, kernel, bias, m2, s2, c2, g, j, d, w, exp2=True)
    for a, ref in zip(got, want):
        assert _rel_err(a.numpy(), ref.numpy()) <= 1e-9
    for exp2 in (False, True):
        c32 = fhi.plain(f.float(), kernel.float(), bias.float(), j, d, w, exp2)[0]
        np.testing.assert_allclose(c32.numpy(), c0.numpy(), atol=1e-4)


def test_base2_scale_is_jax_base2_scale():
    from ihpr_tpu.ops.fused_head_integral import _base2_scale

    for dtype in ("float32", "bfloat16"):
        kernel, bias = (_bf16(a) for a in _head_inputs(ALIGNED, seed=5)[1:])
        want = [np.asarray(a, np.float32) for a in _base2_scale(jnp.asarray(kernel, dtype), jnp.asarray(bias, dtype))]
        got = fhi.base2_scale(torch.from_numpy(kernel).to(getattr(torch, dtype)),
                              torch.from_numpy(bias).to(getattr(torch, dtype)))
        for a, ref in zip(got, want):
            np.testing.assert_array_equal(a.float().numpy(), ref)


# --- ops/integral.py's helpers -------------------------------------------------------------------------


def test_soft_argmax_2d_and_1d_and_heatmap_to_volume_match_jax():
    """soft_argmax_2d, soft_argmax_1d and heatmap_to_volume against JAX's
    (``tests/test_integral.py``): 1e-5, and the volume bitwise."""
    rng = np.random.RandomState(7)
    logits = (rng.randn(2, 3, 8, 6) * 3).astype(np.float32)
    np.testing.assert_allclose(integral.soft_argmax_2d(torch.from_numpy(logits)).numpy(),
                               np.asarray(jax_integral.soft_argmax_2d(jnp.asarray(logits))), atol=1e-5)
    peaked = np.full((1, 2, 8, 8), -5.0, np.float32)
    peaked[0, 0, 6, 1] = peaked[0, 1, 2, 5] = 20.0
    np.testing.assert_allclose(integral.soft_argmax_2d(torch.from_numpy(peaked)).numpy()[0],
                               [[1, 6], [5, 2]], atol=1e-4)
    v = (rng.randn(4, 5, 9) * 2).astype(np.float32)
    np.testing.assert_allclose(integral.soft_argmax_1d(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_integral.soft_argmax_1d(jnp.asarray(v))), atol=1e-5)
    hm = rng.randn(2, 8, 8, 4 * 8).astype(np.float32)
    vol = integral.heatmap_to_volume(torch.from_numpy(hm), 4, 8)
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jax_integral.heatmap_to_volume(jnp.asarray(hm), 4, 8)))
    np.testing.assert_allclose(integral.soft_argmax_3d(vol).numpy(),
                               np.asarray(jax_integral.soft_argmax_3d(jnp.asarray(vol.numpy()))), atol=1e-5)
    with pytest.raises(ValueError):
        integral.heatmap_to_volume(torch.from_numpy(hm), 5, 8)


def test_timer_matches_jax(monkeypatch):
    """The same tic/toc sequence on a fake clock gives JAX's Timer's
    values: the first 10 tocs out of the average."""
    import time as time_mod

    clock = iter(np.arange(0.0, 200.0, 0.5).tolist())
    ticks = []
    monkeypatch.setattr(time_mod, "perf_counter", lambda: ticks.append(next(clock)) or ticks[-1])
    ours, theirs = Timer(), JaxTimer()
    for i in range(14):
        got = []
        for t in (ours, theirs):
            t.tic()
            got.append(t.toc(average=i % 2 == 0))
        assert got[0] == got[1]
    assert (ours.calls, ours.average_time) == (theirs.calls, theirs.average_time) and ours.calls == 4
    ours.reset()
    assert ours.calls == 0 and ours.warm_up == 0


# --- SubpixelConvTranspose and the s2d stem ------------------------------------------------------------


def test_subpixel_conv_transpose_matches_deconv_and_jax():
    """The port's SubpixelConvTranspose against its Deconv on the same
    weight (1e-5) and JAX's SubpixelConvTranspose on the flax kernel the
    converter maps it to, the taps flipped (1e-5), fp32 and bf16 (one
    bf16 rounding of the output)."""
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(2, 3, 7, 5).astype(np.float32))
    k = _bf16(rng.randn(4, 4, 3, 6).astype(np.float32))  # flax (kh, kw, in, out)
    w = np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))  # the converter's deconv map
    jy = np.asarray(JaxSubpixel(6).apply({"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x.transpose(0, 2, 3, 1))))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2**-7)):
        dec, sub = Deconv(3, 6, dtype), SubpixelConvTranspose(3, 6, dtype)
        for mod in (dec, sub):
            mod.weight.data = torch.from_numpy(w)
        xt = torch.from_numpy(x).to(dtype)
        ys, yd = sub(xt), dec(xt)
        assert ys.shape == yd.shape == (2, 6, 14, 10) and ys.dtype == dtype
        assert _rel_err(ys.detach().float().numpy(), yd.detach().float().numpy()) <= tol
        assert _rel_err(ys.detach().float().permute(0, 2, 3, 1).numpy(), jy) <= tol
        if dtype == torch.float32:
            gd = torch.autograd.grad(yd.square().sum(), dec.weight)[0]
            gs = torch.autograd.grad(ys.square().sum(), sub.weight)[0]
            assert _rel_err(gs.numpy(), gd.numpy()) <= 1e-5


def _jax_backbone(s2d_stem, seed=4):
    jb = JaxBackbone(resnet_type=18, s2d_stem=s2d_stem)
    variables = jb.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    params, stats = jax.tree.map(np.asarray, variables["params"]), jax.tree.map(np.asarray, variables["batch_stats"])
    rng = np.random.RandomState(seed)

    def redraw(s):
        for name, sub in s.items():
            if name == "BatchNorm_0":
                sub["mean"] = rng.uniform(-0.3, 0.3, sub["mean"].shape).astype(np.float32)
                sub["var"] = rng.uniform(0.7, 1.3, sub["var"].shape).astype(np.float32)
            else:
                redraw(sub)

    redraw(stats)
    return jb, params, stats


def test_s2d_stem_backbone_matches_jax():
    """An s2d R18 backbone (JAX's (4, 4, 12, 64) stem through the converter)
    against JAX's in eval mode (1e-4, as ``tests/test_convert.py``'s s2d
    parity), and the port's S2DStem with a 7x7 stem embedded by
    ``s2d_stem_kernel`` (the port's copy of JAX's, equal to it) against
    the 7x7 conv (1e-5)."""
    jb, params, stats = _jax_backbone(True)
    assert params["conv1"]["kernel"].shape == (4, 4, 12, 64)
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jb.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    port = ResNetBackbone(18, torch.float32, "flax", s2d_stem=True).eval()
    assert isinstance(port.conv1, S2DStem) and tuple(port.conv1.weight.shape) == (64, 12, 4, 4)
    port.load_state_dict(jax_tree_to_state_dict("", params, stats))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    w7 = np.random.RandomState(6).randn(7, 7, 3, 64).astype(np.float32)
    embedded = s2d_stem_kernel(torch.from_numpy(w7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(embedded.permute(2, 3, 1, 0).numpy(), jax_s2d_stem_kernel(w7))
    std = ResNetBackbone(18, torch.float32, "flax").eval()
    s2d = ResNetBackbone(18, torch.float32, "flax", s2d_stem=True).eval()
    sd = std.state_dict()
    s2d.load_state_dict({**sd, "conv1.weight": s2d_stem_kernel(sd["conv1.weight"])})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert _rel_err(s2d(xt).numpy(), std(xt).numpy()) <= 1e-5


def test_s2d_stem_refuses_a_spatial_grid():
    """The s2d stem runs on row shards (``S2DStem`` with ``rows``; held to
    JAX's mesh in ``tests/test_torch_spatial.py``), and refuses, by name, a
    grid of images of an odd height, where JAX's space-to-depth reshape
    fails; an even height builds."""
    from ihpr_tpu_torch.parallel.mesh import DataParallel

    grid = DataParallel(0, 2, None, spatial=2, input_rows=63)
    with pytest.raises(ValueError, match="s2d_stem"):
        ResNetBackbone(18, torch.float32, "flax", dp=grid, s2d_stem=True)
    even = DataParallel(0, 2, None, spatial=2, input_rows=64)
    assert ResNetBackbone(18, torch.float32, "flax", dp=even, s2d_stem=True).conv1.rows_in == 64


def test_s2d_stem_converts_both_ways_and_loads_pretrained(tmp_path):
    """A PoseNet with the s2d stem: ``from_jax_params`` takes JAX's s2d
    tree and refuses a 7x7 one (and the other way round), ``to_jax_params``
    gives back JAX's (4, 4, 12, 64) kernel bitwise, a JAX s2d PoseNet gives
    the same coords as the port on the converted weights, and
    ``--pretrained`` embeds a torchvision 7x7 stem."""
    jcfg = jax_tiny_cfg(s2d_stem=True)
    cfg = to_port_cfg(jcfg)
    model, params, stats = jax_pose_weights(jcfg, seed=9)
    port = build_pose_net(cfg, device="cpu", state_dict=from_jax_params(params, stats, cfg))
    back, _ = to_jax_params(port)
    np.testing.assert_array_equal(back["backbone"]["conv1"]["kernel"], params["backbone"]["conv1"]["kernel"])
    x = np.random.RandomState(10).randn(2, 64, 64, 3).astype(np.float32)
    from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net

    jm = jax_build_pose_net(jcfg)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False,
                               method=jm.coords))
    with torch.no_grad():
        got = port.coords(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    with pytest.raises(ValueError, match="stem"):
        from_jax_params(params, stats, to_port_cfg(jax_tiny_cfg()))

    def torchvision_name(key):
        key = re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", key)
        return key.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")

    tv = {torchvision_name(k): v for k, v in
          build_pose_net(to_port_cfg(jax_tiny_cfg()), device="cpu").backbone.state_dict().items()}
    path = tmp_path / "r18.pth"
    torch.save(tv, path)
    pretrained.load_backbone(port.backbone, str(path))
    np.testing.assert_array_equal(port.backbone.conv1.weight.detach().numpy(),
                                  s2d_stem_kernel(tv["conv1.weight"]).numpy())


# --- block_remat --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def remat_steps():
    """One fp32 R18 train step (lean BN, "highest") on the same weights and
    batch: JAX's with block_remat for each policy, and the port's with each
    policy and without remat."""
    batch = _train_batch()
    out = {}
    for policy in (None, "full", "conv_outs"):
        kw = {} if policy is None else dict(block_remat=True, remat_policy=policy)
        jcfg = _step_cfg(matmul_precision="highest", bn_mode="lean", **kw)
        _, params, stats = jax_pose_weights(_step_cfg(matmul_precision="highest", bn_mode="lean"), seed=5)
        out[policy] = (None if policy is None else _jax_step(jcfg, params, stats, batch),
                       _port_step(to_port_cfg(jcfg), params, stats, batch))
    return out


@pytest.mark.parametrize("policy", ["full", "conv_outs"])
def test_block_remat_step_matches_jax_and_the_plain_step(remat_steps, policy):
    """The port's remat step against JAX's remat step at the bars of
    ``test_fp32_train_step_matches_jax`` (loss 1e-5, each gradient 2e-4 of
    its tensor's largest, running statistics 1e-5), and against the port's
    own step without remat: the same loss and gradients (1e-6 of the
    largest: the recompute repeats the forward's arithmetic) and the same
    running statistics, so the recompute left them alone."""
    ref, got = remat_steps[policy]
    _, plain = remat_steps[None]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert got["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    for k, g in got["grads"].items():
        assert _rel_err(g, ref["grads"][k]) <= 2e-4, k
        assert _rel_err(g, plain["grads"][k]) <= 1e-6, k
    for k, v in got["state"].items():
        if "running" in k:
            np.testing.assert_allclose(v, ref["state"][k], rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(v, plain["state"][k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("policy", ["full", "conv_outs"])
def test_block_remat_keeps_the_fused_routes(policy):
    """A ResNet-50 lean-BN train step with both fused flags (K5-K8's plain
    versions on the CPU) with and without remat on the same weights and
    input: the same gradients and running statistics (1e-6 of the largest):
    the fused Functions' outputs are recomputed right and BN's running
    statistics move once."""
    cfg = tconfig.get_config("h36m3d_r50").replace(
        model=tconfig.ModelConfig(bn_mode="lean", fused_1x1=True, fused_conv3=True, matmul_precision="highest"),
        data=tconfig.DataConfig(input_shape=(64, 64), output_shape=(16, 16), depth_dim=8))
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32))
    runs = []
    for kw in ({}, dict(block_remat=True, remat_policy=policy)):
        model = build_pose_net(cfg.replace(model=dataclasses.replace(cfg.model, **kw)), 18, device="cpu",
                               trainable=True)
        with model.precision():
            model.coords(x).square().sum().backward()
        runs.append(({n: p.grad.numpy() for n, p in model.named_parameters()},
                     {n: b.numpy() for n, b in model.named_buffers()}))
    (g0, b0), (g1, b1) = runs
    for n in g0:
        assert _rel_err(g1[n], g0[n]) <= 1e-6, n
    for n in b0:
        np.testing.assert_allclose(b1[n], b0[n], rtol=1e-6, atol=1e-6, err_msg=n)


def test_every_jax_mode_trains_through_the_cli(tmp_path, monkeypatch):
    """``python -m ihpr_tpu_torch.train`` on a config that turns on a
    measurement BN mode, block_remat and the s2d stem at once: one step
    with a finite loss."""
    from ihpr_tpu_torch import train as train_cli
    from ihpr_tpu_torch.utils import shutdown

    cfg = to_port_cfg(jax_tiny_cfg(bn_mode="lean_sgv", block_remat=True, remat_policy="conv_outs",
                                   s2d_stem=True)).replace(
        name="modes_tiny", optim=tconfig.OptimConfig(batch_size_per_device=2, end_epoch=1))
    monkeypatch.setitem(tconfig.CONFIGS, "modes_tiny", cfg)
    monkeypatch.setattr(shutdown, "install_graceful_shutdown", lambda: None)
    train_cli.main(["--config", "modes_tiny", "--synthetic", "--synthetic_size", "4", "--steps", "1",
                    "--device", "cpu", "--num_workers", "1", "--output_dir", str(tmp_path)])
    log = (tmp_path / "log" / "train_logs.txt").read_text()
    loss = float(log.split(" loss ")[1].split()[0])
    assert np.isfinite(loss)


# --- tools/bwd_experiments.py --------------------------------------------------------------------------


def test_bwd_experiments_runs_every_variant_on_the_cpu(tmp_path, monkeypatch, capsys):
    """A tiny CPU run of the tool: one JSON line per variant of JAX's
    VARIANTS table, each with a finite loss, its batch and step time, the
    exp variants' environment restored after them."""
    import importlib.util
    import os

    from ihpr_tpu_torch.tools import bwd_experiments

    spec = importlib.util.spec_from_file_location("jax_bwd_experiments", "tools/bwd_experiments.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert list(bwd_experiments.VARIANTS) == list(jax_tool.VARIANTS)
    assert bwd_experiments.VARIANTS == jax_tool.VARIANTS

    cfg = to_port_cfg(jax_tiny_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)).replace(
        optim=tconfig.OptimConfig(batch_size_per_device=2))
    monkeypatch.setattr(bwd_experiments, "base_config", lambda: cfg)
    monkeypatch.delenv("IHPR_EXP2", raising=False)
    monkeypatch.delenv("IHPR_BEXP", raising=False)
    out = tmp_path / "bwd.jsonl"
    bwd_experiments.main(["--device", "cpu", "--steps", "1", "--warmup", "0", "--batch_scale", "0.02",
                          "--output", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["variant"] for x in lines] == list(jax_tool.VARIANTS)
    for x in lines:
        assert np.isfinite(x["loss"]) and x["step_ms"] > 0 and x["batch"] >= 1, x
    assert {x["variant"]: x["batch"] for x in lines}["lean_b192"] > {x["variant"]: x["batch"] for x in lines}["lean_b96"]
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == lines
    assert "IHPR_EXP2" not in os.environ and "IHPR_BEXP" not in os.environ
