"""The port's training slice against the JAX package, on the CPU.

Same numpy inputs and the same weights (``from_jax_params``) go through the
JAX function and its port: the fused head backward (the JAX Pallas kernel
in interpret mode, IHPR_PALLAS=interpret from conftest), train-mode BN, the
loss, the schedule and optimizer, one whole train step in fp32 and in
bf16, the host-warp BatchLoader and the Trainer. Sizes are small: ResNet-18,
64x64 input, 16x16x16 heatmaps, batch 2. Every comparison that involves
coordinates asserts they are away from the volume centre (flat heatmaps
put every coordinate there, where any two implementations agree).

Tolerances (PARITY.md: 1e-3 to 1e-4 for activations, 2e-3 voxel for
coords): each is stated where it is used, relative to the largest
magnitude of the reference unless said otherwise.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import pipeline as jpipeline
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.models.resnet import _BN as JaxBN
from ihpr_tpu.ops.fused_head_integral import fused_final_conv_integral as jax_fused
from ihpr_tpu.ops.loss import joint_location_loss as jax_loss
from ihpr_tpu.ops.loss import joint_location_loss_components as jax_loss_components
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.parallel import make_train_step as jax_make_train_step
from ihpr_tpu.parallel.train_step import make_lr_schedule as jax_lr_schedule
from ihpr_tpu.parallel.train_step import make_optimizer as jax_make_optimizer
from ihpr_tpu_torch import train as train_cli
from ihpr_tpu_torch.data import datasets, pipeline, skeletons
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.models.resnet import BN
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops.loss import joint_location_loss, joint_location_loss_components
from ihpr_tpu_torch.parallel.train_step import (
    OptaxAdam,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from test_torch_ops import ALIGNED, PADDED, _bf16, _head_inputs
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- the fused head backward ------------------------------------------------


def _jax_vjp(feat, kernel, bias, g, j, d, dtype):
    args = [jnp.asarray(a, dtype) for a in (feat, kernel, bias)]
    coords, vjp = jax.vjp(lambda f, k, b: jax_fused(f, k, b, j, d), *args)
    return np.asarray(coords, np.float32), [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [ALIGNED, PADDED], ids=["aligned", "padded"])
def test_plain_bwd_matches_jax_vjp(shape, dtype):
    """plain_bwd (with plain's m, s, coords) against jax.vjp of the JAX fused
    op. fp32: 1e-4 of the largest gradient (exp and sum order only). bf16:
    both round dv to bf16 before the contractions and every result to bf16
    (2^-8 relative), and the JAX kernel's shared max can flip a bf16
    rounding of dv, so 1e-2."""
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, seed=11)
    if dtype == "bfloat16":
        feat, kernel, bias = (_bf16(a) for a in (feat, kernel, bias))
    g = np.random.RandomState(12).randn(b, j, 3).astype(np.float32)
    coords_ref, grads_ref = _jax_vjp(feat, kernel, bias, g, j, d, jnp.dtype(dtype))
    assert np.abs(coords_ref - ((w - 1) / 2, (h - 1) / 2, (d - 1) / 2)).max() > 1.0

    tdt = getattr(torch, dtype)
    f, k, bb = (torch.from_numpy(a).to(tdt) for a in (feat.reshape(b, h * w, c), kernel, bias))
    coords, m, s = fhi.plain(f, k, bb, j, d, w)
    np.testing.assert_allclose(coords.numpy(), coords_ref, atol=5e-4)
    got = fhi.plain_bwd(f, k, bb, m, s, coords, torch.from_numpy(g), j, d, w)
    assert [t.dtype for t in got] == [tdt] * 3
    tol = 1e-4 if dtype == "float32" else 1e-2
    for name, a, ref in zip(("dfeat", "dW", "db"), got, grads_ref):
        assert _rel_err(a.float().numpy().reshape(ref.shape), ref) <= tol, name


def test_fused_autograd_matches_autograd_through_plain():
    """FusedHeadIntegral's backward (plain_bwd on the CPU) against autograd
    through the plain forward: 1e-5 of the largest gradient (fp32, two
    orders of the same sums)."""
    b, h, w, c, j, d = PADDED
    arrays = _head_inputs(PADDED, seed=13)
    g = torch.from_numpy(np.random.RandomState(14).randn(b, j, 3).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    coords = fhi.FusedHeadIntegral.apply(leaves[0].reshape(b, h * w, c), *leaves[1:], j, d, w, True)
    fused = torch.autograd.grad(coords, leaves, g)
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ref = torch.autograd.grad(
        fhi.plain(ref_leaves[0].reshape(b, h * w, c), *ref_leaves[1:], j, d, w)[0], ref_leaves, g
    )
    assert float((coords.detach() - coords.detach().mean()).abs().max()) > 1.0
    for a, r in zip(fused, ref):
        assert _rel_err(a.numpy(), r.numpy()) <= 1e-5


def test_fused_autograd_gradcheck_float64():
    """FusedHeadIntegral itself (fp64 routes fused_final_conv_integral to
    the no-plan path, which test_torch_integral.py gradchecks)."""
    b, h, w, c, j, d = 2, 3, 4, 8, 3, 5
    rng = np.random.RandomState(15)
    leaves = [
        torch.from_numpy(rng.randn(*shape) * scale).requires_grad_()
        for shape, scale in (((b, h * w, c), 0.5), ((c, j * d), 1.0), ((j * d,), 0.1))
    ]
    assert torch.autograd.gradcheck(
        lambda f, k, bb: fhi.FusedHeadIntegral.apply(f, k, bb, j, d, w, True), leaves
    )


def test_fused_saves_nothing_without_grad(monkeypatch):
    saved = []
    orig = torch.autograd.function.FunctionCtx.save_for_backward
    monkeypatch.setattr(torch.autograd.function.FunctionCtx, "save_for_backward",
                        lambda self, *t: (saved.append(len(t)), orig(self, *t)))
    b, h, w, c, j, d = ALIGNED
    feat, kernel, bias = (torch.from_numpy(a).requires_grad_() for a in _head_inputs(ALIGNED))
    feat = feat.reshape(b, h * w, c)

    def run():  # FusedHeadIntegral as heads with a fused plan reach it
        return fhi.FusedHeadIntegral.apply(feat, kernel, bias, j, d, w, torch.is_grad_enabled())

    with torch.no_grad():
        run()
    with torch.inference_mode():
        run()
    assert saved == []
    run()
    assert saved == [6]


def test_kernel_bwd_takes_cuda_tensors_only():
    b, h, w, c, j, d = ALIGNED
    feat, kernel, bias = (torch.from_numpy(a) for a in _head_inputs(ALIGNED))
    feat = feat.reshape(b, h * w, c)
    coords, m, s = fhi.plain(feat, kernel, bias, j, d, w)
    fhi.bwd_launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        fhi.kernel_bwd(feat, kernel, bias, m, s, coords, torch.zeros_like(coords), j, d, w)
    assert fhi.bwd_launches == 0


# --- train-mode BatchNorm -----------------------------------------------------


@pytest.mark.parametrize("mode", ["flax", "lean"])
def test_bn_train_mode_matches_jax(mode):
    """Output, running statistics and the gradient of a scalar (x, scale,
    bias) against the JAX _BN in train mode, fp32: 1e-5."""
    rng = np.random.RandomState(16)
    b, h, w, c = 3, 5, 4, 6
    x = (rng.randn(b, h, w, c) * 2 + 0.5).astype(np.float32)
    r = rng.randn(b, h, w, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    jbn = JaxBN(jnp.float32, mode)
    params = {"BatchNorm_0": {"scale": scale, "bias": bias}}
    stats = {"BatchNorm_0": {"mean": mean, "var": var}}

    def f(xx, p):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd)

    (_, (y_ref, upd)), (gx_ref, gp_ref) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params
    )

    bn = BN(c, mode, torch.float32)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)})
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    (y.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_ref, rtol=1e-5, atol=1e-5)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), gp_ref["BatchNorm_0"]["scale"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), gp_ref["BatchNorm_0"]["bias"], rtol=1e-5, atol=1e-5)


def test_bn_train_uses_batch_stats_and_updates_running_ones():
    """train(): normalize with the batch's biased statistics and move the
    running ones to 0.9 old + 0.1 batch; eval(): the running ones, unchanged."""
    x = torch.from_numpy(np.random.RandomState(17).randn(4, 3, 5, 5).astype(np.float32) * 3 + 1)
    bn = BN(3, "lean", torch.float32)
    bn.train()
    y = bn(x)
    mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
    ref = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-6)
    bn.eval()
    before = bn.running_mean.clone()
    y = bn(x)
    torch.testing.assert_close(y, (x - before[:, None, None]) / torch.sqrt(bn.running_var + 1e-5)[:, None, None])
    assert torch.equal(bn.running_mean, before)


# --- loss, schedule, optimizer --------------------------------------------------


def test_loss_and_components_match_jax():
    rng = np.random.RandomState(18)
    coords = rng.uniform(0, 16, (3, 18, 3)).astype(np.float32)
    gt = rng.uniform(0, 16, (3, 18, 3)).astype(np.float32)
    vis = (rng.rand(3, 18) > 0.3).astype(np.float32)
    hd = np.array([1.0, 0.0, 1.0], np.float32)
    args = [torch.from_numpy(a) for a in (coords, gt, vis, hd)]
    jargs = [jnp.asarray(a) for a in (coords, gt, vis, hd)]
    np.testing.assert_allclose(float(joint_location_loss(*args)), float(jax_loss(*jargs)), rtol=1e-6)
    for a, b in zip(joint_location_loss_components(*args), jax_loss_components(*jargs)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # Invisible joints stay in the denominator: all-invisible gives 0, not NaN.
    assert float(joint_location_loss(args[0], args[1], torch.zeros_like(args[2]), args[3])) == 0.0


def _optim_cfg(**kw):
    return jconfig.get_config("h36m3d_r50").replace(
        optim=jconfig.OptimConfig(lr=1e-3, lr_dec_epoch=(17, 21), lr_dec_factor=10.0, **kw)
    )


def test_lr_schedule_matches_optax_across_boundaries():
    """Update k (from 0) runs at the optax schedule's lr(k): the first
    decayed update is the boundary itself (count >= boundary), checked both
    on make_lr_schedule and on the LambdaLR driving the optimizer."""
    jcfg = _optim_cfg()
    steps_per_epoch = 3  # boundaries at updates 51 and 63
    ref = jax_lr_schedule(jcfg, steps_per_epoch)
    sched = make_lr_schedule(to_port_cfg(jcfg), steps_per_epoch)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = OptaxAdam([p], lr=jcfg.optim.lr)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: sched(k) / jcfg.optim.lr)
    for k in range(70):
        want = float(ref(k))
        assert sched(k) == pytest.approx(want, rel=1e-6), k
        assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-6), k
        p.grad = torch.ones(2)
        opt.step()
        lr_sched.step()
    assert sched(50) == pytest.approx(1e-3) and sched(51) == pytest.approx(1e-4)
    assert sched(63) == pytest.approx(1e-5)


def test_adam_with_clip_and_decay_matches_optax():
    """Three updates of optax.chain(clip_by_global_norm, adam,
    add_decayed_weights(-wd)) against OptaxAdam: the decay is not scaled by
    the lr (p moves by wd * p per step on top of Adam). 1e-6 relative."""
    jcfg = _optim_cfg(grad_clip_norm=0.5, weight_decay=0.01)
    rng = np.random.RandomState(19)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 2).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_make_optimizer(jcfg, 100)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, _ = make_optimizer(torch.nn.ParameterDict(tp), to_port_cfg(jcfg), 100)
    for g in grads:
        assert np.sqrt(sum((x**2).sum() for x in g.values())) > 0.5  # clipping is active
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# --- one whole train step -------------------------------------------------------


def _train_batch(b=2, j=18, seed=20):
    rng = np.random.RandomState(seed)
    return {
        "patch": rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8),
        "color_scale": rng.uniform(0.8, 1.2, (b, 3)).astype(np.float32),
        "joint_img": rng.uniform(0, 16, (b, j, 3)).astype(np.float32),
        "joint_vis": (rng.rand(b, j) > 0.2).astype(np.float32),
        "joints_have_depth": np.array([1.0, 0.0], np.float32)[:b],
    }


def _step_cfg(**model_kw):
    return jax_tiny_cfg(**model_kw).replace(optim=jconfig.OptimConfig(batch_size_per_device=2, lr=1e-3))


def _finalize(batch, cfg):
    from ihpr_tpu_torch.data.augment import finalize_patch

    return finalize_patch(torch.from_numpy(batch["patch"]), torch.from_numpy(batch["color_scale"]), cfg.data)


def _port_step(cfg, params, stats, batch):
    """One port train step from the JAX weights: loss, grad norm, every
    parameter's gradient, the state after the step, and the coords the
    model gave before it (train mode, on a copy)."""
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict=from_jax_params(params, stats, cfg))
    with torch.no_grad():
        coords = copy.deepcopy(model).coords(_finalize(batch, cfg))
    opt, sched = make_optimizer(model, cfg, 10)
    out = make_train_step(model, opt, cfg, scheduler=sched)(
        {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    return {
        "loss": float(out["loss"]),
        "grad_norm": float(out["grad_norm"]),
        "grads": {k: p.grad.numpy() for k, p in model.named_parameters()},
        "state": {k: v.numpy() for k, v in model.state_dict().items()},
        "coords": coords,
    }


def _jax_step(jcfg, params, stats, batch):
    """The same step through the JAX make_train_step, in the port's layout."""
    jmodel = build_jax_model(jcfg)
    state, tx = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 10, params=params, batch_stats=stats)
    step = jax_make_train_step(jmodel, tx, jcfg, donate=False, debug_grads=True)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    cfg = to_port_cfg(jcfg)
    to_np = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    as_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    return {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "grads": as_np(from_jax_params(to_np(metrics["grads"]), stats, cfg)),
        "state": as_np(from_jax_params(to_np(new_state.params), to_np(new_state.batch_stats), cfg)),
    }


def build_jax_model(jcfg):
    from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net

    return jax_build_pose_net(jcfg)


@pytest.fixture(scope="module")
def fp32_steps():
    """fp32, "highest", lean BN: JAX step, port step, and the port step with
    flax BN (the same arithmetic at fp32) on the same weights and batch."""
    jcfg = _step_cfg(matmul_precision="highest", bn_mode="lean")
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    batch = _train_batch()
    flax_cfg = to_port_cfg(_step_cfg(matmul_precision="highest", bn_mode="flax"))
    return (_jax_step(jcfg, params, stats, batch), _port_step(to_port_cfg(jcfg), params, stats, batch),
            _port_step(flax_cfg, params, stats, batch))


@pytest.fixture(scope="module")
def bf16_steps():
    """The flagship dtypes: JAX step and port step in bf16 with lean BN, and
    the port's fp32 step on the same weights and batch."""
    jcfg = _step_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)
    _, params, stats = jax_pose_weights(jcfg, seed=6)
    batch = _train_batch()
    fp32_cfg = to_port_cfg(_step_cfg(matmul_precision="highest", bn_mode="lean"))
    return (_jax_step(jcfg, params, stats, batch), _port_step(to_port_cfg(jcfg), params, stats, batch),
            _port_step(fp32_cfg, params, stats, batch))


def test_fp32_train_step_matches_jax(fp32_steps):
    """fp32 ("highest", lean BN in train mode, the whole step: finalize_patch,
    forward, fused head op, loss, backward, Adam). Loss within 1e-5
    relative; every parameter gradient within 2e-4 of its tensor's largest
    gradient (XLA and oneDNN sum the convs in other orders; measured up to
    5e-5); batch stats within 1e-5. Updated parameters: Adam's first step
    moves each by lr * g / (|g| + eps), a sign for any gradient above eps,
    so they are compared where the gradient is above 1e-2 of its tensor's
    largest (1e-6 absolute), and everywhere within 2 lr. The port's flax BN
    gives the same step as its lean BN (1e-4 of the largest gradient)."""
    ref, got, flax = fp32_steps
    assert float((got["coords"] - 7.5).abs().max()) > 1.0  # away from the volume centre
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    assert set(got["grads"]) == {k for k in ref["grads"] if "running" not in k}
    for k, g in got["grads"].items():
        assert _rel_err(g, ref["grads"][k]) <= 2e-4, k
        assert _rel_err(flax["grads"][k], g) <= 1e-4, k
    for k, v in got["state"].items():
        want = ref["state"][k]
        if "running" in k:
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        grad = ref["grads"][k]
        big = np.abs(grad) > 1e-2 * np.abs(grad).max()
        np.testing.assert_allclose(v[big], want[big], rtol=0, atol=1e-6, err_msg=k)
        assert np.abs(v - want).max() <= 2e-3 + 1e-6, k


def test_bf16_lean_train_step_matches_jax(bf16_steps):
    """The flagship dtypes (bf16 convs, lean BN, bf16 logits). The frameworks
    round to bf16 at other places (XLA keeps excess precision inside its
    fusions), and at this size train-mode BN over 2x2x2 values amplifies
    that: each framework's bf16 gradients sit up to ~0.65 (norm-relative)
    from fp32 here. So: loss within 2e-2 relative; per tensor,
    |g_port - g_jax| <= 2 |g_jax - g_fp32| in the 2-norm (two independent
    bf16 errors give sqrt 2); batch stats within 2e-2 absolute (statistics of
    bf16 activations over as few as 8 values); and fp32
    gradients for the fp32 masters."""
    ref, got, fp32 = bf16_steps
    assert float((got["coords"] - 7.5).abs().max()) > 1.0
    assert got["loss"] == pytest.approx(ref["loss"], rel=2e-2)
    for k, g in got["grads"].items():
        assert g.dtype == np.float32, k
        r, f = ref["grads"][k], fp32["grads"][k]
        assert np.linalg.norm(g - r) <= 2 * np.linalg.norm(r - f), k
    for k, v in got["state"].items():
        if "running" in k:
            np.testing.assert_allclose(v, ref["state"][k], rtol=0, atol=2e-2, err_msg=k)


def test_highest_precision_covers_the_backward():
    """In a "highest" config, TF32 is off for cuDNN and matmuls while the
    backward runs (a gradient hook records both flags), and the flags are
    restored after the step."""
    jcfg = jax_tiny_cfg(matmul_precision="highest").replace(
        optim=jconfig.OptimConfig(batch_size_per_device=2)
    )
    cfg = to_port_cfg(jcfg)
    model = build_pose_net(cfg, device="cpu", trainable=True)
    flags = []
    model.backbone.conv1.weight.register_hook(
        lambda g: flags.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    )
    opt, _ = make_optimizer(model, cfg, 10)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        make_train_step(model, opt, cfg, lean=True)(
            {k: torch.from_numpy(v) for k, v in _train_batch().items()}
        )
        assert flags == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def test_inference_copy_casts_once_and_leaves_the_model():
    cfg = to_port_cfg(jax_tiny_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False))
    model = build_pose_net(cfg, device="cpu", trainable=True)
    frozen = inference_copy(model)
    assert frozen.backbone.conv1.weight.dtype == torch.bfloat16
    assert frozen.head.final.weight.dtype == torch.bfloat16
    assert not frozen.training and not any(p.requires_grad for p in frozen.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    x = torch.from_numpy(np.random.RandomState(21).randn(1, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(frozen.coords(x), model.eval().coords(x), rtol=0, atol=0)


# --- data: synthetic datasets, the host-warp loader, the Trainer --------------


def _data_cfgs(**kw):
    jcfg = jconfig.get_config("h36m3d_r50").replace(
        data=jconfig.DataConfig(input_shape=(64, 64), output_shape=(16, 16), depth_dim=16, **kw)
    )
    return jcfg, to_port_cfg(jcfg)


def test_transform_joint_to_other_db_matches_jax():
    x = np.random.RandomState(22).randn(2, 16, 3).astype(np.float32)
    out = skeletons.transform_joint_to_other_db(x, skeletons.MPII, skeletons.H36M)
    ref = jskeletons.transform_joint_to_other_db(x, jskeletons.MPII, jskeletons.H36M)
    assert out.shape == (2, 18, 3)
    np.testing.assert_array_equal(out, ref)


def test_synthetic_datasets_match_jax():
    jcfg, cfg = _data_cfgs()
    for name, hue in (("Human36M", None), ("MPII", "Human36M")):
        ds = datasets.build_dataset(name, "train", cfg, "synthetic", 6,
                                    hue_skeleton=hue and skeletons.get_skeleton(hue))
        ref = jdatasets.build_dataset(name, "train", jcfg, "synthetic", 6,
                                      hue_skeleton=hue and jskeletons.get_skeleton(hue))
        assert len(ds) == len(ref) == 6
        for a, b in zip(ds.samples, ref.samples):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            np.testing.assert_array_equal(
                datasets.render_synthetic_image(a), jdatasets.render_synthetic_image(b)
            )
    for build, c in ((datasets.build_dataset, cfg), (jdatasets.build_dataset, jcfg)):
        with pytest.raises(FileNotFoundError, match="synthetic"):  # a real root that is not there
            build("Human36M", "train", c, "no/such/root")


def test_batch_loader_matches_jax():
    """Same seed, same synthetic H36M+MPII datasets, augmentation on: the
    port's batches equal the JAX host-warp loader's (same draws, affines,
    native warp and joint transforms)."""
    jcfg, cfg = _data_cfgs()
    h36m = jskeletons.get_skeleton("Human36M")
    jds = [jdatasets.build_dataset("Human36M", "train", jcfg, "synthetic", 8),
           jdatasets.build_dataset("MPII", "train", jcfg, "synthetic", 8, hue_skeleton=h36m)]
    tds = [datasets.build_dataset("Human36M", "train", cfg, "synthetic", 8),
           datasets.build_dataset("MPII", "train", cfg, "synthetic", 8,
                                  hue_skeleton=skeletons.get_skeleton("Human36M"))]
    ref = jpipeline.BatchLoader(jds, jcfg, 4, train=True, num_workers=0, seed=3, host_warp=True)
    loader = pipeline.BatchLoader(tds, cfg, 4, num_workers=0, seed=3)
    assert len(loader) == len(ref) == 4
    for epoch in (0, 1):
        for a, b in zip(loader.epoch(epoch, 2), ref.epoch(epoch, 2)):
            for f in ("patch", "color_scale", "joint_vis", "joints_have_depth", "sample_idx"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            np.testing.assert_allclose(a.joint_img, b.joint_img, rtol=0, atol=1e-5)
            assert a.patch.shape == (4, 64, 64, 3) and a.joint_img.shape == (4, 18, 3)
    assert sorted(set(np.concatenate([b.joints_have_depth for b in loader.epoch(0)]))) == [0.0, 1.0]
    dev, idx = next(pipeline.prefetch_to_device(loader.epoch(0, 1), "cpu"))
    assert dev["patch"].dtype == torch.uint8 and dev["joint_img"].shape == (4, 18, 3)
    assert idx.shape == (4,)


def _tiny_trainer(samples, output_dir, **optim):
    """A Trainer on the CPU (flagship dtypes at a tiny size) over a fixed
    set of synthetic samples, batch 4, no augmentation, writing its log and
    snapshots under ``output_dir``; ``optim`` overrides fields of the
    optimizer config. Returns (trainer, JAX config)."""
    jcfg = jax_tiny_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)
    jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim, batch_size_per_device=4, **optim),
                        output_dir=str(output_dir))
    cfg = to_port_cfg(jcfg)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, use_aug=False))
    ds = datasets.PoseDataset(
        "Human36M", skeletons.H36M,
        datasets.make_synthetic(skeletons.H36M, samples, seed=0, img_size=200), is_train=True,
    )
    return Trainer(cfg, datasets=[ds], num_workers=0, device="cpu"), jcfg


def test_trainer_takes_steps_with_a_falling_loss(tmp_path):
    """Five one-step epochs of the Trainer on one fixed batch of four
    synthetic samples: finite, falling loss; the step counter follows, and
    ``losses`` holds the current epoch's loss after each. From JAX's
    initial weights (the Trainer's draw) this batch's loss rises at the
    second step in both packages and falls from the fourth (measured: the
    port 2.574, 2.597, 2.582, 2.384, 2.298; JAX's Trainer 2.574, 2.588,
    2.551, 2.362, 2.273), so three steps do not show the fall."""
    trainer, _ = _tiny_trainer(4, tmp_path, lr=1e-2)
    losses = []
    try:
        assert trainer.steps_per_epoch == 1
        for end in (1, 2, 3, 4, 5):
            state = trainer.train(end)
            assert len(trainer.losses) == 1
            losses += [float(x) for x in trainer.losses]
    finally:
        trainer.close()
    assert state.step == 5 and len(losses) == 5
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_trainer_losses_hold_one_epoch(tmp_path):
    """Two epochs of two steps leave the second epoch's two losses, not all
    four: the history does not grow with the run."""
    trainer, _ = _tiny_trainer(8, tmp_path)
    try:
        assert trainer.steps_per_epoch == 2
        state = trainer.train(2)
    finally:
        trainer.close()
    assert state.step == 4 and len(trainer.losses) == 2
    assert all(np.isfinite(float(x)) for x in trainer.losses)


def test_trainer_logs_the_jax_learning_rate_at_a_decay_boundary(caplog, tmp_path):
    """The log line's lr is the schedule at the step count after the
    update, as the JAX trainer logs it: with a decay after epoch 1 of one
    step, the first line already shows the decayed rate."""
    trainer, jcfg = _tiny_trainer(4, tmp_path, lr=1e-3, lr_dec_epoch=(1,))
    trainer.logger.addHandler(caplog.handler)  # the train log does not propagate
    try:
        trainer.train(2)
    finally:
        trainer.logger.removeHandler(caplog.handler)
        trainer.close()
    logged = [r.args[4] for r in caplog.records if r.msg.startswith("epoch %d/%d itr")]
    ref = jax_lr_schedule(jcfg, trainer.steps_per_epoch)
    want = [float(ref(step)) for step in (1, 2)]
    assert want[0] < jcfg.optim.lr  # step 1 is past the boundary
    np.testing.assert_allclose(logged, want, rtol=1e-6)


def test_train_cli_rejects_what_is_not_ported():
    """Every flag of train.py is ported now: --pretrained, a real --data_root,
    --multihost, --shard_opt_state and --spatial (tests/test_torch_dp.py runs
    the third and fourth, tests/test_torch_datasets.py the first two,
    tests/test_torch_spatial.py the last); an unknown flag is refused."""
    args = train_cli.parse_args(["--config", "h36m3d_r50", "--synthetic", "--steps", "3"])
    assert args.steps == 3 and args.synthetic
    assert train_cli.parse_args(["--synthetic", "--spatial", "2"]).spatial == 2
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--synthetic", "--vis"])
    assert train_cli.parse_args(["--synthetic", "--pretrained", "x.msgpack"]).pretrained == "x.msgpack"
    for flag in ("--multihost", "--shard_opt_state"):
        assert getattr(train_cli.parse_args(["--synthetic", flag]), flag[2:])
    assert train_cli.parse_args(["--data_root", "/data/Human36M"]).data_root == "/data/Human36M"
