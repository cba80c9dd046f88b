"""``h36m3d_r152_384``'s model in the port against the JAX package on the CPU:
ResNet-152 at its real depth (3/8/36/3 Bottlenecks) and widths, the
config's head (3 deconvs of 256, J=18), fp32 "highest" with lean BN, at a
small NON-SQUARE input: 128x96 patches, 32x24 heatmaps, D=16, batch 2.
The same weights go JAX -> port through ``from_jax_params``; coords (the
fused op's plain version and ``coords_plain``) and the flip-test eval step
are held to the bars of the R18 tests (test_torch_models,
test_torch_eval), one whole train step on random patches to the R18
step's bars for the loss and BN statistics and by norms for the
gradients (see its test).

The weights are test_torch_models' recipe (BN statistics, deconvs and the
final conv redrawn) with each Bottleneck's last BN scale (bn3) times
RESIDUAL_SCALE, as a deep ResNet is initialized to train (residual
branches start small; torchvision's ``zero_init_residual`` sets them to
0). With all 50 residual branches at full scale the residual stream grows
through layer3's 36 blocks and the train-mode step becomes chaotic in
both packages alike (test_full_scale_residuals_make_the_step_chaotic): a
1e-7 relative weight perturbation moves the port's own train-mode coords
by more than 1e-2 voxel, so no two fp32 implementations could be held to
the R18 bars (the loss alone differs by ~4e-4 relative between the
packages); at RESIDUAL_SCALE it moves them by less than 1e-3.

One JAX build of each function (coords, train step, eval step), module-
scoped; JAX's K1 runs in interpret mode (conftest).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.parallel import make_eval_step as jax_make_eval_step
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.parallel.train_step import make_eval_step
from test_torch_models import jax_pose_weights, to_port_cfg
from test_torch_train import _jax_step, _port_step

torch.set_num_threads(1)

BATCH = 2
IN_H, IN_W, OUT_H, OUT_W, DEPTH = 128, 96, 32, 24, 16
CENTRE = np.array([(OUT_W - 1) / 2, (OUT_H - 1) / 2, (DEPTH - 1) / 2], np.float32)
RESIDUAL_SCALE = 0.1


def _jcfg():
    base = jconfig.get_config("h36m3d_r152_384")
    return base.replace(
        model=dataclasses.replace(base.model, compute_dtype="float32", matmul_precision="highest"),
        data=jconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(IN_H, IN_W),
                                output_shape=(OUT_H, OUT_W), depth_dim=DEPTH),
        optim=jconfig.OptimConfig(batch_size_per_device=BATCH, lr=1e-3),
        eval=dataclasses.replace(base.eval, batch_size_per_device=BATCH),
        parallel=dataclasses.replace(base.parallel, data_axis_size=1),
    )


@pytest.fixture(scope="module")
def r152():
    """The JAX model, its weights (numpy) and the port's model on them."""
    jcfg = _jcfg()
    jmodel, params, stats = jax_pose_weights(jcfg, seed=5)
    params = jax.tree.map(np.copy, params)
    for layer in params["backbone"].values():
        if "bn3" in layer:
            layer["bn3"]["BatchNorm_0"]["scale"] = layer["bn3"]["BatchNorm_0"]["scale"] * RESIDUAL_SCALE
    cfg = to_port_cfg(jcfg)
    model = build_pose_net(cfg, device="cpu", state_dict=from_jax_params(params, stats, cfg))
    return jcfg, cfg, jmodel, params, stats, model


def _patches(seed):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, IN_H, IN_W, 3)).astype(np.uint8)


def _batch(seed=20):
    rng = np.random.RandomState(seed)
    scale = np.array([OUT_W, OUT_H, DEPTH], np.float32)
    return {
        "patch": _patches(seed),
        "color_scale": rng.uniform(0.8, 1.2, (BATCH, 3)).astype(np.float32),
        "joint_img": (rng.uniform(0, 1, (BATCH, 18, 3)) * scale).astype(np.float32),
        "joint_vis": (rng.rand(BATCH, 18) > 0.2).astype(np.float32),
        "joints_have_depth": np.array([1.0, 0.0], np.float32),
    }


def test_r152_config_matches_jax():
    """The port's h36m3d_r152_384 is JAX's, field for field: ResNet-152, bf16
    lean BN, 384x288 -> 96x72x64, batch 32; its head takes K1/K2."""
    jcfg = jconfig.get_config("h36m3d_r152_384")
    cfg = tconfig.get_config("h36m3d_r152_384")
    assert cfg == to_port_cfg(jcfg)
    assert (cfg.model.resnet_type, cfg.data.input_shape, cfg.data.output_shape) == (152, (384, 288), (96, 72))
    assert cfg.optim.batch_size_per_device == 32
    h, w = cfg.data.output_shape
    assert fhi.fused_supported(18, cfg.data.depth_dim, h * w, cfg.model.deconv_channels, torch.bfloat16)


def test_r152_coords_match_jax(r152):
    """Eval-mode coords through the fused op (its plain version on the CPU)
    and coords_plain, against JAX's coords (K1 in interpret mode): 2e-3
    voxel, the end-to-end bar. The volume is 32 rows by 24 columns (centre
    x 11.5, y 15.5), so a swapped x / y would show."""
    _, _, jmodel, params, stats, model = r152
    x = np.random.RandomState(1).randn(BATCH, IN_H, IN_W, 3).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda p, s, v: jmodel.apply({"params": p, "batch_stats": s}, v, train=False, method=jmodel.coords)
    )(params, stats, x))
    assert ref.shape == (BATCH, 18, 3)
    assert np.abs(ref - CENTRE).max() > 1.0  # peaked heatmaps, not the volume centre
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        coords, plain = model.coords(xt).numpy(), model.coords_plain(xt).numpy()
    np.testing.assert_allclose(coords, ref, atol=2e-3)
    np.testing.assert_allclose(plain, ref, atol=2e-3)


def _train_coords(cfg, state_dict, batch, perturb):
    """Train-mode coords of the port model on ``state_dict`` with each
    weight times (1 + perturb * N(0, 1)), seeded."""
    g = torch.Generator().manual_seed(1)
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict={
        k: v * (1 + perturb * torch.randn(v.shape, generator=g)) if k.endswith(("weight", "bias")) else v
        for k, v in state_dict.items()
    })
    from ihpr_tpu_torch.data.augment import finalize_patch

    image = finalize_patch(torch.from_numpy(batch["patch"]), torch.from_numpy(batch["color_scale"]), cfg.data)
    with torch.no_grad(), model.precision():
        return model.coords(image)


def test_full_scale_residuals_make_the_step_chaotic(r152):
    """Why the weights scale bn3: the port's train-mode coords moved by a
    1e-7 relative weight perturbation, with every residual branch at full
    scale (> 1e-2 voxel: chaos) and at RESIDUAL_SCALE (< 1e-3 voxel)."""
    _, cfg, _, _, _, model = r152
    batch = _batch()
    scaled = model.state_dict()
    full = {k: v / RESIDUAL_SCALE if k.endswith("bn3.weight") else v for k, v in scaled.items()}
    moved = {}
    for name, sd in (("full", full), ("scaled", scaled)):
        moved[name] = float((_train_coords(cfg, sd, batch, 1e-7) - _train_coords(cfg, sd, batch, 0.0)).abs().max())
    assert moved["full"] > 1e-2 and moved["scaled"] < 1e-3, moved


@pytest.fixture(scope="module")
def steps(r152):
    jcfg, cfg, _, params, stats, _ = r152
    batch = _batch()
    return _jax_step(jcfg, params, stats, batch), _port_step(cfg, params, stats, batch)


def test_r152_fp32_train_step_matches_jax(steps):
    """One whole fp32 train step (finalize_patch, train-mode lean BN over
    2x4x3 values at layer4, the fused head op, loss, backward, Adam). The
    loss is held to 1e-5 relative, the grad norm to 1e-4 and the BN running
    statistics to 1e-5, as the R18 step is. Its per-tensor bar (2e-4 of each
    tensor's largest gradient) holds for no two fp32 steps at this depth,
    even with the residual branches scaled: a 1e-7 relative weight
    perturbation moves the port's own gradients by up to 0.36 of a tensor's
    largest (3.0% in the 2-norm), and the port and JAX differ by up to 0.30
    (3.4%). So the gradients are held by norms, as test_torch_fused_bn's
    R50 step is: each tensor's error below 0.1 of max(its norm, 1e-2 of the
    global norm). Adam's first step moves each parameter by about lr, so
    the updated parameters are held within 2 lr."""
    ref, got = steps
    assert float((got["coords"] - torch.from_numpy(CENTRE)).abs().max()) > 1.0
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    want = {k: np.float64(v) for k, v in ref["grads"].items() if "running" not in k}
    assert set(got["grads"]) == set(want)
    gnorm = np.sqrt(sum(np.sum(v * v) for v in want.values()))
    for k, g in got["grads"].items():
        assert np.linalg.norm(g - want[k]) < 0.1 * max(np.linalg.norm(want[k]), 1e-2 * gnorm), k
    for k, v in got["state"].items():
        if "running" in k:
            np.testing.assert_allclose(v, ref["state"][k], rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            assert np.abs(v - ref["state"][k]).max() <= 2e-3 + 1e-6, k


def test_r152_flip_test_eval_step_matches_jax(r152):
    """The flip-test eval step (one 2B forward, x -> out_w - 1 - x with
    out_w = 24, joints permuted, averaged) within 2e-3 voxel of JAX's
    make_eval_step, parallel.data_axis_size pinned to 1."""
    jcfg, cfg, jmodel, params, stats, model = r152
    assert jcfg.eval.flip_test and cfg.eval.flip_test
    batch = _batch(seed=21)
    ref, _, _ = jax_make_eval_step(jmodel, jcfg)(params, stats, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    ref = np.asarray(ref)
    assert np.abs(ref - CENTRE).max() > 1.0
    fhi.launches = 0
    coords, joint_img, _ = make_eval_step(inference_copy(model), cfg)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert fhi.launches == 0 and coords.shape == (BATCH, 18, 3)
    np.testing.assert_allclose(coords.numpy(), ref, atol=2e-3)
    np.testing.assert_array_equal(joint_img.numpy(), batch["joint_img"])
