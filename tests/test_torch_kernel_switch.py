"""The port's kernel switch, ``IHPR_PALLAS`` (``ops/integral_volume.py:
kernel_mode`` / ``use_kernels``), against JAX's (``integral_pallas.py:
_use_pallas``), and the two reports ``tools/bf16_drift.py`` gained with it
(``k2``: K1/K2 on a trained head; ``bn_reestimate``: the BN statistics
re-estimated on the trained weights).

On the CPU the switch cannot show a kernel launch (there are none here):
these tests hold the policy itself, the route the fused head takes under
``off`` (JAX's no-plan composition, ``j2 = None``) against JAX's under the
same ``off``, and a train step under ``off`` against one under ``auto``.
On the card the port refuses ``off`` (``test_torch_kernels.py`` and
``chip_smoke.py``'s phase 7q hold that no kernel launches then).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.ops.fused_head_integral import fused_final_conv_integral as jax_fused
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.models.resnet import BN
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import integral_volume as iv
from test_torch_integral import FP32_HEADS, _away_from_centre, _head
from test_torch_models import jax_pose_weights, to_port_cfg
from test_torch_train import _port_step, _rel_err, _step_cfg, _train_batch
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

# A train step through the fused head (the plain versions of K1/K2 here)
# against the no-plan route (fp32 logits, the plain integral): the bar of
# chip_smoke.py's no-plan comparison, of each tensor's largest gradient.
TOL_NOPLAN_GRAD = 3e-4


@pytest.mark.parametrize("mode, device, want", [
    ("auto", "cuda", True), ("auto", "cpu", False),
    ("interpret", "cuda", True), ("interpret", "cpu", False),
    ("off", "cuda", "refused"), ("off", "cpu", False),
    ("on", "cuda", ValueError), ("on", "cpu", ValueError),
    (None, "cuda", True), (None, "cpu", False),
])
def test_kernel_switch_policy(monkeypatch, mode, device, want):
    """``use_kernels``: the kernels on CUDA tensors under ``auto`` (also
    when unset) and ``interpret`` (the port has no interpreter), never on
    the CPU; ``off`` is a CPU value and is refused on a CUDA device; any
    other value raises, naming the variable, on either device."""
    if mode is None:
        monkeypatch.delenv("IHPR_PALLAS", raising=False)
    else:
        monkeypatch.setenv("IHPR_PALLAS", mode)
    if want is ValueError:
        with pytest.raises(ValueError, match="IHPR_PALLAS"):
            iv.use_kernels(torch.device(device))
        with pytest.raises(ValueError, match="IHPR_PALLAS"):
            iv.kernel_mode()
        return
    assert iv.kernel_mode() == (mode or "auto")
    if want == "refused":
        for dev in (torch.device(device), device):
            with pytest.raises(ValueError, match="IHPR_PALLAS=off is refused on CUDA tensors"):
                iv.use_kernels(dev)
        return
    assert iv.use_kernels(torch.device(device)) is want
    assert iv.use_kernels(device) is want


def test_off_is_refused_by_the_cards_entry_points(monkeypatch, tmp_path):
    """Under ``IHPR_PALLAS=off`` the Trainer, the Tester and the server
    refuse a CUDA device before they build anything (this host has no
    card: the refusal comes first). The ops' own refusal on CUDA tensors is
    held on the card (``test_torch_kernels.py``, ``chip_smoke.py`` 7q)."""
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.engine.trainer import Trainer

    monkeypatch.setenv("IHPR_PALLAS", "off")
    cfg = to_port_cfg(_step_cfg()).replace(output_dir=str(tmp_path))
    for build in (lambda: Trainer(cfg, data_root="synthetic", device="cuda"),
                  lambda: Tester(cfg, data_root="synthetic", device="cuda"),
                  lambda: PoseServer(cfg, {}, device="cuda")):
        with pytest.raises(ValueError, match="IHPR_PALLAS=off is refused"):
            build()


@pytest.mark.parametrize("shape", FP32_HEADS, ids=["aligned", "padded"])
def test_off_takes_jaxs_no_plan_route(monkeypatch, shape):
    """Under ``IHPR_PALLAS=off`` an fp32 head JAX would fuse (a fused plan
    exists) takes the no-plan route in both packages: the port's fp32
    logits then the plain integral, JAX's fp32 "highest" logits then its
    plain soft-argmax. Coords within 1e-5 voxel of JAX's, plus JAX's own
    fp32 distance from float64 on the same inputs (on the padded head, whose
    coordinates reach 12 voxels over 4096 summed terms, JAX's coords sit
    1.1e-5 from float64 and the port's 1.5e-5: 1e-5 alone would measure
    the two fp32 summation orders, not the route); each gradient within
    1e-4 of its largest; under ``interpret`` the port takes
    FusedHeadIntegral."""
    b, h, w, c, j, d = shape
    assert fhi.fused_supported(j, d, h * w, c, torch.float32)
    feat, kernel, bias = _head(shape, seed=31)
    g = np.random.RandomState(32).randn(b, j, 3).astype(np.float32)
    monkeypatch.setenv("IHPR_PALLAS", "off")
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(lambda f, k, bb: jax_fused(f, k, bb, j, d), *map(jnp.asarray, (feat, kernel, bias)))
        ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    ref = np.asarray(ref)
    assert _away_from_centre(ref, (b, h, w, j, d))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, kernel, bias)]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    assert "SoftArgmaxVolume" in type(coords.grad_fn).__name__
    exact = fhi.plain(*(torch.from_numpy(a).double().reshape(b, h * w, -1) if a.ndim == 4 else
                        torch.from_numpy(a).double() for a in (feat, kernel, bias)), j, d, w)[0].numpy()
    np.testing.assert_allclose(coords.detach().numpy(), ref, rtol=0, atol=1e-5 + np.abs(ref - exact).max())
    grads = torch.autograd.grad(coords, leaves, torch.from_numpy(g))
    for name, got, want in zip(("feat", "kernel", "bias"), grads, ref_grads):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max(), name

    monkeypatch.setenv("IHPR_PALLAS", "interpret")
    fused = fhi.fused_final_conv_integral(*leaves, j, d)
    assert "FusedHeadIntegral" in type(fused.grad_fn).__name__


def test_off_routes_each_autograd_function_to_its_plain_version(monkeypatch):
    """Each Function records its route at the forward, and its backward
    takes the same one even when the switch changes between the two: under
    ``off`` on CPU tensors every op runs plain versions (the kernels' CUDA
    check would raise on a CPU tensor otherwise)."""
    from ihpr_tpu_torch.ops import conv_bn, matmul_bn

    monkeypatch.setenv("IHPR_PALLAS", "off")
    rng = np.random.RandomState(33)
    x = torch.from_numpy(rng.randn(40, 16).astype(np.float32)).requires_grad_()
    wm = torch.from_numpy(rng.randn(16, 24).astype(np.float32)).requires_grad_()
    y, s1, s2 = matmul_bn.fused_matmul_bn(x, wm)
    x4 = torch.from_numpy(rng.randn(2, 5, 3, 8).astype(np.float32)).requires_grad_()
    w4 = torch.from_numpy(rng.randn(3, 3, 8, 8).astype(np.float32)).requires_grad_()
    y4, t1, t2 = conv_bn.fused_conv3x3_bn(x4, w4)
    vol = torch.from_numpy(rng.randn(2, 12, 3 * 4).astype(np.float32)).requires_grad_()
    coords = iv.soft_argmax_volume(vol, 3, 4, 4)
    monkeypatch.setenv("IHPR_PALLAS", "auto")  # the backward keeps the forward's route
    (y.sum() + s1.sum() + s2.sum() + y4.sum() + t1.sum() + t2.sum() + coords.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in (x, wm, x4, w4, vol))
    assert (iv.launches, iv.bwd_launches, matmul_bn.launches, matmul_bn.bwd_launches,
            conv_bn.launches, conv_bn.bwd_launches) == (0,) * 6


@pytest.mark.parametrize("bn_mode", ["flax", "lean"])
def test_train_step_off_matches_auto(monkeypatch, bn_mode):
    """One tiny fp32 "highest" R18 train step (finalize, forward, loss,
    backward, Adam) from the same weights on the same batch under ``off``
    and under ``auto``: the head's two routes (FusedHeadIntegral, whose fp32
    head has JAX's fused plan, against fp32 logits and the plain integral)
    give the loss within 1e-5 relative and every parameter's gradient within
    TOL_NOPLAN_GRAD of its tensor's largest. (In bf16 the two routes round
    dv at different places, as JAX's kernel and its no-plan composition do,
    and train-mode BN over a batch of 2 amplifies that past 1e-2.)"""
    jcfg = _step_cfg(matmul_precision="highest", bn_mode=bn_mode)
    _, params, stats = jax_pose_weights(jcfg, seed=7)
    cfg, batch = to_port_cfg(jcfg), _train_batch()
    assert fhi.jax_plan(18, cfg.data.depth_dim, 16 * 16, cfg.model.deconv_channels) is not None
    monkeypatch.setenv("IHPR_PALLAS", "auto")
    on = _port_step(cfg, params, stats, batch)
    monkeypatch.setenv("IHPR_PALLAS", "off")
    off = _port_step(cfg, params, stats, batch)
    assert off["loss"] == pytest.approx(on["loss"], rel=1e-5)
    assert set(off["grads"]) == set(on["grads"])
    for k, g in off["grads"].items():
        assert _rel_err(g, on["grads"][k]) <= TOL_NOPLAN_GRAD, k


def _population_model(batches):
    """A tiny fp32 R18 whose every BN's running statistics are its
    population's over ``batches``: the cumulative average of the batch
    statistics, set by the BN's own update (momentum 0, then 1/2, then
    2/3, ...: ``old * k / (k + 1) + batch / (k + 1)`` at the k-th pass)."""
    jcfg = _step_cfg(matmul_precision="highest", bn_mode="flax")
    model = build_pose_net(to_port_cfg(jcfg), device="cpu", trainable=True)
    bns = [m for m in model.modules() if isinstance(m, BN)]
    model.train()
    for k, images in enumerate(batches):
        for bn in bns:
            bn.momentum = k / (k + 1)
        with torch.no_grad(), model.precision():
            model.head.features(model._features(images))
    for bn in bns:
        del bn.momentum  # back to the class's flax momentum
    return model


def test_reestimation_keeps_population_statistics():
    """``bf16_drift.reestimate_bn`` on a model whose running statistics are
    its population's (the cumulative average of the batch statistics over
    three batches of 4 images, by the BN's own update): over the same
    batches the re-estimate equals them within 1e-6 of each statistic's
    largest, and the model's own running statistics and mode are left as
    they were."""
    from ihpr_tpu_torch.tools.bf16_drift import reestimate_bn

    rng = np.random.RandomState(34)
    batches = [torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32)) for _ in range(3)]
    model = _population_model(batches)
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    stats = reestimate_bn(model, batches)
    assert not model.training
    names = [n for n, m in model.named_modules() if isinstance(m, BN)]
    assert sorted(stats) == sorted(names)
    for name, (mean, var) in stats.items():
        for got, field in ((mean, "running_mean"), (var, "running_var")):
            want = before[f"{name}.{field}"].double()
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), (name, field)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k


def test_bf16_drift_reports_k2_and_reestimation(tmp_path, monkeypatch):
    """Both new reports of ``bf16_drift`` on a 1-epoch run of the accuracy
    harness's tiny preset, on the CPU: ``k2`` holds plain bf16 against
    float64 (no kernel here: its figures are None) with finite figures and
    a whole-voxel share in [0, 1]; ``bn_reestimate`` gives four finite
    MPJPEs and a finite variance ratio per BN; the JSON records the
    switch."""
    from ihpr_tpu_torch.tools import accuracy_loop, bf16_drift
    from ihpr_tpu_torch.utils import shutdown

    monkeypatch.setattr(shutdown, "install_graceful_shutdown", lambda: None)
    monkeypatch.setenv("IHPR_PALLAS", "off")
    out = tmp_path / "run"
    with pytest.raises(SystemExit):
        accuracy_loop.main(["--device", "cpu", "--preset", "tiny", "--train_size", "16", "--test_size", "8",
                            "--end_epoch", "1", "--mpjpe_bar_mm", "10000", "--skip_oracle",
                            "--output_dir", str(out)])
    with open(out / "accuracy_loop.json") as f:
        assert json.load(f)["kernels"] == "off"
    bf16_drift.main(["--preset", "tiny", "--output_dir", str(out), "--test_size", "8", "--batch", "4",
                     "--device", "cpu", "--k2_batches", "2", "--reestimate_frames", "16", "--epoch", "earliest"])
    files = [f for f in os.listdir(out) if f.startswith("bf16_drift_epoch")]
    assert len(files) == 1
    with open(out / files[0]) as f:
        res = json.load(f)
    assert res["kernels"] == "off" and res["train_size"] == 16 and res["seed"] == 0
    k2 = res["k2"]
    assert k2["kernel"] is None and k2["batches"] == 2 and k2["batch"] == 4
    for tensor in ("coords", "dfeat", "dw", "db"):
        fig = k2["plain_bf16"][tensor]
        assert all(np.isfinite(fig[k]) for k in ("max_rel", "mean_rel", "cosine", "bias")), tensor
        assert fig["cosine"] > 0.99 and fig["mean_rel"] <= fig["max_rel"], tensor
    assert 0.0 <= k2["whole_voxel_share"] <= 1.0
    re = res["bn_reestimate"]
    assert re["frames"] == 16
    assert all(np.isfinite(re["mpjpe_mm"][a][dt]) for a in ("running", "reestimated") for dt in ("bf16", "fp32"))
    model = build_pose_net(accuracy_loop.preset_config("tiny"), device="cpu")
    names = [n for n, m in model.named_modules() if isinstance(m, BN)]
    assert sorted(re["var_ratio"]) == sorted(names)
    assert all(np.isfinite(r).all() and min(r) > 0 for r in re["var_ratio"].values())
