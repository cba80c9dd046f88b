"""The accuracy tools of the port on the CPU: ``models.convert.to_jax_params``,
``tools/accuracy_loop.py`` at a cut horizon, its trained weights scored by
JAX's Tester, and the 2-D probes.

- The converter maps a JAX R18 and R50 tree (deconvs included) to the port
  and back bitwise.
- ``accuracy_loop.main`` with ``--device cpu --preset tiny --train_size 32
  --test_size 16`` (1 step an epoch; eval batches of 16, not 128): one
  unbroken 2-epoch run, and a 1-epoch run resumed with ``--continue`` to
  2 epochs. Both write JAX's
  keys and report the oracle gap; a loose bar exits 0, a tight one 1; the
  resumed run's final snapshot is bitwise the unbroken run's.
- The unbroken run's weights, carried into flax by ``to_jax_params``,
  through JAX's ``ihpr_tpu.engine.tester.Tester`` (fp32 "highest", one
  device) on the same test JPEGs: voxel predictions within 2e-3 voxel of
  the port's Tester (PARITY's end-to-end bar), MPJPE total within 0.01 mm.
- ``mpii2d_probe`` and ``coco_probe`` on a ResNet-18 64x64 config
  registered in ``CONFIGS``, 8 frames, one epoch (the tool's ``PROBE``
  patched: the command line takes ``--device`` and ``--output_dir``
  only): each writes its metric and exits by its bar.
"""

import dataclasses
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.engine import tester as jtester
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.data import datasets, skeletons
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.models.convert import from_jax_params, to_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.tools import accuracy_loop, coco_probe, mpii2d_probe
from ihpr_tpu_torch.utils import shutdown
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

CUT = ["--device", "cpu", "--preset", "tiny", "--train_size", "32", "--test_size", "16"]
EVAL_BATCH = 16  # the preset's 128 would pad each eval of 16 frames to 128
# Every key JAX's tools/accuracy_loop.py writes (with its oracle, no flip A/B).
JAX_KEYS = {
    "preset", "hue_mode", "use_aug", "mixed_mpii_size", "config", "resnet", "input_shape", "depth_dim",
    "train_size", "test_size", "end_epoch", "train_seconds", "eval_seconds", "mpjpe_bar_mm", "mpjpe_ours_mm",
    "mpjpe_flip_mm", "mpjpe_train_subset_mm", "metrics_ours", "mpjpe_torch_mm", "mpjpe_gap_mm", "oracle_tol_mm",
    "oracle_seconds", "metrics_torch",
}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("resnet", [18, 50])
def test_converter_round_trip_is_bitwise(resnet):
    """A JAX tree (BN statistics, deconvs and final conv redrawn) -> the port
    -> ``to_jax_params``: the same tree structure and every leaf bitwise,
    in float32."""
    jcfg = jax_tiny_cfg()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, resnet_type=resnet))
    _, params, stats = jax_pose_weights(jcfg, seed=resnet)
    cfg = to_port_cfg(jcfg)
    model = build_pose_net(cfg, device="cpu", state_dict=from_jax_params(params, stats, cfg))
    for want, got in zip((params, stats), to_jax_params(model)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, a), (_, b) in zip(_leaves(want), _leaves(got)):
            assert b.dtype == np.float32 and np.array_equal(a, b), jax.tree_util.keystr(path)


def _run(tool, argv, monkeypatch) -> int:
    """``tool.main(argv)``'s exit code, with the SIGTERM handler left alone."""
    monkeypatch.setattr(shutdown, "install_graceful_shutdown", lambda: None)
    with pytest.raises(SystemExit) as exc:
        tool.main(argv)
    return exc.value.code


def _small_eval(preset_config):
    def small(preset):
        cfg = preset_config(preset)
        return cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size_per_device=EVAL_BATCH))

    return small


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unbroken run (loose bar) and the resumed one (tight bar):
    {name: (exit code, its output directory, its JSON)}."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("accuracy")
    out = {}
    mp.setattr(accuracy_loop, "preset_config", _small_eval(accuracy_loop.preset_config))
    try:
        for name, argv in (
            ("unbroken", ["--end_epoch", "2", "--mpjpe_bar_mm", "10000"]),
            ("first", ["--end_epoch", "1", "--mpjpe_bar_mm", "10000"]),
            ("resumed", ["--end_epoch", "2", "--mpjpe_bar_mm", "1", "--continue"]),
        ):
            d = tmp / ("unbroken" if name == "unbroken" else "resumed")
            code = _run(accuracy_loop, CUT + argv + ["--output_dir", str(d)], mp)
            with open(d / "accuracy_loop.json") as f:
                out[name] = (code, d, json.load(f))
    finally:
        mp.undo()
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def test_accuracy_loop_writes_jax_keys_and_exits_by_its_bar(runs):
    for name, want_code in (("unbroken", 0), ("resumed", 1)):
        code, _, result = runs[name]
        assert code == want_code, name
        assert JAX_KEYS <= result.keys(), JAX_KEYS - result.keys()
        assert result["device"] == "cpu" and result["gpu"] is None
        assert result["end_epoch"] == 2 and result["train_size"] == 32 and result["test_size"] == 16
        # The oracle is the port on the CPU: here the same computation.
        assert result["mpjpe_gap_mm"] == 0.0 and result["mpjpe_torch_mm"] == result["mpjpe_ours_mm"]
        assert 0.0 < result["loader_share"] < 1.0 and result["train_img_per_s"] > 0
    assert runs["unbroken"][2]["train_steps"] == 2 and runs["resumed"][2]["train_steps"] == 1
    assert runs["unbroken"][2]["metrics_ours"] == runs["resumed"][2]["metrics_ours"]


def test_continue_ends_bitwise_on_the_unbroken_run(runs):
    got, _, _ = CheckpointManager(str(runs["resumed"][1])).load(1)
    want, _, _ = CheckpointManager(str(runs["unbroken"][1])).load(1)
    assert got["step"] == want["step"] == 2
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert got["scheduler"]["last_epoch"] == want["scheduler"]["last_epoch"]


def _jax_cfg(cfg):
    """The JAX Config with the port Config's field values, on one device."""
    parts = {
        f.name: getattr(jconfig, type(getattr(cfg, f.name)).__name__)(**dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))
    }
    jcfg = jconfig.Config(name=cfg.name, seed=cfg.seed, output_dir=cfg.output_dir, **parts)
    return jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1))


def test_jax_tester_scores_the_trained_weights_as_the_port_does(runs, tmp_path):
    """The trained weights in flax's layout (``to_jax_params``) through JAX's
    Tester, and the port's Tester on them, on the same 16 test JPEGs:
    within 2e-3 voxel, MPJPE total within 0.01 mm."""
    _, out_dir, result = runs["unbroken"]
    state_dict, _, _ = CheckpointManager(str(out_dir)).load(1)
    cfg = _small_eval(accuracy_loop.preset_config)("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, matmul_precision="highest"),
        optim=dataclasses.replace(cfg.optim, end_epoch=2, lr_dec_epoch=(2, 2)),
        eval=dataclasses.replace(cfg.eval, flip_test=False),
    )
    samples = datasets.materialize_synthetic(
        datasets.make_synthetic(skeletons.H36M, 16, seed=22, img_size=400, easy_depth=True),
        str(out_dir / "imgs"), device="cpu")
    model = build_pose_net(cfg, device="cpu", state_dict=state_dict["model"])
    tester = ttester.Tester(cfg.replace(output_dir=str(tmp_path / "port")),
                            dataset=datasets.PoseDataset("Human36M", skeletons.H36M, samples, False),
                            state=model, num_workers=0, device="cpu")
    try:
        vox = tester.predict_voxels()
        metrics = tester.evaluate()
    finally:
        tester.close()
    assert metrics["MPJPE total"] == pytest.approx(result["mpjpe_ours_mm"], abs=0.005)

    params, stats = to_jax_params(model)
    jcfg = _jax_cfg(cfg.replace(output_dir=str(tmp_path / "jax")))
    jax_tester = jtester.Tester(jcfg, dataset=jdatasets.PoseDataset("Human36M", jskeletons.H36M, samples, False),
                                state=types.SimpleNamespace(params=params, batch_stats=stats), num_workers=0)
    ref_vox = jax_tester.predict_voxels()
    ref = jax_tester.evaluate()
    assert np.abs(ref_vox - ref_vox.mean(axis=1, keepdims=True)).max() > 0.5  # not every joint at one point
    np.testing.assert_allclose(vox, ref_vox, rtol=0, atol=2e-3)
    assert abs(metrics["MPJPE total"] - ref["MPJPE total"]) <= 0.01


_PROBE_CFGS = {
    name: tconfig.Config(
        name=f"tiny_{name}",
        model=tconfig.ModelConfig(resnet_type=18, matmul_precision="highest"),
        data=tconfig.DataConfig(trainset=(name,), testset=name, input_shape=(64, 64), output_shape=(16, 16),
                                depth_dim=1),
        optim=tconfig.OptimConfig(batch_size_per_device=4),
        eval=tconfig.EvalConfig(batch_size_per_device=4),
    )
    for name in ("MPII", "MSCOCO")
}


@pytest.mark.parametrize("tool, name, key, metric", [
    (mpii2d_probe, "MPII", "pckh_at_05", "PCKh@0.5"),
    (coco_probe, "MSCOCO", "oks_ap", "AP"),
])
@pytest.mark.parametrize("bar, want_code", [(0.0, 0), (1.5, 1)])
def test_2d_probe_writes_its_metric_and_exits_by_its_bar(tool, name, key, metric, bar, want_code, tmp_path,
                                                         monkeypatch):
    cfg = _PROBE_CFGS[name]
    monkeypatch.setitem(tconfig.CONFIGS, cfg.name, cfg)
    monkeypatch.setattr(tool, "PROBE", {**tool.PROBE, "config": cfg.name, "bar": bar, "train_size": 8,
                                        "test_size": 4, "end_epoch": 1})
    argv = ["--device", "cpu", "--output_dir", str(tmp_path)]
    assert _run(tool, argv, monkeypatch) == want_code
    tool_name = tool.__name__.rsplit(".", 1)[1]
    with open(tmp_path / f"{tool_name}.json") as f:
        result = json.load(f)
    assert 0.0 <= result[key] <= 1.0 and result[key] == round(result["metrics"][metric], 4)
    assert result["bar"] == bar and result["end_epoch"] == 1 and result["train_steps"] == 2
    assert {"config", "train_size", "test_size", "train_seconds", "metrics"} <= result.keys()
    if tool is coco_probe:
        assert result["artifact"].endswith("result/person_keypoints_result.json")


def test_bf16_preset_holds_an_fp32_model_to_the_oracle(tmp_path, monkeypatch):
    """A bf16 preset's oracle is compared with an eval of the trained weights
    in a model built in fp32 (the trained model keeps its bf16 compute
    dtype whatever the config says): on the CPU that eval and the oracle
    are one computation, so the gap is exactly 0. ``flagship`` cut to
    ResNet-18 at 64x64 (bf16, lean BN, bf16 logits), 8 frames, one epoch."""
    tiny = dataclasses.replace(_PROBE_CFGS["MPII"], name="accuracy_bf16")
    small = tiny.replace(
        model=tconfig.ModelConfig(resnet_type=18, compute_dtype="bfloat16", fp32_logits=False, bn_mode="lean"),
        data=tconfig.DataConfig(trainset=("Human36M",), input_shape=(64, 64), output_shape=(16, 16), depth_dim=16,
                                use_aug=False),
        optim=tconfig.OptimConfig(batch_size_per_device=4, end_epoch=60, lr_dec_epoch=(45, 55)),
    )
    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: small)
    argv = ["--device", "cpu", "--preset", "flagship", "--train_size", "8", "--test_size", "4", "--end_epoch", "1",
            "--mpjpe_bar_mm", "10000", "--output_dir", str(tmp_path)]
    assert _run(accuracy_loop, argv, monkeypatch) == 0
    with open(tmp_path / "accuracy_loop.json") as f:
        result = json.load(f)
    assert result["resnet"] == 18 and "mpjpe_ours_fp32_mm" in result
    assert result["mpjpe_gap_mm"] == 0.0 and result["mpjpe_torch_mm"] == result["mpjpe_ours_fp32_mm"]


def _small_bf16(name="accuracy_bf16"):
    """``flagship`` cut to ResNet-18 at 64x64 (bf16, lean BN, bf16 logits)."""
    tiny = dataclasses.replace(_PROBE_CFGS["MPII"], name=name)
    return tiny.replace(
        model=tconfig.ModelConfig(resnet_type=18, compute_dtype="bfloat16", fp32_logits=False, bn_mode="lean"),
        data=tconfig.DataConfig(trainset=("Human36M",), input_shape=(64, 64), output_shape=(16, 16), depth_dim=16,
                                use_aug=False),
        optim=tconfig.OptimConfig(batch_size_per_device=4, end_epoch=60, lr_dec_epoch=(45, 55)),
    )


@pytest.mark.parametrize("bn_mode", ["flax", "lean"])
def test_bn_mode_overrides_the_preset_and_is_recorded(bn_mode, tmp_path, monkeypatch):
    """``--bn_mode`` (JAX's flag) sets the trained model's BN arithmetic, as
    JAX's ``cfg.replace(model=...bn_mode)`` does, and the result JSON records
    it; the preset's lean mode is the default."""
    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: _small_bf16())
    seen = {}
    real = accuracy_loop.train_timed

    def spy(cfg, *a, **k):
        seen["mode"] = cfg.model.bn_mode
        state, stats = real(cfg, *a, **k)
        seen["bns"] = {m.mode for m in state.model.modules() if hasattr(m, "running_var")}
        return state, stats

    monkeypatch.setattr(accuracy_loop, "train_timed", spy)
    argv = ["--device", "cpu", "--preset", "flagship", "--train_size", "4", "--test_size", "4", "--end_epoch", "1",
            "--mpjpe_bar_mm", "10000", "--skip_oracle", "--output_dir", str(tmp_path)]
    assert _run(accuracy_loop, argv + ["--bn_mode", bn_mode], monkeypatch) == 0
    with open(tmp_path / "accuracy_loop.json") as f:
        assert json.load(f)["bn_mode"] == bn_mode
    assert seen == {"mode": bn_mode, "bns": {bn_mode}}


@pytest.mark.parametrize("seed", [None, 2])
def test_seed_sets_the_trainers_jax_init_and_is_recorded(seed, tmp_path, monkeypatch):
    """``--seed`` sets the config's seed, and with it the Trainer's initial
    weights: JAX's draw for that seed (``jax_random.trainer_init_key``); the
    preset's 0 by default. The result JSON records it."""
    from ihpr_tpu_torch.models import jax_random
    from ihpr_tpu_torch.models.convert import from_jax_params

    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: _small_bf16())
    seen = {}
    real = accuracy_loop.train_timed

    def spy(cfg, *a, **k):
        seen["seed"] = cfg.seed
        params, stats = jax_random.jax_init_params(cfg, 18, jax_random.trainer_init_key(cfg.seed))
        seen["init"] = from_jax_params(params, stats, cfg)["backbone.conv1.weight"]
        return real(cfg, *a, **k)

    monkeypatch.setattr(accuracy_loop, "train_timed", spy)
    from ihpr_tpu_torch.engine import trainer as trainer_mod

    built = {}
    real_trainer_build = trainer_mod.build_pose_net

    def build(*a, **k):
        model = real_trainer_build(*a, **k)
        built.setdefault("stem", model.state_dict()["backbone.conv1.weight"].clone())
        return model

    monkeypatch.setattr(trainer_mod, "build_pose_net", build)
    argv = ["--device", "cpu", "--preset", "flagship", "--train_size", "4", "--test_size", "4", "--end_epoch", "1",
            "--mpjpe_bar_mm", "10000", "--skip_oracle", "--output_dir", str(tmp_path)]
    assert _run(accuracy_loop, argv + ([] if seed is None else ["--seed", str(seed)]), monkeypatch) == 0
    with open(tmp_path / "accuracy_loop.json") as f:
        assert json.load(f)["seed"] == (seed or 0) == seen["seed"]
    assert torch.equal(built["stem"], seen["init"])


def test_synthetic_frames_are_jax_cv2_bytes(tmp_path):
    """The accuracy tools write their synthetic frames as JAX's tool does,
    with cv2 on the CPU whatever the run's device: the same file names and
    the same bytes as JAX's ``materialize_synthetic`` (nvJPEG's encode of
    the same frames cost the flagship 13-20 mm, PERF.md §6 PR 22)."""
    from ihpr_tpu_torch.tools import _accuracy

    kw = dict(img_size=200, easy_depth=True, hue_mode="index")
    ours = _accuracy.synthetic_samples(skeletons.H36M, 6, 11, str(tmp_path / "port"), **kw)
    theirs = jdatasets.materialize_synthetic(jdatasets.make_synthetic(jskeletons.H36M, 6, seed=11, **kw),
                                             str(tmp_path / "jax"))
    for a, b in zip(ours, theirs):
        assert os.path.basename(a["img_path"]) == os.path.basename(b["img_path"])
        with open(a["img_path"], "rb") as fa, open(b["img_path"], "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("mode", ["lean_sgx", "lean_sub0", "frozen16"])
def test_bn_mode_refuses_the_measurement_modes(tmp_path, monkeypatch, mode):
    """A mode JAX does not know raises before anything is rendered or
    trained; JAX's own measurement modes are taken
    (``test_bn_mode_takes_every_jax_mode``)."""
    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: _small_bf16())
    monkeypatch.setattr(shutdown, "install_graceful_shutdown", lambda: None)
    with pytest.raises(ValueError, match=mode):
        accuracy_loop.main(["--device", "cpu", "--preset", "flagship", "--bn_mode", mode,
                            "--output_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "imgs")


@pytest.mark.parametrize("mode", ["lean16", "lean_sub4", "lean_sg", "lean_sgv", "frozen"])
def test_bn_mode_takes_every_jax_mode(tmp_path, monkeypatch, mode):
    """Each of JAX's measurement modes trains the cut flagship for an epoch
    on the CPU and is recorded in the result."""
    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: _small_bf16())
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--preset", "flagship", "--train_size", "4", "--test_size", "4", "--end_epoch", "1",
            "--mpjpe_bar_mm", "10000", "--skip_oracle", "--bn_mode", mode, "--output_dir", str(out)]
    assert _run(accuracy_loop, argv, monkeypatch) == 0
    assert json.loads((out / "accuracy_loop.json").read_text())["bn_mode"] == mode


def test_bf16_drift_localises_on_a_trained_run(tmp_path, monkeypatch):
    """``tools/bf16_drift.py`` on a 1-epoch run of the cut flagship: the
    five MPJPEs, one row per BN, block and deconv in execution order (the
    stem's BN first, the head's last BN last), each BN's local errors and
    cancellation, no K1 check on the CPU, and the npz of every BN's four
    fields under the model's names."""
    from ihpr_tpu_torch.models.resnet import BN
    from ihpr_tpu_torch.tools import bf16_drift

    monkeypatch.setattr(accuracy_loop, "preset_config", lambda preset: _small_bf16())
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--preset", "flagship", "--train_size", "4", "--test_size", "4", "--end_epoch", "1",
            "--mpjpe_bar_mm", "10000", "--skip_oracle", "--output_dir", str(out)]
    assert _run(accuracy_loop, argv, monkeypatch) == 0
    npz = tmp_path / "bn.npz"
    bf16_drift.main(["--preset", "flagship", "--output_dir", str(out), "--test_size", "4", "--batch", "4",
                     "--device", "cpu", "--stats_out", str(npz)])
    with open(out / "bf16_drift.json") as f:
        res = json.load(f)
    assert set(res["mpjpe_mm"]) == {"bf16 lean", "fp32", "bf16 flax", "bf16 backbone + fp32 head",
                                    "fp32 backbone + bf16 head"}
    assert all(np.isfinite(v) for v in res["mpjpe_mm"].values())
    layers = [r["layer"] for r in res["layers"]]
    assert layers[0] == "backbone.bn1" and layers[-1] == "head.bn3"
    bns = [r for r in res["layers"] if "cancellation" in r]
    model = build_pose_net(_small_bf16(), device="cpu")
    names = [n for n, m in model.named_modules() if isinstance(m, BN)]
    assert [r["layer"] for r in bns] == names
    assert all(r["local_lean"] >= 0 and r["local_flax"] >= 0 and r["cancellation"] >= 0 for r in bns)
    assert res["k1"] is None and res["bn_mode"] == "lean" and res["hook_batch"] == 4
    stats = np.load(npz)
    assert sorted(stats.files) == sorted(f"{n}.{f}" for n in names
                                         for f in ("weight", "bias", "running_mean", "running_var"))


def test_bn_local_error_grows_with_the_lean_folds_cancellation():
    """``bf16_drift.bn_local`` on one BN whose running mean is 88 of its
    standard deviations (100.37 over sqrt(1.3)), on inputs of those
    statistics: the lean fold's bf16 error is many times flax's, its
    systematic part (per-channel bias) 10 times flax's, and the
    cancellation max|mean * mul| / max|y| between 10 and 100 (y's largest
    is ~4 std over 4096 values); with a zero running mean the two
    arithmetics are alike."""
    from ihpr_tpu_torch.models.resnet import BN
    from ihpr_tpu_torch.tools.bf16_drift import bn_local

    gen = torch.Generator().manual_seed(0)
    c = 16
    bn = BN(c, "lean", torch.bfloat16).eval()
    x = torch.randn(4, c, 8, 8, generator=gen)
    with torch.no_grad():
        bn.running_var.fill_(1.3)
        for mean, lean_over_flax in ((100.37, 20.0), (0.0, None)):
            bn.running_mean.fill_(mean)
            xs = x * 1.3 ** 0.5 + mean
            y = (xs - mean) * torch.rsqrt(torch.tensor(1.3 + bn.eps))
            got = bn_local(bn, xs, y)
            if lean_over_flax is None:
                assert got["local_lean"] <= 2 * got["local_flax"] + 2 ** -9 and got["cancellation"] == 0.0
            else:
                assert got["local_lean"] >= lean_over_flax * got["local_flax"]
                assert got["bias_lean"] >= 10 * got["bias_flax"]
                assert 10 < got["cancellation"] < 100
