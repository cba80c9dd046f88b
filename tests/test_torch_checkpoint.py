"""The port's snapshot lifecycle on the CPU: CheckpointManager, the Trainer's
snapshots, its RSS watchdog and mid-epoch resume, and a JAX snapshot resumed
in the port.

The tests mirror the JAX package's (tests/test_train_integration.py) one to
one, on the tiny config of test_torch_models (ResNet-18, 64x64 input,
16x16x16 heatmaps, 18 joints; bf16 convs, lean BN, bf16 logits, the
flagship's dtypes), batch 4 with augmentation off. Epochs are sized by the
number of samples (8 samples = 2 steps), not by ``cap_steps_per_epoch``,
which rebuilds the optimizer.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from ihpr_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from ihpr_tpu.engine.trainer import Trainer as JaxTrainer
from ihpr_tpu_torch.data import datasets, pipeline, skeletons
from ihpr_tpu_torch.engine import checkpoint
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models.convert import from_jax_params, from_jax_train_state
from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL, resolve_rss_limit_mb
from test_torch_models import jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

BATCH = 4


def _jcfg(out, dtypes="bf16", **optim):
    """The JAX tiny config in the flagship's dtypes ("bf16") or in fp32
    "highest" ("fp32"), lean BN, batch 4, one device, writing to ``out``."""
    model_kw = (
        dict(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)
        if dtypes == "bf16"
        else dict(matmul_precision="highest", bn_mode="lean")
    )
    jcfg = jax_tiny_cfg(**model_kw)
    return jcfg.replace(
        output_dir=str(out),
        optim=dataclasses.replace(jcfg.optim, batch_size_per_device=BATCH, **optim),
        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1),
    )


def _cfg(out, **optim):
    cfg = to_port_cfg(_jcfg(out, **optim))
    return cfg.replace(data=dataclasses.replace(cfg.data, use_aug=False))


def _dataset(n=8):
    return datasets.PoseDataset(
        "Human36M", skeletons.H36M,
        datasets.make_synthetic(skeletons.H36M, n, seed=0, img_size=200), is_train=True,
    )


def _trainer(cfg, samples=8, **kw):
    return Trainer(cfg, datasets=[_dataset(samples)], num_workers=0, device="cpu", **kw)


def _first_batch(trainer):
    return next(pipeline.prefetch_to_device(trainer.loader.epoch(0, 1), "cpu"))[0]


def _assert_same_state(got: dict, want: dict):
    """Two TrainState.state_dict()s bitwise equal: model, Adam moments and
    counts, the schedule's count, the update count."""
    assert got["step"] == want["step"]
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    gs, ws = got["optimizer"]["state"], want["optimizer"]["state"]
    assert gs.keys() == ws.keys()
    for i in ws:
        assert gs[i].keys() == ws[i].keys()
        for k in ws[i]:
            assert torch.equal(gs[i][k], ws[i][k]), (i, k)
    assert got["scheduler"]["last_epoch"] == want["scheduler"]["last_epoch"]


# --- CheckpointManager -------------------------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """A snapshot of a stepped state restores bitwise (itr -1, epoch 0), and
    one more step from the restored state equals one from the live state."""
    live = _trainer(_cfg(tmp_path / "a"))
    other = _trainer(_cfg(tmp_path / "b"))
    try:
        batch = _first_batch(live)
        live.step_fn(batch)
        live.state.step += 1
        ckpt = CheckpointManager(str(tmp_path / "snap"))
        ckpt.save(0, live.state)  # asynchronous; latest_epoch and load drain it
        assert ckpt.latest_epoch() == 0
        state_dict, epoch, itr = ckpt.load_latest()
        assert (epoch, itr) == (0, -1)
        _assert_same_state(state_dict, live.state.state_dict())
        other.state.load_state_dict(state_dict)
        _assert_same_state(other.state.state_dict(), live.state.state_dict())
        m_a, m_b = live.step_fn(batch), other.step_fn(batch)
        assert torch.equal(m_a["loss"], m_b["loss"])
        _assert_same_state(other.state.state_dict(), live.state.state_dict())
    finally:
        live.close()
        other.close()


def test_checkpoint_retention_keep(tmp_path):
    """keep=N retains only the newest N snapshots and resume reads the
    latest survivor; keep=0 (which would prune every snapshot) is refused."""
    trainer = _trainer(_cfg(tmp_path / "run"))
    try:
        ckpt = CheckpointManager(str(tmp_path / "snap"), keep=2)
        for e in range(4):
            ckpt.save(e, trainer.state)
        ckpt.wait()
        assert ckpt._epochs_on_disk() == [2, 3]
        assert ckpt.latest_epoch() == 3
        assert ckpt.load_latest()[1] == 3
        with pytest.raises(ValueError, match="keep"):
            CheckpointManager(str(tmp_path / "snap0"), keep=0)
    finally:
        trainer.close()


def test_save_holds_the_state_from_before_the_next_step(tmp_path, monkeypatch):
    """The optimizer updates parameters and moments in place, so ``save``
    copies them before it returns: a step taken at once after ``save``, while
    the write waits, does not reach the snapshot."""
    import threading

    stepped = threading.Event()
    real_write = CheckpointManager._write

    def write_after_the_step(self, path, payload):
        assert stepped.wait(60)
        real_write(self, path, payload)

    monkeypatch.setattr(CheckpointManager, "_write", write_after_the_step)
    trainer = _trainer(_cfg(tmp_path / "run"))
    try:
        batch = _first_batch(trainer)
        trainer.step_fn(batch)
        before = checkpoint._host_copy(trainer.state.state_dict())
        ckpt = CheckpointManager(str(tmp_path / "snap"))
        ckpt.save(0, trainer.state)
        trainer.step_fn(batch)
        trainer.state.step += 1
        stepped.set()
        state_dict, _, _ = ckpt.load(0)
    finally:
        trainer.close()
    _assert_same_state(state_dict, before)
    w = "head.final.weight"
    assert not torch.equal(state_dict["model"][w], trainer.model.state_dict()[w])


def test_failed_save_raises_on_the_next_save_and_on_wait(tmp_path, monkeypatch):
    """A write that fails in the background is not swallowed."""
    trainer = _trainer(_cfg(tmp_path / "run"))
    try:
        ckpt = CheckpointManager(str(tmp_path / "snap"))

        def full_disk(obj, f):
            raise OSError("no space left on device")

        monkeypatch.setattr(checkpoint.torch, "save", full_disk)
        ckpt.save(0, trainer.state)
        with pytest.raises(RuntimeError, match="snapshot_0") as exc:
            ckpt.save(1, trainer.state)
        assert isinstance(exc.value.__cause__, OSError)
        ckpt.save(1, trainer.state)  # the failure was raised once; this write fails too
        with pytest.raises(RuntimeError, match="snapshot_1"):
            ckpt.wait()
        assert ckpt._epochs_on_disk() == []
    finally:
        trainer.close()


# --- the Trainer ---------------------------------------------------------------------


def test_trainer_snapshot_interval(tmp_path):
    """snapshot_interval thins per-epoch saves; the final epoch is always
    saved so --continue and the Tester see the end state."""
    trainer = _trainer(
        _cfg(tmp_path, end_epoch=5, snapshot_interval=2, snapshot_keep=2), samples=BATCH
    )
    try:
        assert trainer.steps_per_epoch == 1
        trainer.train(end_epoch=5)
    finally:
        trainer.close()
    # saved at epochs 1, 3 (interval) and 4 (final); keep=2 -> {3, 4}
    assert trainer.ckpt._epochs_on_disk() == [3, 4]
    assert (tmp_path / "log" / "train_logs.txt").read_text().count("saving snapshot_") == 3


def test_train_drains_checkpoint_on_abnormal_exit(tmp_path):
    """Any exit from Trainer.train, the SIGTERM -> SystemExit unwind of the
    CLIs included, drains the snapshot in flight."""
    trainer = _trainer(_cfg(tmp_path, end_epoch=3, snapshot_interval=1), samples=BATCH)
    drained = []
    real_wait = trainer.ckpt.wait
    trainer.ckpt.wait = lambda: (drained.append(True), real_wait())[1]

    def exploding(fn):
        def wrapped(batch):
            if trainer.state.step >= 1:  # mid epoch 1, right after epoch 0's save
                raise SystemExit(143)  # what the SIGTERM handler raises
            return fn(batch)

        return wrapped

    trainer.step_fn = exploding(trainer.step_fn)
    trainer.lean_step_fn = exploding(trainer.lean_step_fn)
    try:
        with pytest.raises(SystemExit):
            trainer.train(end_epoch=3)
    finally:
        trainer.close()
    assert drained, "Trainer.train must call ckpt.wait() on abnormal exit"
    _, epoch, itr = trainer.ckpt.load_latest()
    assert (epoch, itr) == (0, -1)


def test_trainer_rss_watchdog_preempts_and_resumes(tmp_path):
    """With an impossible 1 MB limit the Trainer snapshots epoch 0 at its
    boundary and raises SystemExit(EX_TEMPFAIL); a continue_train relaunch
    resumes at epoch 1 and finishes the run."""
    cfg = _cfg(tmp_path, end_epoch=3, snapshot_interval=10, snapshot_keep=3)
    trainer = _trainer(cfg, samples=BATCH, rss_limit_mb=1.0)
    try:
        with pytest.raises(SystemExit) as exc:
            trainer.train(end_epoch=3)
    finally:
        trainer.close()
    assert exc.value.code == EX_TEMPFAIL
    # interval 10 would not have saved epoch 0: the watchdog did
    assert trainer.ckpt._epochs_on_disk() == [0]

    resumed = _trainer(cfg, samples=BATCH, continue_train=True, rss_limit_mb=0)
    try:
        assert resumed.rss_limit_mb is None  # 0 disables the watchdog
        assert (resumed.start_epoch, resumed.resume_skip) == (1, 0)
        assert resumed.state.step == 1
        resumed.train(end_epoch=3)
    finally:
        resumed.close()
    assert resumed.ckpt._epochs_on_disk() == [0, 2]  # the final epoch saved
    assert resumed.state.step == 3
    auto = resolve_rss_limit_mb(None)  # 80% of MemTotal: present and generous
    assert auto is None or auto > 1000


def test_trainer_rss_watchdog_trips_mid_epoch_resume_bit_identical(tmp_path):
    """With a check every step and an impossible limit the Trainer snapshots
    mid-epoch (itr 0 of epoch 0) and exits EX_TEMPFAIL; the --continue
    relaunch skips exactly the consumed batch and ends bitwise equal to an
    uninterrupted run: weights, BN running statistics, Adam moments and
    counts, the schedule's count and the update count."""
    ref = _trainer(_cfg(tmp_path / "ref", end_epoch=2, snapshot_interval=10), rss_limit_mb=0)
    try:
        assert ref.steps_per_epoch == 2
        ref.train(end_epoch=2)
    finally:
        ref.close()

    cfg = _cfg(tmp_path / "run", end_epoch=2, snapshot_interval=10)
    trainer = _trainer(cfg, rss_limit_mb=1.0, rss_check_interval_steps=1)
    try:
        with pytest.raises(SystemExit) as exc:
            trainer.train(end_epoch=2)
    finally:
        trainer.close()
    assert exc.value.code == EX_TEMPFAIL
    state_dict, epoch, itr = trainer.ckpt.load(0)
    assert (epoch, itr) == (0, 0)
    assert state_dict["step"] == 1  # exactly one completed step

    resumed = _trainer(cfg, continue_train=True, rss_limit_mb=0)
    try:
        assert (resumed.start_epoch, resumed.resume_skip) == (0, 1)
        resumed.train(end_epoch=2)
    finally:
        resumed.close()
    assert resumed.state.step == ref.state.step == 4
    _assert_same_state(resumed.state.state_dict(), ref.state.state_dict())
    assert "mid-epoch, itr 0" in (tmp_path / "run" / "log" / "train_logs.txt").read_text()


def test_profile_window_writes_a_trace_and_closes_on_preempt(tmp_path):
    """``train(profile_dir=...)`` writes a Chrome trace of the window; a
    preempt inside the window still closes it (train()'s finally)."""
    import json

    trainer = _trainer(_cfg(tmp_path / "run", end_epoch=1), samples=4 * BATCH,
                       rss_limit_mb=1.0, rss_check_interval_steps=2)
    try:
        with pytest.raises(SystemExit):
            trainer.train(end_epoch=1, profile_dir=str(tmp_path / "prof"), profile_steps=(1, 3))
    finally:
        trainer.close()
    assert trainer._profiler is None
    (trace,) = (tmp_path / "prof").iterdir()
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]


# --- a JAX snapshot resumed in the port ----------------------------------------------


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A JAX Trainer (fp32 "highest", lean BN, 8 samples = 2 steps an epoch,
    augmentation on) trains epoch 0 and writes snapshot_0. Yields the
    config, the dataset, the snapshot restored by JAX's CheckpointManager as
    numpy trees, and the JAX run continued (--continue) through epoch 1 with
    the losses of its two steps."""
    from ihpr_tpu.data import datasets as jdatasets
    from ihpr_tpu.data import skeletons as jskeletons

    out = tmp_path_factory.mktemp("jax")
    jcfg = _jcfg(out, dtypes="fp32", end_epoch=2)
    jds = jdatasets.PoseDataset(
        "Human36M", jskeletons.H36M, jdatasets.make_synthetic(jskeletons.H36M, 8, seed=0, img_size=200), True
    )
    first = JaxTrainer(jcfg, datasets=[jds], num_workers=0)
    assert first.steps_per_epoch == 2
    first.train(end_epoch=1)
    template = jax.tree.map(lambda x: x, first.state)
    state, _, epoch, itr = JaxCheckpointManager(str(out)).load(0, template, first.data_rng)
    assert (epoch, itr) == (0, -1)
    restored = jax.tree.map(np.asarray, state)
    resumed = JaxTrainer(jcfg, datasets=[jds], num_workers=0, continue_train=True)
    assert resumed.start_epoch == 1
    losses = []

    def recording(fn):
        def step(state, batch, rng):
            state, metrics = fn(state, batch, rng)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return step

    resumed.step_fn, resumed.lean_step_fn = recording(resumed.step_fn), recording(resumed.lean_step_fn)
    final = jax.tree.map(np.asarray, resumed.train(end_epoch=2))
    yield jcfg, jds, restored, final, losses
    shutil.rmtree(out, ignore_errors=True)


def _port_from_jax_snapshot(jcfg, restored, out):
    """The JAX snapshot converted and saved with the port's manager in
    ``out``; returns the port config."""
    cfg = to_port_cfg(jcfg).replace(output_dir=str(out))
    state_dict = from_jax_train_state(
        restored.params, restored.batch_stats, restored.opt_state, restored.step, cfg
    )
    holder = _trainer(cfg)
    try:
        holder.state.load_state_dict(state_dict)
        holder.ckpt.save(0, holder.state)
        holder.ckpt.wait()
    finally:
        holder.close()
    return cfg


def test_jax_snapshot_resumes_in_the_port(jax_snapshot, tmp_path):
    """JAX's snapshot_0, restored with JAX's CheckpointManager, converted with
    from_jax_train_state and saved by the port's manager: the port's
    --continue starts epoch 1 from JAX's state exactly (weights, BN
    statistics, Adam moments, every count) and runs it as JAX's does.

    The two resumed steps are held to a measured bound, not to
    test_fp32_train_step_matches_jax's: on these synthetic frames XLA's CPU
    sums of train-mode BN's statistics are far less accurate than ATen's,
    and the port and JAX on the same state and batch differ by up to 0.30
    of a tensor's largest gradient after one step
    (test_jax_snapshot_gradient_gap_is_xla_bn_sums; on
    test_fp32_train_step_matches_jax's random patches: 2e-4).
    Measured after the two steps: losses within 4e-5 relative; each
    tensor's update (final - snapshot) within 0.25 of its norm and within
    2.9 lr elementwise; BN statistics within 1.4% of each tensor's largest.
    Bounds: 1e-3, 0.5, 4 lr and 5%."""
    jcfg, _, restored, final, jax_losses = jax_snapshot
    cfg = _port_from_jax_snapshot(jcfg, restored, tmp_path)
    start = {k: v.numpy() for k, v in from_jax_params(restored.params, restored.batch_stats, cfg).items()}
    resumed = _trainer(cfg, continue_train=True, rss_limit_mb=0)
    try:
        assert (resumed.start_epoch, resumed.resume_skip) == (1, 0)
        sd = resumed.state.state_dict()
        assert sd["step"] == 2 and sd["scheduler"]["last_epoch"] == 2
        assert {float(s["step"]) for s in sd["optimizer"]["state"].values()} == {2.0}
        for k, v in sd["model"].items():
            assert np.array_equal(v.numpy(), start[k]), k
        adam = restored.opt_state[0]
        names = [n for n, _ in resumed.model.named_parameters()]
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = from_jax_params(tree, restored.batch_stats, cfg)
            for i, name in enumerate(names):
                assert torch.equal(sd["optimizer"]["state"][i][key], want[name]), (key, name)
        resumed.train(end_epoch=2)
        losses = [float(x) for x in resumed.losses]
    finally:
        resumed.close()
    assert resumed.state.step == int(final.step) == 4
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    got = {k: v.numpy() for k, v in resumed.model.state_dict().items()}
    want = {k: v.numpy() for k, v in from_jax_params(final.params, final.batch_stats, cfg).items()}
    lr = cfg.optim.lr
    assert got.keys() == want.keys()
    for k, w in want.items():
        if "running" in k:
            assert np.abs(got[k] - w).max() <= 5e-2 * np.abs(w).max(), k
            continue
        ours, theirs = got[k] - start[k], w - start[k]
        assert np.linalg.norm(ours - theirs) <= 0.5 * np.linalg.norm(theirs), k
        assert np.abs(ours - theirs).max() <= 4 * lr, k


def test_continue_with_steps_restarts_adam_as_jax_does(jax_snapshot, tmp_path):
    """``cap_steps_per_epoch`` rebuilds the optimizer after the restore in
    both packages (JAX's train.py calls it after the Trainer restores):
    --continue --steps N restarts Adam's moments and count and the
    schedule's count, and keeps the update count."""
    jcfg, jds, restored, final, _ = jax_snapshot
    jtrainer = JaxTrainer(jcfg, datasets=[jds], num_workers=0, continue_train=True)  # snapshot_1
    assert int(jtrainer.state.opt_state[0].count) == 4
    jtrainer.cap_steps_per_epoch(1)
    adam, sched = jtrainer.state.opt_state
    assert int(adam.count) == int(sched.count) == 0
    assert all(not np.asarray(x).any() for x in jax.tree.leaves(adam.mu))
    assert int(jtrainer.state.step) == int(final.step) == 4

    cfg = _port_from_jax_snapshot(jcfg, restored, tmp_path)
    trainer = _trainer(cfg, continue_train=True, rss_limit_mb=0)
    try:
        assert len(trainer.state.optimizer.state) > 0
        trainer.cap_steps_per_epoch(1)
        assert len(trainer.state.optimizer.state) == 0  # Adam starts again
        assert trainer.state.scheduler.last_epoch == 0
        assert trainer.state.step == 2
    finally:
        trainer.close()


def test_jax_snapshot_gradient_gap_is_xla_bn_sums(jax_snapshot, tmp_path, monkeypatch):
    """Why the port and JAX differ on one step from the converted snapshot:
    the state and batch of test_jax_snapshot_resumes_in_the_port (JAX's
    snapshot_0, the first batch of epoch 1), one train-mode gradient.

    - The port and JAX differ by up to 0.30 of a tensor's largest gradient
      (measured 0.297; 3.3% of the global norm).
    - The port is not chaotic at the size of a 1e-7 relative weight
      perturbation: its own gradients move by 3.6e-5 of a tensor's largest
      (seed 1; other seeds up to 3.3%).
    - The gap is the fp32 sums of train-mode BN: XLA's CPU reduction of
      E[x] and E[x^2] over the stem's 4096 values per channel is ~100x
      less accurate than ATen's (batch variance 4e-4 to 1.8e-3 from
      float64, against ~1e-5), and E[x^2] - E[x]^2 amplifies it. With
      XLA's sums put into the port's BN (values only; the gradient path
      stays ATen's) the two agree to 3.1e-5 of a tensor's largest.

    So no fault of the port: its BN statistics are the closer to float64."""
    import copy

    import jax.numpy as jnp

    from ihpr_tpu.parallel import create_train_state as jax_create_train_state
    from ihpr_tpu.parallel import make_train_step as jax_make_train_step
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.models import resnet
    from ihpr_tpu_torch.ops.loss import joint_location_loss
    from test_torch_train import build_jax_model

    jcfg, _, restored, _, _ = jax_snapshot
    cfg = _port_from_jax_snapshot(jcfg, restored, tmp_path)
    resumed = _trainer(cfg, continue_train=True, rss_limit_mb=0)
    try:
        batch = next(pipeline.prefetch_to_device(resumed.loader.epoch(1, None), "cpu"))[0]
        start = copy.deepcopy(resumed.model)
    finally:
        resumed.close()
    labels = (batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"])

    def port_grads(perturb=0.0):
        model = copy.deepcopy(start).train()
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
        with model.precision():
            image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
            joint_location_loss(model.coords(image), *labels).backward()
        return {k: p.grad.numpy() for k, p in model.named_parameters()}

    jmodel = build_jax_model(jcfg)
    state, tx = jax_create_train_state(
        jmodel, jcfg, jax.random.key(0), 10, params=restored.params, batch_stats=restored.batch_stats
    )
    step = jax_make_train_step(jmodel, tx, jcfg, donate=False, debug_grads=True)
    fields = ("patch", "color_scale", "joint_img", "joint_vis", "joints_have_depth")
    _, metrics = step(state, {k: jnp.asarray(batch[k].numpy()) for k in fields}, jax.random.key(1))
    to_np = jax.tree.map(lambda a: np.asarray(a, np.float32), metrics["grads"])
    ref = {k: v.numpy() for k, v in from_jax_params(to_np, restored.batch_stats, cfg).items() if "running" not in k}

    def worst(got):
        return max(float(np.abs(np.float64(got[k]) - ref[k]).max() / np.abs(ref[k]).max()) for k in ref)

    port = port_grads()
    own = port_grads(1e-7)
    own_move = max(float(np.abs(np.float64(own[k]) - port[k]).max() / np.abs(port[k]).max()) for k in port)
    assert worst(port) > 0.1  # the gap (0.297)
    assert own_move < 1e-3  # the port's own chaos at 1e-7 (3.6e-5)

    def xla_stats(self, x):
        xf = x.to(torch.float32)
        mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        xn = jnp.asarray(xf.detach().permute(0, 2, 3, 1).numpy())
        mean = mean + (torch.from_numpy(np.asarray(jnp.mean(xn, axis=(0, 1, 2)))) - mean).detach()
        sq = sq + (torch.from_numpy(np.asarray(jnp.mean(xn * xn, axis=(0, 1, 2)))) - sq).detach()
        var = (sq - mean * mean).clamp_min(0.0)
        self._update_running(mean, var)
        return mean, var

    # The stem conv's output is the same in both packages; its batch
    # variance per channel, from float64, in XLA's sums and in ATen's.
    with torch.no_grad():
        x = start.backbone.conv1(finalize_patch(batch["patch"], batch["color_scale"], cfg.data).permute(0, 3, 1, 2))
    x64 = x.double()
    exact = (x64 * x64).mean(dim=(0, 2, 3)) - x64.mean(dim=(0, 2, 3)) ** 2
    xn = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    xla = torch.from_numpy(np.asarray(jnp.mean(xn * xn, axis=(0, 1, 2)) - jnp.mean(xn, axis=(0, 1, 2)) ** 2))
    aten = (x * x).mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)) ** 2
    xla_err = float(((xla.double() - exact).abs() / exact).max())
    aten_err = float(((aten.double() - exact).abs() / exact).max())
    assert xla_err > 10 * aten_err, (xla_err, aten_err)  # 1.8e-3 against ~1e-5

    monkeypatch.setattr(resnet.BN, "_batch_stats", xla_stats)
    assert worst(port_grads()) < 1e-3  # 3.1e-5
