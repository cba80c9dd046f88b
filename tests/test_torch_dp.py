"""Data parallelism in the port on the CPU: two gloo ranks against one process
on the global batch, and against the JAX package on its virtual devices
(tests/conftest.py gives JAX 8).

The ranks run ``tests/torch_dp_ranks.py`` (torch and the port only) through
``ihpr_tpu_torch.parallel.launch.spawn``, which meets them in a FileStore
under a temporary directory, never a port. One spawn runs every rank job
whose ranks return (``ranks``, module scope); the RSS vote, which exits,
runs in a spawn of its own. Sizes are those of test_torch_train.py:
ResNet-18, 64x64 input, J=18, D=16, fp32 "highest" lean BN unless said
otherwise.

Tolerances: sync-BN against one process 1e-6 of each result's largest
(fp32 sums in another order); gradients with BN in inference mode 1e-6 of
the global gradient norm (PARITY.md's dp8 row, JAX's
test_dp8_matches_single_device_gradient); the train-mode loss 1e-5; the
step against JAX's 2-device mesh at test_fp32_train_step_matches_jax's
bounds. Train-mode BN on synthetic frames is chaotic (near-constant
images), so whole runs across topologies are held by their losses.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import pipeline as jpipeline
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from ihpr_tpu.engine.trainer import Trainer as JaxTrainer
from ihpr_tpu.models import resnet as jresnet
from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.parallel import make_train_step as jax_make_train_step
from ihpr_tpu.parallel.mesh import make_mesh
from ihpr_tpu_torch import test as test_cli
from ihpr_tpu_torch import train as train_cli
from ihpr_tpu_torch.data import datasets, pipeline, skeletons
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models import resnet
from ihpr_tpu_torch.models.convert import from_jax_params, from_jax_train_state
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops.loss import joint_location_loss
from ihpr_tpu_torch.parallel import launch, mesh
from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step
from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL
from test_torch_fused_bn import _bottleneck_shapes
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from test_torch_train import _train_batch
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

import torch_dp_ranks as R

torch.set_num_threads(1)

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN = 8  # synthetic samples of the Trainer runs: 2 steps an epoch at global batch 4
N_TEST = 10  # the Tester's: a global batch of 8, then 2 rows padded to 8


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jcfg(out=None, per_device=2, data_axis_size=None, **model_kw):
    """The JAX tiny config, fp32 "highest" lean BN (or ``model_kw``), a batch
    of ``per_device`` per rank, writing to ``out``."""
    jcfg = jax_tiny_cfg(**(model_kw or dict(matmul_precision="highest", bn_mode="lean")))
    return jcfg.replace(
        output_dir=str(out),
        optim=dataclasses.replace(jcfg.optim, batch_size_per_device=per_device),
        eval=dataclasses.replace(jcfg.eval, batch_size_per_device=4),
        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=data_axis_size),
    )


def _cfg(out=None, per_device=2, **optim):
    cfg = to_port_cfg(_jcfg(out, per_device))
    return cfg.replace(optim=dataclasses.replace(cfg.optim, **optim))


def _block_inputs():
    """An fp32 Bottleneck (e = 64, 8x8, batch 4) with O(1) BN parameters and
    statistics, its input and a cotangent."""
    e, cin = 64, 256
    rng = np.random.RandomState(0)
    x = (rng.randn(4, cin, 8, 8) * 0.5).astype(np.float32)
    cot = rng.randn(4, cin, 8, 8).astype(np.float32)
    block = resnet.Bottleneck(cin, e, 1, torch.float32, "lean")
    sd = {}
    for k, v in block.state_dict().items():
        v = v.numpy()
        if "running_var" in k or k.endswith("bn3.weight") or k.endswith("bn1.weight") or k.endswith("bn2.weight"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif "conv" in k:
            sd[k] = (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        else:
            sd[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    return x, cot, sd


def _one_process_block(x, cot, sd, fused_1x1):
    block = resnet.Bottleneck(x.shape[1], x.shape[1] // 4, 1, torch.float32, "lean", fused_1x1=fused_1x1)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    block.train()
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = block(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return {
        "out": out.detach().numpy(), "dx": xt.grad.numpy(),
        "grads": {k: p.grad.numpy() for k, p in block.named_parameters()},
        "stats": {k: v.numpy() for k, v in block.state_dict().items() if "running" in k},
    }


def _trainer(cfg, n=N_TRAIN, **kw):
    return Trainer(cfg, datasets=[R.synthetic(n)], num_workers=0, device="cpu", **kw)


def _train_1proc(cfg, end_epoch, **kw):
    trainer = _trainer(cfg, **kw)
    losses = []
    try:
        for end in range(trainer.start_epoch + 1, end_epoch + 1):
            trainer.train(end)
            losses.append([float(x) for x in trainer.losses])
        state = R.state_np(trainer.state.state_dict())
    finally:
        trainer.close()
    return {"state": state, "losses": losses}


def _jax_snapshot(out, shard_opt_state):
    """A JAX Trainer on a 2-device mesh (global batch 4) trains epoch 0 and
    writes snapshot_0; its state restored as numpy, converted by
    from_jax_train_state and saved with the port's manager under out/port.
    Its step takes the plain-XLA twins of the Pallas kernels
    (IHPR_PALLAS=off; only the snapshot's contents matter here)."""
    jcfg = _jcfg(out / "jax", data_axis_size=WORLD)
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, shard_opt_state=shard_opt_state))
    jds = jdatasets.PoseDataset(
        "Human36M", jskeletons.H36M, jdatasets.make_synthetic(jskeletons.H36M, N_TRAIN, seed=0, img_size=200), True
    )
    jtrainer = JaxTrainer(jcfg, datasets=[jds], num_workers=0)
    assert jtrainer.steps_per_epoch == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IHPR_PALLAS", "off")
        jtrainer.train(end_epoch=1)
    state, _, epoch, itr = JaxCheckpointManager(str(out / "jax")).load(0, jtrainer.state, jtrainer.data_rng)
    assert (epoch, itr) == (0, -1)
    restored = jax.tree.map(np.asarray, state)
    cfg = _cfg(out / "port")
    sd = from_jax_train_state(restored.params, restored.batch_stats, restored.opt_state, restored.step, cfg)
    holder = _trainer(_cfg(out / "port", per_device=4), rss_limit_mb=0)
    try:
        holder.state.load_state_dict(sd)
        holder.ckpt.save(0, holder.state)
        holder.ckpt.wait()
    finally:
        holder.close()
    return cfg, R.state_np(sd)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank job whose ranks return, in one spawn of two gloo ranks,
    with the inputs they were given and the 1-process runs they are held
    against."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {"block": _block_inputs()}

    jcfg = _jcfg()
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    cfg = to_port_cfg(jcfg)
    model_sd = {k: v.numpy() for k, v in from_jax_params(params, stats, cfg).items()}
    inputs["step"] = (jcfg, params, stats, cfg, model_sd, _train_batch())

    # The 1-process run whose epoch-0 snapshot the ranks resume (c), and
    # its uninterrupted second epoch.
    one = _cfg(tmp / "one", per_device=4)
    inputs["one"] = _train_1proc(one, 2, rss_limit_mb=0)
    shutil.copytree(tmp / "one" / "model_dump", tmp / "one0")
    shutil.rmtree(tmp / "one0" / "snapshot_1")

    dirs = {k: str(tmp / k) for k in ("a", "b", "b0", "c", "rep", "zero")}
    disagree = {0: str(tmp / "one"), 1: str(tmp / "empty")}
    zcfg = _cfg(grad_clip_norm=0.05, weight_decay=1e-3, lr=1e-2, lr_dec_epoch=(1,))
    inputs["zero_cfg"] = zcfg

    tcfg = to_port_cfg(_jcfg(tmp / "test"))
    inputs["test"] = (tcfg, model_sd)

    jax_snaps = {flag: _jax_snapshot(tmp / f"jax_{flag}", flag) for flag in (False, True)}
    inputs["jax"] = jax_snaps

    jobs = [
        ("bn_plain", "bottleneck_ranks", (*inputs["block"], False)),
        ("bn_fused", "bottleneck_ranks", (*inputs["block"], True)),
        ("step", "step_ranks", (cfg, model_sd, _train_batch(), 3)),
        ("trainer", "trainer_ranks", (_cfg(), N_TRAIN, dirs, str(tmp / "one0" / "snapshot_0"))),
        ("disagree", "resume_disagree_ranks", (_cfg(), N_TRAIN, disagree)),
        ("zero", "zero_ranks", (zcfg, N_TRAIN, dirs)),
        ("tester", "tester_ranks", (tcfg, model_sd, N_TEST)),
        *[(f"jax_{flag}", "resume_ranks", (jcfg_.replace(output_dir=str(tmp / f"jax_{flag}" / "port")), N_TRAIN))
          for flag, (jcfg_, _) in jax_snaps.items()],
    ]
    results = launch.spawn(R.run_jobs, WORLD, "gloo", jobs, workdir=str(tmp))
    yield {"inputs": inputs, "dirs": dirs, "tmp": tmp,
           **{name: [r[name] for r in results] for name, _, _ in jobs}}
    shutil.rmtree(tmp)  # snapshots of ~170 MB each


# --- (1) the loader's rank slices -----------------------------------------------------------


def _loaders(rank, world, seed=3):
    jcfg = _jcfg()
    cfg = to_port_cfg(jcfg)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, use_aug=True))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, use_aug=True))
    h36m = jskeletons.get_skeleton("Human36M")
    jds = [jdatasets.build_dataset("Human36M", "train", jcfg, "synthetic", 8),
           jdatasets.build_dataset("MPII", "train", jcfg, "synthetic", 8, hue_skeleton=h36m)]
    tds = [datasets.build_dataset("Human36M", "train", cfg, "synthetic", 8),
           datasets.build_dataset("MPII", "train", cfg, "synthetic", 8, hue_skeleton=skeletons.H36M)]
    return (pipeline.BatchLoader(tds, cfg, 4, num_workers=0, seed=seed, rank=rank, world=world),
            lambda: jpipeline.BatchLoader(jds, jcfg, 4, train=True, num_workers=0, seed=seed, host_warp=True))


def test_loader_rank_slices_concatenate_to_the_global_batch_and_match_jax(monkeypatch):
    """With augmentation on, each rank's batches are its rows of the
    1-process batch, bit for bit (the draws cover the global batch), and
    equal JAX's BatchLoader with jax.process_index / process_count patched."""
    full, _ = _loaders(0, 1)
    want = [list(full.epoch(e)) for e in (0, 1)]
    assert len(full) == 4 and len({float(x) for b in want[0] for x in b.color_scale.ravel()}) > 1
    for rank in range(WORLD):
        loader, jloader = _loaders(rank, WORLD)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: WORLD)
        jref = jloader()
        assert len(loader) == len(full)
        for epoch in (0, 1):
            got = list(loader.epoch(epoch))
            for a, w, j in zip(got, want[epoch], jref.epoch(epoch)):
                for f in ("patch", "color_scale", "joint_img", "joint_vis", "joints_have_depth", "sample_idx"):
                    np.testing.assert_array_equal(getattr(a, f), R.rows(getattr(w, f), rank, WORLD), err_msg=f)
                    if f == "joint_img":
                        np.testing.assert_allclose(a.joint_img, j.joint_img, rtol=0, atol=1e-5)
                    else:
                        np.testing.assert_array_equal(getattr(a, f), getattr(j, f), err_msg=f)
        monkeypatch.undo()


def test_loader_refuses_a_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match="multiple"):
        _loaders(0, 3)


# --- (2) sync-BN and the routes ----------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_sync_bn_bottleneck_matches_one_process(ranks, route):
    """One train-mode Bottleneck on 2 ranks against 1 process on the whole
    batch, on the plain route and on the fused_1x1 route (plain K5/K6 on the
    CPU): outputs, dx, the parameter gradients (dgamma, dbeta, the convs) and
    the running statistics within 1e-6 of each one's largest; every rank
    ends with the same running statistics."""
    x, cot, sd = ranks["inputs"]["block"]
    got = ranks[f"bn_{route}"]
    want = _one_process_block(x, cot, sd, route == "fused")
    assert [r["plain_k5"] for r in got] == [2 if route == "fused" else 0] * WORLD
    assert _rel(np.concatenate([r["out"] for r in got]), want["out"]) <= 1e-6
    assert _rel(np.concatenate([r["dx"] for r in got]), want["dx"]) <= 1e-6
    for k, g in want["grads"].items():
        assert _rel(got[0]["grads"][k], g) <= 1e-6, k
    for k, v in want["stats"].items():
        assert _rel(got[0]["stats"][k], v) <= 1e-6, k
        assert np.array_equal(got[0]["stats"][k], got[1]["stats"][k]), k


class _Routed(Exception):
    pass


def _jax_route(e, stride, cin, b, h, w, mesh):
    """The route JAX's Bottleneck takes (both fused flags, bf16, lean, train)
    at a global (b, h, w, cin) input, found by tracing it abstractly."""
    block = jresnet.Bottleneck(e, stride, jnp.bfloat16, bn_mode="lean", fused_1x1=True, fused_conv3=True, mesh=mesh)
    x = jax.ShapeDtypeStruct((b, h, w, cin), jnp.bfloat16)
    variables = jax.eval_shape(
        lambda v: jresnet.Bottleneck(e, stride, jnp.bfloat16, bn_mode="lean").init(jax.random.key(0), v, False), x
    )
    orig = jresnet.Bottleneck._fused_call, jresnet.Bottleneck._fused3_call

    def taken(route):
        def call(self, *a, **kw):
            raise _Routed(route)
        return call

    jresnet.Bottleneck._fused_call, jresnet.Bottleneck._fused3_call = taken("1x1"), taken("conv3")
    try:
        jax.eval_shape(lambda v, xx: block.apply(v, xx, True, mutable=["batch_stats"]), variables, x)
        return "plain"
    except _Routed as r:
        return r.args[0]
    finally:
        jresnet.Bottleneck._fused_call, jresnet.Bottleneck._fused3_call = orig


def test_route_table_at_world_2_matches_jax_mesh():
    """h36m3d_r50 with both fused flags at a global batch of 64 (32 a rank),
    256x256, bf16: every Bottleneck routes as JAX's under make_mesh(2): the
    1x1 route decided on the local rows, never conv3. At world 1 the conv3
    route is taken, as in JAX without a mesh."""
    dp2 = mesh.DataParallel(0, WORLD)
    table = {}
    for world, dp, jmesh in ((1, None, None), (WORLD, dp2, make_mesh(WORLD))):
        rows = []
        for name, cin, e, stride, b, h, w in _bottleneck_shapes(50, 64, (256, 256)):
            blk = resnet.Bottleneck(cin, e, stride, torch.bfloat16, "lean", device="meta",
                                    fused_1x1=True, fused_conv3=True, dp=dp).train()
            port = blk._route(torch.empty(b // world, cin, h, w, device="meta"))
            assert port == _jax_route(e, stride, cin, b, h, w, jmesh), (world, name)
            rows.append(port)
        table[world] = rows
    assert "conv3" in table[1] and "conv3" not in table[WORLD]
    assert table[WORLD].count("1x1") == 13  # K5/K6 26 launches a step per rank


# --- (3) and (4) the train step ---------------------------------------------------------------------


def _one_process_step(cfg, model_sd, batch, steps):
    model = build_pose_net(cfg, device="cpu", trainable=True,
                           state_dict={k: torch.from_numpy(v) for k, v in model_sd.items()})
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    from ihpr_tpu_torch.data.augment import finalize_patch

    model.eval()
    with model.precision():
        joint_location_loss(model.coords(finalize_patch(t["patch"], t["color_scale"], cfg.data)),
                            t["joint_img"], t["joint_vis"], t["joints_have_depth"]).backward()
    eval_grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    opt, sched = make_optimizer(model, cfg, 10)
    step = make_train_step(model, opt, cfg, scheduler=sched)
    metrics = [{k: float(v) for k, v in step(t).items()} for _ in range(steps)]
    return eval_grads, metrics


def test_step_gradients_match_one_process_in_inference_bn(ranks):
    """The gradients of the global loss through DDP on 2 ranks, BN in
    inference mode, within 1e-6 of the global norm of one process's on the
    whole batch (JAX's dp8 test's bar); every rank holds the same."""
    _, _, _, cfg, model_sd, batch = ranks["inputs"]["step"]
    want, _ = _one_process_step(cfg, model_sd, batch, 0)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got = ranks["step"][0]["eval_grads"]
    for k, g in want.items():
        assert np.abs(got[k] - g).max() <= 1e-6 * norm, k
    assert ranks["step"][1]["eval_grads"] == R.digest(got)


def test_train_step_matches_one_process_and_keeps_ranks_equal(ranks):
    """Three train-mode steps on 2 ranks against one process on the whole
    batch: the first step's loss and error components (the ranks' sums
    summed) within 1e-5, its grad_norm within 1e-4 (the R18 step test's
    bound); the later steps' losses within 1e-3 (Adam's first update is
    lr * sign(g), so fp32 noise in gradient entries near 0 moves those
    parameters by up to lr; measured 1.5e-4 at the second step on a batch
    of 4). After them the parameters and BN buffers are bitwise equal on
    both ranks."""
    _, _, _, cfg, model_sd, batch = ranks["inputs"]["step"]
    _, want = _one_process_step(cfg, model_sd, batch, 3)
    got = ranks["step"]
    assert got[0]["metrics"] == got[1]["metrics"]
    for r in got:
        for k in ("loss", "err_xy_voxels", "err_z_voxels"):
            assert r["metrics"][0][k] == pytest.approx(want[0][k], rel=1e-5), k
        assert r["metrics"][0]["grad_norm"] == pytest.approx(want[0]["grad_norm"], rel=1e-4)
        for i, (m, w) in enumerate(zip(r["metrics"][1:], want[1:])):
            assert m["loss"] == pytest.approx(w["loss"], rel=1e-3), i
    assert got[0]["state"] == got[1]["state"]  # digests of every tensor


def test_train_step_matches_jax_2_device_mesh(ranks):
    """The first 2-rank step against JAX's make_train_step on make_mesh(2)
    from the same weights and batch (fp32 "highest", lean BN): the bounds of
    test_fp32_train_step_matches_jax, on its batch (one sample a rank):
    loss 1e-5, grad_norm 1e-4, every gradient within 2e-4 of its tensor's
    largest, BN statistics 1e-5. On a batch of 4 random patches the
    train-mode step is ill-conditioned: JAX's own 1-device and 2-device
    steps differ by 0.068 of a tensor's largest gradient there, and so do
    the port's 1 process and 2 ranks (measured)."""
    jcfg, params, stats, cfg, _, batch = ranks["inputs"]["step"]
    jmesh = make_mesh(WORLD)
    jmodel = jax_build_pose_net(jcfg, mesh=jmesh)
    state, tx = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 10, params=params, batch_stats=stats,
                                       mesh=jmesh)
    step = jax_make_train_step(jmodel, tx, jcfg, jmesh, donate=False, debug_grads=True)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    to_np = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    ref_grads = {k: v.numpy() for k, v in from_jax_params(to_np(metrics["grads"]), stats, cfg).items()}
    ref_state = {k: v.numpy() for k, v in
                 from_jax_params(to_np(new_state.params), to_np(new_state.batch_stats), cfg).items()}
    got = ranks["step"][0]
    assert got["metrics"][0]["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert got["metrics"][0]["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-4)
    for k, g in got["first"]["grads"].items():
        assert _rel(g, ref_grads[k]) <= 2e-4, k
    for k, v in got["first"]["state"].items():
        if "running" in k:
            np.testing.assert_allclose(v, ref_state[k], rtol=1e-5, atol=1e-5, err_msg=k)


# --- (5) the Trainer on 2 ranks ----------------------------------------------------------------------


def test_trainer_rank_0_alone_writes_and_continue_is_bitwise(ranks):
    """Snapshots are written by rank 0 only (rank 1's manager writes
    nothing); epoch 0 then --continue through epoch 1 ends bitwise equal to
    the uninterrupted 2-rank run, on both ranks; the ranks agree bitwise."""
    a, b0, b = ([r[k] for r in ranks["trainer"]] for k in ("a", "b0", "b"))
    assert [r["writes"] for r in a] == [2, 0] and [r["writes"] for r in b0] == [1, 0]
    assert [r["writes"] for r in b] == [1, 0] and [r["start"] for r in b] == [(1, 0)] * WORLD
    for rank in range(WORLD):
        assert b[rank]["state"] == a[0]["state"]  # digests of model, Adam moments and counts
        assert b[rank]["losses"] == a[0]["losses"][1:]
    assert a[1]["state"] == a[0]["state"]


def test_snapshot_resumes_across_topologies(ranks):
    """A 2-rank snapshot resumes in 1 process, and a 1-process snapshot in 2
    ranks, each to the uninterrupted run's next-epoch losses. 2 ranks and 1
    process sum the BN statistics in other orders, and train-mode BN on
    synthetic frames amplifies that (measured 2.8e-5 relative after 3
    updates): 2e-4."""
    a = ranks["trainer"][0]["a"]
    one = ranks["inputs"]["one"]
    np.testing.assert_allclose(a["losses"], one["losses"], rtol=2e-4)
    d = ranks["tmp"] / "from2"
    shutil.copytree(f"{ranks['dirs']['b0']}/model_dump", d / "model_dump")
    resumed = _train_1proc(_cfg(d, per_device=4), 2, continue_train=True, rss_limit_mb=0)
    np.testing.assert_allclose(resumed["losses"], a["losses"][1:], rtol=2e-4)
    for r in ranks["trainer"]:
        assert r["c"]["start"] == (1, 0)
        np.testing.assert_allclose(r["c"]["losses"], one["losses"][1:], rtol=2e-4)


def test_disagreeing_resume_point_raises(ranks):
    """Ranks that find different latest snapshots (a directory not shared)
    refuse to train."""
    for msg in ranks["disagree"]:
        assert msg is not None and "disagree" in msg and "[0, 0]]" in msg


def test_one_rank_over_its_rss_limit_stops_both(tmp_path):
    """Rank 0 over its RSS limit, rank 1 with the watchdog off: the vote
    makes both snapshot mid-epoch and exit 75; rank 0 wrote the snapshot."""
    with pytest.raises(launch.RanksFailed) as info:
        launch.spawn(R.rss_ranks, WORLD, "gloo", _cfg(tmp_path / "run"), N_TRAIN, workdir=str(tmp_path))
    assert info.value.exitcodes == [EX_TEMPFAIL] * WORLD
    _, epoch, itr = CheckpointManager(str(tmp_path / "run")).load(0)
    assert (epoch, itr) == (0, 0)


# --- (6) ZeRO-1 -------------------------------------------------------------------------------------------


def test_zero1_matches_replicated_and_its_snapshot_resumes_without_it(ranks):
    """ZeRO-1 on 2 ranks, with the global-norm clip active, weight decay and
    a learning-rate decay after epoch 0 (the schedule must reach the inner
    optimizers): the parameters after two epochs within 1e-6 of the
    replicated run's, the consolidated Adam state too; its snapshot
    (single-process format) resumes without ZeRO into that state and
    trains on."""
    r0, r1 = ranks["zero"]
    assert r0["zero"]["writes"] == 2 and r1["zero"]["writes"] == 0
    rep_keys, zero_keys = r0["keys"]
    assert rep_keys == zero_keys and any(k.startswith("opt/") for k in zero_keys)
    for r in (r0, r1):  # rank 1 holds the parameters, rank 0 the consolidated Adam state too
        assert r["zero_vs_rep"] and max(r["zero_vs_rep"].values()) <= 1e-6, r["zero_vs_rep"]
        assert r["resumed_optimizer"] == "OptaxAdam"
        assert r["resumed"] == r0["zero"]["state"]
        assert np.all(np.isfinite(r["resumed_losses"]))


def test_zero1_clips_by_the_global_norm(ranks):
    """In those runs every logged gradient norm (the reduced gradients',
    before the clip) is above the clip norm, so the clip acts on every
    step, and ZeRO's norms are the replicated run's: a clip by each shard's
    own norm would have moved the parameters elsewhere."""
    clip = ranks["inputs"]["zero_cfg"].optim.grad_clip_norm
    rep, zero = ranks["zero"][0]["rep"]["grad_norms"], ranks["zero"][0]["zero"]["grad_norms"]
    assert len(rep) == 4 and min(rep) > clip
    np.testing.assert_allclose(zero, rep, rtol=1e-6)


# --- (7) the Tester ---------------------------------------------------------------------------------------


def test_tester_gathers_rows_and_rank_0_alone_writes(ranks, tmp_path):
    """The 2-rank Tester's predictions (gathered in rank order, scattered by
    sample_idx, the padded last batch included) equal one process's within
    fp32 noise (1e-5 voxel), every rank returns the same metrics, and only
    rank 0 writes result files."""
    tcfg, model_sd = ranks["inputs"]["test"]
    model = build_pose_net(tcfg, device="cpu", state_dict={k: torch.from_numpy(v) for k, v in model_sd.items()})
    one = ttester.Tester(tcfg.replace(output_dir=str(tmp_path)),
                         dataset=datasets.build_dataset("Human36M", "test", tcfg, "synthetic", N_TEST),
                         state=model, num_workers=0, device="cpu")
    try:
        want = one.predict_voxels()
        want_metrics = one.evaluate()
    finally:
        one.close()
    got = ranks["tester"]
    assert want.shape == (N_TEST, 18, 3) and np.abs(want - 7.5).max() > 1.0
    for r in got:
        np.testing.assert_allclose(r["preds"], want, rtol=0, atol=1e-5)
        assert r["metrics"].keys() == want_metrics.keys()
        for k, v in want_metrics.items():
            assert r["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-4), k
    assert len(got[0]["written"]) >= 2 and got[1]["written"] == []


# --- (8) a JAX 2-device snapshot resumes in 2 ranks ----------------------------------------------------


@pytest.mark.parametrize("shard_opt_state", [False, True], ids=["replicated", "zero"])
def test_jax_2_device_snapshot_resumes_in_2_ranks(ranks, shard_opt_state):
    """A JAX Trainer's snapshot_0 from a 2-device mesh (with and without
    shard_opt_state, whose moments device_get gathers to full arrays),
    converted by from_jax_train_state: both ranks resume at epoch 1 from
    exactly the converted state (weights, BN statistics, Adam moments and
    counts) and train the epoch with finite losses, equal on both ranks."""
    _, want = ranks["inputs"]["jax"][shard_opt_state]
    got = ranks[f"jax_{shard_opt_state}"]
    for r in got:
        assert r["start"] == (1, 0)
        assert r["state"] == R.digest(want)
        assert len(r["losses"]) == 2 and np.all(np.isfinite(r["losses"]))
    assert got[0]["losses"] == got[1]["losses"]


# --- (9) the CLIs -------------------------------------------------------------------------------------------

_RUN = """
import sys
from ihpr_tpu_torch import config as tconfig
tconfig.CONFIGS["tiny_r18"] = tconfig.Config(
    name="tiny_r18",
    model=tconfig.ModelConfig(resnet_type=18, compute_dtype="bfloat16", fp32_logits=False, bn_mode="lean"),
    data=tconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(64, 64),
                            output_shape=(16, 16), depth_dim=16, use_aug=False),
    optim=tconfig.OptimConfig(batch_size_per_device=2),
    eval=tconfig.EvalConfig(batch_size_per_device=2),
)
from ihpr_tpu_torch import train, test
common = ["--config", "tiny_r18", "--synthetic", "--device", "cpu", "--multihost", "--num_workers", "0",
          "--output_dir", sys.argv[2]]
if sys.argv[1] == "train":
    train.main(common + ["--synthetic_size", "8", "--steps", "1", "--end_epoch", "1", "--rss_limit_mb", "0",
                         "--shard_opt_state"])
else:
    test.main(common + ["--synthetic_size", "6"])
"""


def test_cli_multihost_under_torchrun(tmp_path):
    """``--multihost --shard_opt_state`` under torchrun (2 ranks, gloo on the
    CPU): the train CLI trains an epoch on the global batch of 4 and rank 0
    writes its snapshot; the test CLI, launched the same way, evaluates it
    data-parallel."""
    script = tmp_path / "run.py"
    script.write_text(_RUN)
    out = tmp_path / "out"
    for mode in ("train", "test"):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(WORLD),
             str(script), mode, str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO},
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
    log = (out / "log" / "train_logs.txt").read_text()
    assert "global batch 4 on 2 rank(s)" in log
    _, epoch, itr = CheckpointManager(str(out)).load(0)
    assert (epoch, itr) == (0, -1)
    assert (out / "result" / "metrics_Human36M.json").exists()
    assert proc.stdout.count("MPJPE") >= WORLD  # every rank prints the metrics


def test_cli_flags_ported_and_refused():
    """--multihost, --shard_opt_state, --pretrained and --spatial (train) and
    --multihost and --spatial (test) are ported (tests/test_torch_spatial.py
    runs --spatial); so is --vis (test; tests/test_torch_vis.py holds the
    overlays)."""
    args = train_cli.parse_args(["--synthetic", "--multihost", "--shard_opt_state", "--pretrained", "x.msgpack"])
    assert args.multihost and args.shard_opt_state and args.pretrained == "x.msgpack"
    assert test_cli.parse_args(["--synthetic", "--multihost"]).multihost
    assert train_cli.parse_args(["--synthetic", "--spatial", "2"]).spatial == 2
    assert test_cli.parse_args(["--synthetic", "--spatial", "2"]).spatial == 2
    assert test_cli.parse_args(["--synthetic", "--vis"]).vis


def test_data_axis_and_spatial_checks():
    """data_axis_size None means the world size over the spatial axis;
    another value raises. Without a process group the layout is one
    process, where a spatial axis of 2 does not divide the world. Rows that
    split unevenly are taken, as JAX takes them (tests/test_torch_spatial.py
    runs such grids); a spatial axis that does not divide the ranks is the
    refusal left."""
    cfg = _cfg()
    assert mesh.data_parallel(cfg) == mesh.SINGLE
    with pytest.raises(ValueError, match="data_axis_size=2"):
        mesh.data_parallel(cfg.replace(parallel=dataclasses.replace(cfg.parallel, data_axis_size=2)))
    with pytest.raises(ValueError, match="does not divide the 1 rank"):
        mesh.data_parallel(cfg.replace(parallel=dataclasses.replace(cfg.parallel, spatial_axis_size=2)))
    mesh.check_row_shards(2, 2, 96)  # 3 rows at stride 32: rank 0 holds 2, rank 1 one
    assert [mesh.row_range(3, r, 2) for r in range(2)] == [(0, 2), (2, 3)]
    with pytest.raises(ValueError, match="does not divide the 2 rank"):
        mesh.check_row_shards(3, 2, 96)
