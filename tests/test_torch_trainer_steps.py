"""The port's Trainer against the JAX package's Trainer, step by step, on the
CPU: the same config and seed, the tiny ResNet-18 config (64x64, J = 18,
D = 16) in fp32 "highest" with lean BN and augmentation on, 16 synthetic
samples in batches of 4 (4 steps an epoch), 2 epochs, the lr decayed by 10
after epoch 0 (so at the fifth step, inside the run). Both loops run as
they are (``train``), JAX's through its own objects; the test only records
what each step takes and gives: the batch (``sample_idx``), the lr its
update uses, its loss, and the state at each epoch's snapshot.

Bars, each from a measurement on this config (JAX 0.9.0, torch 2.13 on
the CPU):

- the initial state within 4 ulp, as ``tests/test_torch_jax_init.py``
  holds the draw (measured 3);
- each step's ``sample_idx`` bitwise and its lr equal (float32 against
  float64: 1e-6 relative);
- the first step's loss within 1e-6 relative (measured: equal), each
  later one within 2e-3 (measured at most 5.6e-4);
- after each epoch, the update from the initial state (all parameters)
  within 0.7 of JAX's update in norm (measured 0.446 / 0.457 after epochs
  0 / 1), each tensor's within 0.9 of its own (measured at most 0.797; a
  tensor left unchanged gives 1, a reversed update 2); BN's running
  statistics: each tensor within 0.95 of JAX's move from the initial
  value in its largest element (measured at most 0.865; statistics left
  unchanged give 1), all together within 0.6 of it in norm (measured
  0.134 / 0.306).

The updates are not held tighter because the tiny train-mode step is
ill-conditioned, JAX's more than the port's. The witness is JAX's own
Trainer from its initial parameters perturbed by 1e-7 relative
(``test_port_is_as_near_jax_as_jax_is_to_itself``): its update lands 0.321
/ 0.331 of its norm from the unperturbed run's (each tensor up to 0.629),
its running statistics up to 0.846 of their move, its losses up to 2.5e-4
apart. The port is 1.4x as far from JAX as that in update norm and 2.2x
in loss (bars 2 and 3). The port's own run from a start perturbed by 1e-7
moves less: 0.136 / 0.143 (each tensor up to 0.409). The difference in
conditioning fits ROADMAP's Traps ("XLA's CPU BN sums":
``test_torch_checkpoint.py::test_jax_snapshot_gradient_gap_is_xla_bn_sums``
shows XLA's sums of BN's statistics ~100x less accurate than ATen's on
this config); this test does not show that they cause the gap.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.engine.trainer import Trainer as JaxTrainer
from ihpr_tpu_torch.data import datasets, skeletons
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models.convert import from_jax_params
from test_torch_jax_init import _check_close
from test_torch_models import jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

SAMPLES, BATCH, EPOCHS = 16, 4, 2
LR = 1e-3

LOSS_FIRST_RTOL = 1e-6
LOSS_RTOL = 2e-3
UPDATE_GLOBAL = 0.7
UPDATE_TENSOR = 0.9
STATS = 0.95
STATS_GLOBAL = 0.6
PERTURB = 1e-7
# The port against JAX over JAX against its own perturbed start.
WITNESS_UPDATE = 2.0
WITNESS_LOSS = 3.0


def _jcfg(out):
    jcfg = jax_tiny_cfg(matmul_precision="highest", bn_mode="lean")
    return jcfg.replace(
        output_dir=str(out),
        optim=dataclasses.replace(jcfg.optim, batch_size_per_device=BATCH, lr=LR, lr_dec_epoch=(1,),
                                  end_epoch=EPOCHS, snapshot_interval=1),
        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1),
    )


def _record_loader(loader, taken):
    """Wrap ``loader.epoch`` so each batch it yields appends its sample_idx."""
    epoch = loader.epoch

    def recording(*a, **kw):
        for hb in epoch(*a, **kw):
            taken.append(np.asarray(hb.sample_idx).copy())
            yield hb

    loader.epoch = recording


def _perturbed(a: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """``a`` times (1 + PERTURB * a standard normal draw), in float32."""
    return (a * (1 + PERTURB * rng.standard_normal(a.shape))).astype(np.float32)


def _run_jax(out, perturb: bool = False):
    """JAX's Trainer, 2 epochs: its initial state, each step's (loss, lr),
    each batch's sample_idx, and the state at each epoch's save. With
    ``perturb``, from its initial parameters perturbed (``_perturbed``)."""
    jcfg = _jcfg(out)
    jds = jdatasets.PoseDataset("Human36M", jskeletons.H36M,
                                jdatasets.make_synthetic(jskeletons.H36M, SAMPLES, seed=0, img_size=200), True)
    t = JaxTrainer(jcfg, datasets=[jds], num_workers=0)
    if perturb:
        rng = np.random.RandomState(1)
        params = jax.tree.map(lambda p: jax.numpy.asarray(_perturbed(np.asarray(p), rng)), t.state.params)
        t.state = t.state.replace(params=params, opt_state=t.tx.init(params))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    init = (to_np(t.state.params), to_np(t.state.batch_stats))
    steps, taken, saved = [], [], []

    def recording(fn):
        def step(state, batch, rng):
            lr = float(t.lr_sched(int(state.step)))
            state, metrics = fn(state, batch, rng)
            steps.append((float(metrics["loss"]), lr))
            return state, metrics

        return step

    t.step_fn, t.lean_step_fn = recording(t.step_fn), recording(t.lean_step_fn)
    _record_loader(t.loader, taken)
    t.ckpt.save = lambda epoch, state, rng, itr=-1: saved.append((to_np(state.params), to_np(state.batch_stats)))
    assert t.steps_per_epoch == SAMPLES // BATCH
    t.train(EPOCHS)
    return jcfg, init, steps, taken, saved


def _run_port(cfg, perturb: bool = False):
    """The port's Trainer, the same records as ``_run_jax``'s, as state_dicts."""
    ds = datasets.PoseDataset("Human36M", skeletons.H36M,
                              datasets.make_synthetic(skeletons.H36M, SAMPLES, seed=0, img_size=200), is_train=True)
    t = Trainer(cfg, datasets=[ds], num_workers=0, device="cpu", rss_limit_mb=0)
    if perturb:
        rng = np.random.RandomState(1)
        with torch.no_grad():
            for p in t.model.parameters():
                p.copy_(torch.from_numpy(_perturbed(p.numpy(), rng)))
    numpy_sd = lambda: {k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()}  # noqa: E731
    init = numpy_sd()
    steps, taken, saved = [], [], []

    def recording(fn):
        def step(*a):
            lr = t.state.optimizer.param_groups[0]["lr"]
            metrics = fn(*a)
            steps.append((float(metrics["loss"]), lr))
            return metrics

        return step

    t.step_fn, t.lean_step_fn = recording(t.step_fn), recording(t.lean_step_fn)
    _record_loader(t.loader, taken)
    t.ckpt.save = lambda epoch, state, itr=-1: saved.append(numpy_sd())
    try:
        t.train(EPOCHS)
    finally:
        t.close()
    return init, steps, taken, saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, jinit, jsteps, jtaken, jsaved = _run_jax(tmp_path_factory.mktemp("jax"))
    cfg = to_port_cfg(jcfg).replace(output_dir=str(tmp_path_factory.mktemp("port")))
    assert cfg.data.use_aug and cfg.model.matmul_precision == "highest" and cfg.model.bn_mode == "lean"
    to_port = lambda tree: {k: v.numpy() for k, v in from_jax_params(*tree, cfg).items()}  # noqa: E731
    jax_run = dict(init=to_port(jinit), steps=jsteps, taken=jtaken, saved=[to_port(s) for s in jsaved])
    _, _, psteps, _, psaved = _run_jax(tmp_path_factory.mktemp("jax_perturbed"), perturb=True)
    jax_run["perturbed"] = dict(steps=psteps, saved=[to_port(s) for s in psaved])
    init, steps, taken, saved = _run_port(cfg)
    return jax_run, dict(init=init, steps=steps, taken=taken, saved=saved), cfg


def test_trainers_start_from_one_state(runs):
    """Before the first step the port's Trainer holds JAX's Trainer's
    initial model: every tensor within 4 ulp."""
    want, got, _ = runs
    assert got["init"].keys() == want["init"].keys()
    for k, w in want["init"].items():
        _check_close(got["init"][k], w, k)


def test_trainers_take_the_same_batches_at_the_same_lr(runs):
    """Step by step across the epoch boundary: the same samples in the same
    order (bitwise), and the same lr, decayed by 10 from the fifth step."""
    want, got, _ = runs
    n = EPOCHS * SAMPLES // BATCH
    assert len(got["taken"]) == len(want["taken"]) == len(got["steps"]) == len(want["steps"]) == n
    for i, (a, b) in enumerate(zip(got["taken"], want["taken"])):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    lrs = [lr for _, lr in want["steps"]]
    assert lrs == pytest.approx([LR] * 4 + [LR / 10] * 4, rel=1e-6)
    assert [lr for _, lr in got["steps"]] == pytest.approx(lrs, rel=1e-6)


def test_trainers_losses_match_step_by_step(runs):
    """The first step's loss (one state, one batch) within 1e-6 relative of
    JAX's, each later one within 2e-3."""
    want, got, _ = runs
    for i, ((a, _), (b, _)) in enumerate(zip(got["steps"], want["steps"])):
        rtol = LOSS_FIRST_RTOL if i == 0 else LOSS_RTOL
        assert np.isfinite(a) and a == pytest.approx(b, rel=rtol), (i, a, b)


def _update_gaps(saved, want, start):
    """For each epoch: the update from ``start`` of ``saved`` against that of
    ``want``, in norm over all parameters and per tensor, relative to
    ``want``'s; and the running statistics' gaps relative to ``want``'s move
    from ``start``, per tensor (largest element) and in norm over all."""
    out = []
    for g, w in zip(saved, want):
        assert g.keys() == w.keys()
        d2 = n2 = s2 = m2 = 0.0
        tensor, stats = {}, {}
        for k in w:
            gap, move = g[k] - w[k], w[k] - start[k]
            assert np.linalg.norm(move) > 0, k
            if "running" in k:
                stats[k] = float(np.abs(gap).max() / np.abs(move).max())
                s2, m2 = s2 + float(np.linalg.norm(gap)) ** 2, m2 + float(np.linalg.norm(move)) ** 2
            else:
                tensor[k] = float(np.linalg.norm(gap) / np.linalg.norm(move))
                d2, n2 = d2 + float(np.linalg.norm(gap)) ** 2, n2 + float(np.linalg.norm(move)) ** 2
        out.append(dict(update=np.sqrt(d2 / n2), tensor=tensor, stats=stats, stats_norm=np.sqrt(s2 / m2)))
    return out


def _loss_gaps(steps, want):
    return [abs(a - b) / abs(b) for (a, _), (b, _) in zip(steps, want)]


def test_trainers_states_match_after_each_epoch(runs):
    """After each epoch (the snapshot's state): the update from the initial
    state within 0.7 of JAX's in norm, each tensor's within 0.9 of its own;
    BN's running statistics within 0.95 of JAX's move in each tensor and
    0.6 of it in norm."""
    want, got, _ = runs
    assert len(got["saved"]) == len(want["saved"]) == EPOCHS
    for epoch, gaps in enumerate(_update_gaps(got["saved"], want["saved"], want["init"])):
        assert gaps["update"] <= UPDATE_GLOBAL, (epoch, gaps["update"])
        worst = max(gaps["tensor"], key=gaps["tensor"].get)
        assert gaps["tensor"][worst] <= UPDATE_TENSOR, (epoch, worst, gaps["tensor"][worst])
        worst = max(gaps["stats"], key=gaps["stats"].get)
        assert gaps["stats"][worst] <= STATS, (epoch, worst, gaps["stats"][worst])
        assert gaps["stats_norm"] <= STATS_GLOBAL, (epoch, gaps["stats_norm"])


def test_port_is_as_near_jax_as_jax_is_to_itself(runs):
    """The witness of the bars: JAX's Trainer from its initial parameters
    perturbed by 1e-7 relative lands 0.2 or more of its update's norm from
    its unperturbed run (measured 0.321 / 0.331); the port's update is
    within 2x that of JAX's (measured 1.4x) and its losses within 3x JAX's
    own loss gap (measured 2.2x)."""
    want, got, _ = runs
    own = _update_gaps(want["perturbed"]["saved"], want["saved"], want["init"])
    port = _update_gaps(got["saved"], want["saved"], want["init"])
    for epoch, (o, p) in enumerate(zip(own, port)):
        assert o["update"] >= 0.2, (epoch, o["update"])
        assert p["update"] <= WITNESS_UPDATE * o["update"], (epoch, p["update"], o["update"])
    own_loss = max(_loss_gaps(want["perturbed"]["steps"], want["steps"]))
    port_loss = max(_loss_gaps(got["steps"], want["steps"]))
    assert 0 < port_loss <= WITNESS_LOSS * own_loss, (port_loss, own_loss)
