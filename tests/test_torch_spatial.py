"""Spatial partitioning in the port on the CPU: each sample's image rows
split over gloo ranks (a D x S grid, ``ihpr_tpu_torch/parallel/mesh.py``),
held against one process and against the JAX package's ``(data, spatial)``
mesh on its virtual devices (tests/conftest.py gives JAX 8).

The ranks run ``tests/torch_dp_ranks.py`` (torch and the port only) through
``parallel.launch.spawn``: one spawn of two ranks (S = 2) and, at the same
time, one of four (S = 4, and D = 2 x S = 2), each running every rank job
of its world, and one of three (S = 3). Sizes: ResNet-18, J = 18, D = 16,
fp32 "highest" lean BN; 64x64 at S = 2, 128x128 at S = 4 and at 2 x 2 (rows
split evenly at every stage); 64x64 on a 1 x 4 grid (the 2 rows at stride
32 over 4 ranks: two own none) and 128x128 at S = 3 (4 rows at stride 32
over 3) in GSPMD's layout (``mesh.row_range``). The halo'd layers and the
integral also run on shards of odd sizes and on empty ones. The s2d stem
runs on an S = 2 grid at 64x64 and an S = 3 grid at 128x128 (``S2D``).

Tolerances: each halo'd layer 1e-6 of the result's largest; the row-sharded
integral 1e-5 voxel (coords) and 1e-6 of dv's largest; eval-mode gradients
on the grid ||g - g_1|| <= 1e-5 max(|g_1|, 1) for each tensor, the bound of
JAX's own test_spatial_train_step_matches_unpartitioned, and its train-mode
loss within rtol 1e-5; the step against JAX's mesh at
test_torch_dp.py:test_train_step_matches_jax_2_device_mesh's bounds; the
flip-test eval step against unpartitioned JAX within 2e-3 voxel.
"""

import concurrent.futures
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.parallel import make_eval_step as jax_make_eval_step
from ihpr_tpu.parallel import make_train_step as jax_make_train_step
from ihpr_tpu.parallel.mesh import make_mesh
from ihpr_tpu_torch.data import datasets
from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.server import PoseServer
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops import integral_volume as iv
from ihpr_tpu_torch.ops.loss import joint_location_loss
from ihpr_tpu_torch.parallel import launch, mesh
from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

import torch_dp_ranks as R

torch.set_num_threads(1)

GRIDS = {"2": (2, 2), "4": (4, 4), "2x2": (4, 2), "1x4": (4, 4), "3": (3, 3),
         "s2d_2": (2, 2), "s2d_3": (3, 3)}  # name: (world, S)
SIZE = {"2": 64, "4": 128, "2x2": 128, "1x4": 64, "3": 128,
        "s2d_2": 64, "s2d_3": 128}  # input rows (and columns) of each grid's steps
# The grids whose model has the space-to-depth stem (32 stem rows over 2;
# 64 over 3, in blocks of 22, 22 and 20).
S2D = ("s2d_2", "s2d_3")
# Each grid's batch is 2 samples, as test_torch_train._train_batch: the R18
# train-mode step on 4 random patches is ill-conditioned (test_torch_dp.py).
N_TRAIN, N_TEST = 8, 6  # the CLI's synthetic samples


def _batch(b, size, seed=20, j=18):
    """test_torch_train._train_batch at ``size`` x ``size`` with ``b`` samples."""
    rng = np.random.RandomState(seed)
    return {
        "patch": rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8),
        "color_scale": rng.uniform(0.8, 1.2, (b, 3)).astype(np.float32),
        "joint_img": rng.uniform(0, size / 4, (b, j, 3)).astype(np.float32),
        "joint_vis": (rng.rand(b, j) > 0.2).astype(np.float32),
        "joints_have_depth": np.array([1.0, 0.0] * (b // 2), np.float32),
    }


def _jcfg(size, per_device=2, data_axis_size=None, spatial=1, s2d=False):
    """The JAX tiny config at size x size (heatmaps size / 4), fp32 "highest"
    lean BN, ``per_device`` samples a data index, the s2d stem with ``s2d``."""
    jcfg = jax_tiny_cfg(matmul_precision="highest", bn_mode="lean", s2d_stem=s2d)
    return jcfg.replace(
        data=dataclasses.replace(jcfg.data, input_shape=(size, size), output_shape=(size // 4, size // 4)),
        optim=dataclasses.replace(jcfg.optim, batch_size_per_device=per_device, lr=1e-3),
        eval=dataclasses.replace(jcfg.eval, batch_size_per_device=per_device),
        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=data_axis_size, spatial_axis_size=spatial),
    )


# Each layer of the halo table: (name, kind, kernel, stride, input rows a rank
# when they split evenly).
_LAYERS = (("stem_7x7s2", "conv", 7, 2, 16), ("3x3s1", "conv", 3, 1, 4), ("3x3s2", "conv", 3, 2, 4),
           ("1x1s2", "conv", 1, 2, 4), ("maxpool_3s2", "pool", 3, 2, 4), ("deconv_4s2", "deconv", 4, 2, 2))
# The whole input's rows of each layer on uneven shards (mesh.row_range):
# S = 3 gives blocks of odd and unequal sizes; S = 4 gives empty ones, and
# 1x1s2's rank 1 reads a row of rank 2's.
UNEVEN_ROWS = {3: {"stem_7x7s2": 20, "3x3s1": 10, "3x3s2": 10, "1x1s2": 10, "maxpool_3s2": 10, "deconv_4s2": 5},
               4: {"stem_7x7s2": 6, "3x3s1": 3, "3x3s2": 6, "1x1s2": 10, "maxpool_3s2": 3, "deconv_4s2": 2}}


def _layer_cases(spatial, seed=0, uneven=False):
    """(name, kind, layer kwargs, x, weight, cotangent) for each row of the
    halo table: every layer's local rows even, the stem's input 16 rows a
    rank; or with ``uneven`` the rows of ``UNEVEN_ROWS``."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    cases = []
    for name, kind, k, stride, rows_per_rank in _LAYERS:
        cin, cout = (3, 8) if name.startswith("stem") else (8, 6)
        h = UNEVEN_ROWS[spatial][name] if uneven else rows_per_rank * spatial
        x = rng.randn(2, cin, h, 6).astype(f32)
        if kind == "conv":
            kw = dict(cin=cin, cout=cout, kernel=k, stride=stride, compute_dtype=torch.float32)
            w = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(f32)
        elif kind == "deconv":
            kw = dict(cin=cin, cout=cout, compute_dtype=torch.float32)
            w = (rng.randn(cin, cout, 4, 4) / np.sqrt(cin * 4)).astype(f32)
        else:
            kw, w = {}, None
        out_rows = h * 2 if kind == "deconv" else mesh.conv_rows(h, k, stride, k // 2)
        out_ch = cin if kind == "pool" else cout
        cot = rng.randn(2, out_ch, out_rows, 12 if kind == "deconv" else 6 // stride).astype(f32)
        cases.append((name, kind, kw, x, w, cot))
    return cases


def _integral_cases(spatial, seed=1, h=None):
    """(name, vol (B, H*W, J*D), J, D, W, g), float64: random logits; a peak
    across the boundary of the first two shards; all the mass on the last
    shard that holds rows (the others' logits 1000 below it, so their weight
    exp(m_r - M) underflows to 0). ``h``: the volume's rows (default 4 a
    rank), split by ``mesh.row_range``. float64, so that the bars measure
    the merge: in fp32 the peak's dv = p g . (pos - coords) cancels in
    (pos - coords), and two roundings of the coords apart move it by 2.6e-6
    of dv's largest (measured at S = 4)."""
    rng = np.random.RandomState(seed)
    h = 4 * spatial if h is None else h
    b, j, d, w = 2, 3, 5, 4
    shape = (b, h, w, j, d)
    rand = rng.randn(*shape) * 2.0
    peak = rng.randn(*shape) * 0.1
    edge = mesh.row_range(h, 0, spatial)[1]
    peak[:, edge - 1:edge + 1, 1:3, :, 2] += 12.0
    one = rng.randn(*shape)
    one[:, :_mass_shard(h, spatial)[1][0]] -= 1000.0
    cases = []
    for name, v in (("random", rand), ("peak_on_boundary", peak), ("one_shard", one)):
        g = rng.randn(b, j, 3)
        cases.append((name, np.ascontiguousarray(v.reshape(b, h * w, j * d)), j, d, w, g))
    return cases


def _mass_shard(h, spatial):
    """(index, rows) of the last rank that holds rows of an h-row volume."""
    return max((r, mesh.row_range(h, r, spatial)) for r in range(spatial)
               if mesh.row_range(h, r, spatial)[1] > mesh.row_range(h, r, spatial)[0])


UNEVEN_INTEGRAL_ROWS = {3: 5, 4: 3}  # 2 + 2 + 1 rows; 1 + 1 + 1 + 0


def _step_inputs(name):
    world, spatial = GRIDS[name]
    size = SIZE[name]
    jcfg = _jcfg(size, per_device=2 // (world // spatial), s2d=name in S2D)
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    cfg = to_port_cfg(jcfg)
    model_sd = {k: v.numpy() for k, v in from_jax_params(params, stats, cfg).items()}
    batch = _batch(2, size)
    return jcfg, params, stats, cfg, model_sd, batch


_TORCHRUN = """
import sys
from ihpr_tpu_torch import config as tconfig
from torch_dp_ranks import spatial_cli_cfg
tconfig.CONFIGS["tiny_spatial"] = spatial_cli_cfg()
from ihpr_tpu_torch import train, test
common = ["--config", "tiny_spatial", "--synthetic", "--device", "cpu", "--multihost", "--num_workers", "0",
          "--output_dir", sys.argv[2], "--spatial", "2"]
if sys.argv[1] == "train":
    train.main(common + ["--synthetic_size", "4", "--end_epoch", "1", "--rss_limit_mb", "0"])
else:
    test.main(common + ["--synthetic_size", "4"])
"""


def _start_torchrun(out):
    """``train.main`` and then ``test.main`` with ``--multihost --spatial 2``
    under ``torch.distributed.run`` (2 ranks, gloo), in a thread; returns a
    function that waits and returns the two processes' (exit code, stdout,
    stderr)."""
    import subprocess
    import sys

    out.mkdir(parents=True)
    script = out / "run.py"
    script.write_text(_TORCHRUN)
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(tests_dir), tests_dir])}

    def run():
        procs = []
        for mode in ("train", "test"):
            p = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                 str(script), mode, str(out)],
                capture_output=True, text=True, timeout=400, env=env,
            )
            procs.append((p.returncode, p.stdout, p.stderr[-3000:]))
        return procs

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future.result


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank job, in one spawn of two ranks and one of four, with the
    inputs they were given."""
    tmp = tmp_path_factory.mktemp("spatial")
    inputs = {"layers": {s: _layer_cases(s) for s in (2, 4)},
              "integral": {s: _integral_cases(s) for s in (2, 4)},
              "layers_uneven": {s: _layer_cases(s, uneven=True) for s in (3, 4)},
              "integral_uneven": {s: _integral_cases(s, h=UNEVEN_INTEGRAL_ROWS[s]) for s in (3, 4)},
              "step": {name: _step_inputs(name) for name in GRIDS}}
    serve_cfg = to_port_cfg(_jcfg(64))
    _, params, stats = jax_pose_weights(_jcfg(64), seed=8)
    serve_sd = {k: v.numpy() for k, v in from_jax_params(params, stats, serve_cfg).items()}
    patches = np.random.RandomState(3).randint(0, 256, (6, 64, 64, 3)).astype(np.uint8)
    inputs["serve"] = (serve_cfg, serve_sd, patches)
    inputs["cli"] = (R.spatial_cli_cfg(), str(tmp / "cli"))
    jobs = {world: [] for world in (2, 4, 3)}
    for world in (2, 4):
        jobs[world] += [("layers", "halo_layer_ranks", (inputs["layers"][world],)),
                        ("integral", "row_integral_ranks", (inputs["integral"][world],))]
    for world in (3, 4):
        jobs[world] += [("layers_uneven", "halo_layer_ranks", (inputs["layers_uneven"][world],)),
                        ("integral_uneven", "row_integral_ranks", (inputs["integral_uneven"][world],))]
    for world in jobs:
        for name, (w, spatial) in GRIDS.items():
            if w == world:
                _, _, _, cfg, model_sd, batch = inputs["step"][name]
                jobs[world].append((f"step_{name}", "spatial_step_ranks", (cfg, model_sd, batch, spatial)))
    jobs[2].append(("serve", "spatial_serve_ranks", inputs["serve"]))
    jobs[2].append(("export", "spatial_export_ranks", inputs["serve"]))
    jobs[2].append(("cli", "spatial_cli_ranks", (*inputs["cli"], N_TRAIN, N_TEST)))
    # The three launches and the CLIs under torchrun run at once, each in a
    # store of its own.
    torchrun = _start_torchrun(tmp / "torchrun")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {world: pool.submit(launch.spawn, R.run_jobs, world, "gloo", jobs[world], workdir=str(tmp))
                   for world in jobs}
        # Meanwhile, one process on each grid's whole batch.
        one = {name: _one_process(*inputs["step"][name][3:]) for name in GRIDS}
        ranks = {world: f.result() for world, f in futures.items()}
    results = {world: {name: [r[name] for r in ranks[world]] for name, _, _ in jobs[world]} for world in jobs}
    results["torchrun"] = torchrun()
    yield {"inputs": inputs, "tmp": tmp, "one": one, **results}
    shutil.rmtree(tmp)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- (a) the halo table -------------------------------------------------------------------------------


def _check_halo_layer(spawned, key, layer, spatial):
    """The ranks' outputs and input gradients of ``layer`` concatenate to the
    unsharded op's, and their weight gradients sum to its, within 1e-6 of
    each one's largest."""
    from ihpr_tpu_torch.models import resnet
    from ihpr_tpu_torch.models.head import Deconv

    _, kind, kw, x, w, cot = next(c for c in spawned["inputs"][key][spatial] if c[0] == layer)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    if kind == "pool":
        mod = None
        y = torch.nn.functional.max_pool2d(xt, 3, 2, 1)
    else:
        mod = Deconv(**kw) if kind == "deconv" else resnet.Conv(**kw)
        mod.weight.data = torch.from_numpy(w).contiguous(memory_format=torch.channels_last)
        y = mod(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    got = [r[layer] for r in spawned[spatial][key]]
    assert _rel(np.concatenate([r["out"] for r in got], axis=2), y.detach().numpy()) <= 1e-6
    assert _rel(np.concatenate([r["dx"] for r in got], axis=2), xt.grad.numpy()) <= 1e-6
    if mod is not None:
        for r in got:
            assert _rel(r["dw"], mod.weight.grad.numpy()) <= 1e-6
    return got


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("layer", [name for name, *_ in _LAYERS])
def test_halo_layer_matches_the_unsharded_op(spawned, layer, spatial):
    """Each layer of the halo table on S even row shards, forward and
    backward, against the unsharded op (``_check_halo_layer``)."""
    _check_halo_layer(spawned, "layers", layer, spatial)


@pytest.mark.parametrize("spatial", [3, 4])
@pytest.mark.parametrize("layer", [name for name, *_ in _LAYERS])
def test_halo_layer_on_uneven_shards_matches_the_unsharded_op(spawned, layer, spatial):
    """Each layer of the halo table on GSPMD's uneven row shards
    (``UNEVEN_ROWS``: blocks of unequal sizes at S = 3, empty blocks at
    S = 4, inputs from non-adjacent ranks), forward and backward, against
    the unsharded op (``_check_halo_layer``); each rank's output has its
    ``row_range`` of the output's rows."""
    got = _check_halo_layer(spawned, "layers_uneven", layer, spatial)
    total = sum(r["out"].shape[2] for r in got)
    assert [r["out"].shape[2] for r in got] == [np.subtract(*mesh.row_range(total, i, spatial)[::-1])
                                                for i in range(spatial)]


# --- (b) the row-sharded integral ---------------------------------------------------------------------


def _check_row_integral(spawned, key, case, spatial):
    """K3/K4's plain versions on the S row shards, merged, against plain /
    plain_bwd on the whole volume: coords within 1e-5 voxel and bitwise
    equal on every rank, dv within 1e-6 of its largest, nothing NaN; in
    one_shard every shard but the one with the mass has weight
    exp(m_r - M) = 0 and dv 0; a peak on the first boundary lands between
    its rows."""
    _, vol, j, d, w, g = next(c for c in spawned["inputs"][key][spatial] if c[0] == case)
    got = [r[case] for r in spawned[spatial][key]]
    v = torch.from_numpy(vol)
    coords, m, s = iv.plain(v, j, d, w)
    dv = iv.plain_bwd(v, m, s, coords, torch.from_numpy(g), j, d, w).numpy()
    for r in got:
        assert np.array_equal(r["coords"], got[0]["coords"])
        assert np.abs(r["coords"] - coords.numpy()).max() <= 1e-5
    got_dv = np.concatenate([r["dv"] for r in got], axis=1)
    assert np.isfinite(got_dv).all() and _rel(got_dv, dv) <= 1e-6
    h = vol.shape[1] // w
    if case == "one_shard":
        owner = _mass_shard(h, spatial)[0]
        for i, r in enumerate(got):
            if i != owner:
                assert np.all(np.exp(r["m"] - r["big_m"]) == 0.0)
                assert np.all(r["dv"] == 0.0)
    if case == "peak_on_boundary":
        edge = mesh.row_range(h, 0, spatial)[1]  # the peak straddles rows edge - 1 and edge
        assert edge - 1 < float(coords[..., 1].mean()) < edge
    return got


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("case", ["random", "peak_on_boundary", "one_shard"])
def test_row_sharded_integral_matches_the_whole_volume(spawned, case, spatial):
    """K3/K4's plain versions on S even row shards (``_check_row_integral``)."""
    _check_row_integral(spawned, "integral", case, spatial)


@pytest.mark.parametrize("spatial", [3, 4])
@pytest.mark.parametrize("case", ["random", "peak_on_boundary", "one_shard"])
def test_row_sharded_integral_on_uneven_and_empty_shards(spawned, case, spatial):
    """K3/K4's plain versions on uneven row shards in float64 (5 rows over 3
    ranks; 3 rows over 4, the last rank holding none), merged, against the
    whole volume (``_check_row_integral``); an empty shard's m is -inf, its
    s 0 and its dv empty."""
    got = _check_row_integral(spawned, "integral_uneven", case, spatial)
    h = UNEVEN_INTEGRAL_ROWS[spatial]
    for i, r in enumerate(got):
        lo, hi = mesh.row_range(h, i, spatial)
        assert r["dv"].shape[1] == (hi - lo) * 4
        if hi == lo:
            assert np.all(r["m"] == -np.inf)


# --- (c) the step on the grid against one process --------------------------------------------------------


def _one_process(cfg, model_sd, batch):
    """One process on the whole batch: the eval-mode loss and gradients, the
    flip-test eval coords and one train step's metrics."""
    from ihpr_tpu_torch.models.pose_net import inference_copy
    from ihpr_tpu_torch.parallel.train_step import make_eval_step

    sd = {k: torch.from_numpy(v) for k, v in model_sd.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict=sd)
    model.eval()
    with model.precision():
        loss = joint_location_loss(model.coords(finalize_patch(t["patch"], t["color_scale"], cfg.data)),
                                   t["joint_img"], t["joint_vis"], t["joints_have_depth"])
        loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    net = build_pose_net(cfg, device="cpu", state_dict=sd)
    coords = make_eval_step(inference_copy(net), cfg)(t)[0].numpy()
    opt, sched = make_optimizer(model, cfg, 10)
    metrics = {k: float(v) for k, v in make_train_step(model, opt, cfg, scheduler=sched)(t).items()}
    return float(loss), grads, coords, metrics


@pytest.fixture(scope="module")
def one_process(spawned):
    return spawned["one"]


def _ranks(spawned, name):
    return spawned[GRIDS[name][0]][f"step_{name}"]


def _data_mean(ranks, name, key):
    """The mean over the data indices of ``key`` (every spatial peer holds its data index's)."""
    spatial = GRIDS[name][1]
    return float(np.mean([r[key] for r in ranks[::spatial]]))


@pytest.mark.parametrize("name", list(GRIDS))
def test_eval_mode_gradients_on_the_grid_match_one_process(spawned, one_process, name):
    """BN in inference mode: the loss on the grid (the data axis's mean) within
    rtol 1e-6 of one process's on the whole batch, and every gradient after
    DDP's reduction (sum over the world, divided by D) within 1e-5 max(|g|, 1)
    of one process's in norm, JAX's bound for its (2, 4) mesh; every rank
    holds the same gradients."""
    ranks = _ranks(spawned, name)
    want_loss, want, _, _ = one_process[name]
    assert _data_mean(ranks, name, "eval_loss") == pytest.approx(want_loss, rel=1e-6)
    gn = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want.values()))
    got = ranks[0]["eval_grads"]
    for k, g in want.items():
        assert np.linalg.norm(got[k].astype(np.float64) - g) <= 1e-5 * max(gn, 1.0), k
    for r in ranks[1:]:
        assert r["eval_grads"] == R.digest(got)


@pytest.mark.parametrize("name", list(GRIDS))
def test_train_step_on_the_grid_matches_one_process(spawned, one_process, name):
    """One train-mode step (live BN statistics over the global batch): the
    loss within rtol 1e-5 of one process's, the same metrics on every rank,
    the parameters and BN buffers bitwise equal on every rank after it, and
    K3 and K4 (plain on the CPU) run once each a rank."""
    ranks = _ranks(spawned, name)
    want = one_process[name][3]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["metrics"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert r["state"] == ranks[0]["state"]
        assert r["k3_k4"] == (1, 1)


@functools.cache
def _jax_eval_step(size, s2d=False):
    """JAX's unpartitioned flip-test eval step at size x size, jitted once."""
    jcfg = _jcfg(size, s2d=s2d)
    return jax_make_eval_step(jax_build_pose_net(jcfg), jcfg)


@pytest.mark.parametrize("name", list(GRIDS))
def test_flip_test_eval_on_the_grid(spawned, one_process, name):
    """The flip-test eval step on the grid: spatial peers hold bitwise the
    same coords, and the data indices' coords concatenate to one process's
    within 1e-6 of the heatmap's extent (fp32 softmax sums over the volume
    in another order: 1.6e-5 voxel at 64x64, 3.2e-5 at 128x128), and to
    unpartitioned JAX's within 2e-3 voxel."""
    ranks = _ranks(spawned, name)
    spatial = GRIDS[name][1]
    for i, r in enumerate(ranks):
        assert np.array_equal(r["eval_coords"], ranks[i - i % spatial]["eval_coords"])
    got = np.concatenate([r["eval_coords"] for r in ranks[::spatial]])
    assert np.abs(got - one_process[name][2]).max() <= 1e-6 * SIZE[name] / 4
    jcfg, params, stats, _, _, batch = spawned["inputs"]["step"][name]
    jev = _jax_eval_step(SIZE[name], name in S2D)
    jcoords = np.asarray(jev(params, stats, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    assert np.abs(jcoords - 7.5).max() > 0.5
    assert np.abs(got - jcoords).max() <= 2e-3


# --- (d) against JAX's (data, spatial) mesh -------------------------------------------------------------------


def _jax_mesh(name):
    world, spatial = GRIDS[name]
    return make_mesh(world // spatial, spatial_axis_size=spatial)


def test_train_step_matches_jax_spatial_mesh(spawned):
    """The first step on the S = 2 grid against JAX's make_train_step on
    make_mesh(1, spatial_axis_size=2) (coords_plain, GSPMD's halos) from the
    same weights and batch: loss 1e-5, grad_norm 1e-4, every gradient within
    2e-4 of its tensor's largest, BN statistics 1e-5 (the bounds of
    test_torch_dp.py's 2-device test, on the 64x64 batch they were measured
    at). Train-mode steps on the other grids are held by their eval-mode
    gradients below: JAX's own (2, 2)-mesh train steps disagree with its
    1-device step by more than these bounds, at 128x128 through the step's
    ill-conditioning and at 64x64 in the backbone's gradients."""
    _check_train_step_against_jax(spawned, "2")


def test_s2d_train_step_matches_jax_spatial_mesh(spawned):
    """The s2d stem's first step on the S = 2 grid (each rank's stem takes
    image rows [2a - 4, 2b + 2) for its output rows [a, b)) against JAX's
    make_train_step on make_mesh(1, spatial_axis_size=2), at the bounds of
    ``test_train_step_matches_jax_spatial_mesh``; against the port's one
    process in ``test_train_step_on_the_grid_matches_one_process[s2d_2]``."""
    _check_train_step_against_jax(spawned, "s2d_2")


@pytest.mark.parametrize("name", S2D)
def test_s2d_eval_coords_match_jax_mesh(spawned, name):
    """The s2d stem's eval coords (flip-test on) on the S = 2 grid and on the
    uneven S = 3 grid against JAX's eval step on its own (1, S) mesh, at
    JAX's test_spatial_eval_step_matches_unpartitioned bar, 1e-4 voxel."""
    _check_eval_coords_against_jax_mesh(spawned, name)


def _check_train_step_against_jax(spawned, name):
    """The grid ``name``'s first step against JAX's mesh step from the same
    weights and batch (the bounds of ``test_train_step_matches_jax_spatial_mesh``)."""
    jcfg, params, stats, cfg, _, batch = spawned["inputs"]["step"][name]
    jmesh = _jax_mesh(name)
    jmodel = jax_build_pose_net(jcfg, mesh=jmesh)
    state, tx = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 10, params=params, batch_stats=stats,
                                       mesh=jmesh)
    step = jax_make_train_step(jmodel, tx, jcfg, jmesh, donate=False, debug_grads=True)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    to_np = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    ref_grads = {k: v.numpy() for k, v in from_jax_params(to_np(metrics["grads"]), stats, cfg).items()}
    ref_state = {k: v.numpy() for k, v in
                 from_jax_params(to_np(new_state.params), to_np(new_state.batch_stats), cfg).items()}
    got = _ranks(spawned, name)[0]
    assert got["metrics"]["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert got["metrics"]["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-4)
    for k, g in got["grads"].items():
        assert _rel(g, ref_grads[k]) <= 2e-4, k
    for k, v in got["stats"].items():
        np.testing.assert_allclose(v, ref_state[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["2", "4", "2x2"])
def test_eval_mode_gradients_match_jax_spatial_mesh(spawned, name):
    """BN in inference mode, the loss and its gradients on the grid against
    JAX's on make_mesh(D, spatial_axis_size=S) (test_spatial.py's own
    value_and_grad of coords_plain with the image's rows sharded) from the
    same weights and batch: the loss within rtol 1e-5, every gradient within
    1e-5 max(|g|, 1) in norm (``_check_eval_gradients_against_jax``)."""
    _check_eval_gradients_against_jax(spawned, name, _jax_mesh(name))


def _check_eval_gradients_against_jax(spawned, name, jmesh):
    """The grid's eval-mode loss and gradients against JAX's on ``jmesh``:
    the loss within rtol 1e-5, every gradient within 1e-5 max(|g|, 1) in
    norm."""
    from ihpr_tpu.data.augment import finalize_patch as jax_finalize_patch
    from ihpr_tpu.ops import joint_location_loss as jax_loss
    from ihpr_tpu.parallel.mesh import batch_sharding, image_sharding, replicated_sharding

    jcfg, params, stats, cfg, _, batch = spawned["inputs"]["step"][name]
    jmodel = jax_build_pose_net(jcfg)

    def loss_fn(p, b):
        image = jax_finalize_patch(b["patch"], b["color_scale"], jcfg.data)
        image = jax.lax.with_sharding_constraint(image, image_sharding(jmesh))
        c = jmodel.apply({"params": p, "batch_stats": stats}, image, train=False, method=jmodel.coords_plain)
        return jax_loss(c, b["joint_img"], b["joint_vis"], b["joints_have_depth"])

    fn = jax.jit(jax.value_and_grad(loss_fn), in_shardings=(replicated_sharding(jmesh), batch_sharding(jmesh)))
    loss, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: v.numpy() for k, v in
           from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), grads), stats, cfg).items()}
    ranks = _ranks(spawned, name)
    assert _data_mean(ranks, name, "eval_loss") == pytest.approx(float(loss), rel=1e-5)
    got = ranks[0]["eval_grads"]
    gn = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in got))
    for k, g in got.items():
        assert np.linalg.norm(g.astype(np.float64) - ref[k]) <= 1e-5 * max(gn, 1.0), k


# --- (f) the CLIs with --spatial 2 ------------------------------------------------------------------------------


def _jax_unpartitioned():
    """A (1, 1) mesh: JAX's unpartitioned program on the same code path."""
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "spatial"))


@pytest.mark.parametrize("name", ["1x4", "3"])
def test_uneven_grid_eval_gradients_match_unpartitioned_jax(spawned, name):
    """The uneven grids (1 x 4 at 64x64: two ranks own no stride-32 rows;
    S = 3 at 128x128) in eval mode against JAX's unpartitioned loss and
    gradients, at the bars of the even grids' test against JAX's mesh. Not
    against JAX's own (1, 4) mesh: there GSPMD's head.deconv1 kernel
    gradient is 17.1 from JAX's unpartitioned one in norm (of 49.9), while
    its S = 2 mesh sits 1.1e-4 from it (my CPU run, JAX 0.9.0); the port's
    1 x 4 grid holds its one process's at 1e-5
    (``test_eval_mode_gradients_on_the_grid_match_one_process``)."""
    _check_eval_gradients_against_jax(spawned, name, _jax_unpartitioned())


def test_uneven_1x4_eval_coords_match_jax_mesh(spawned):
    """The 1 x 4 grid's eval coords (flip-test on) against JAX's eval step
    on its own (1, 4) mesh, at JAX's test_spatial_eval_step_matches_
    unpartitioned bar, 1e-4 voxel."""
    _check_eval_coords_against_jax_mesh(spawned, "1x4")


def _check_eval_coords_against_jax_mesh(spawned, name):
    """Rank 0's flip-test eval coords on the grid ``name`` (D = 1) against
    JAX's eval step on its own mesh, within 1e-4 voxel."""
    jcfg, params, stats, _, _, batch = spawned["inputs"]["step"][name]
    jmesh = _jax_mesh(name)
    from ihpr_tpu.parallel import batch_sharding

    ev = jax_make_eval_step(jax_build_pose_net(jcfg), jcfg, jmesh)
    jbatch = {k: jax.device_put(jnp.asarray(v), batch_sharding(jmesh)) for k, v in batch.items()}
    jcoords = np.asarray(ev(params, stats, jbatch)[0])
    got = _ranks(spawned, name)[0]["eval_coords"]
    assert np.abs(jcoords - 7.5).max() > 0.5
    np.testing.assert_allclose(got, jcoords, rtol=0, atol=1e-4)


def test_train_cli_spatial_snapshot_resumes_in_one_process(spawned, tmp_path):
    """``train.main --spatial 2`` on two spawned ranks trains an epoch on the
    global batch of 2 (D = 1); rank 0 alone writes its snapshot, in the
    single-process format: one process resumes it at epoch 1 with exactly
    the ranks' final state and trains on with finite losses."""
    cfg, out = spawned["inputs"]["cli"]
    r0, r1 = spawned[2]["cli"]
    assert r1["state"] == R.digest(r0["state"])
    log = open(os.path.join(out, "log", "train_logs.txt")).read()
    assert "global batch 2 on 2 rank(s) (data 1 x spatial 2)" in log
    shutil.copytree(os.path.join(out, "model_dump"), tmp_path / "model_dump")
    trainer = Trainer(cfg.replace(output_dir=str(tmp_path)), datasets=[R.synthetic(N_TRAIN)], num_workers=0,
                      device="cpu", continue_train=True, rss_limit_mb=0)
    try:
        assert (trainer.start_epoch, trainer.resume_skip) == (1, 0)
        assert R.digest(R.state_np(trainer.state.state_dict())) == R.digest(r0["state"])
        trainer.train(2)
        assert len(trainer.losses) == N_TRAIN // 2 and all(np.isfinite(float(x)) for x in trainer.losses)
    finally:
        trainer.close()


def test_test_cli_spatial_scores_each_sample_once(spawned):
    """``test.main --spatial 2`` on the same run: both ranks return the same
    metrics, rank 0 alone writes, its predictions hold each of the N_TEST
    samples once and equal one process's Tester on the snapshot within
    1e-5 voxel."""
    cfg, out = spawned["inputs"]["cli"]
    r0, r1 = spawned[2]["cli"]
    assert r0["metrics"] == r1["metrics"] and r1["written"] == []
    assert any(p.endswith("preds_Human36M.npy") for p in r0["written"])
    preds = np.load(os.path.join(out, "result", "preds_Human36M.npy"))
    one = ttester.Tester(cfg.replace(output_dir=out),
                         dataset=datasets.build_dataset("Human36M", "test", cfg, "synthetic", N_TEST),
                         num_workers=0, device="cpu")
    try:
        want = ttester.metrics_from_voxel_preds(cfg, one.loader, one.dataset, one.predict_voxels())[1]
    finally:
        one.close()
    assert preds.shape == (N_TEST, 18, 3)
    np.testing.assert_allclose(preds, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_cli_spatial_under_torchrun(spawned):
    """``--multihost --spatial 2`` under torchrun (2 ranks, gloo on the CPU):
    the train CLI trains an epoch on a data axis of 1 and rank 0 writes its
    snapshot; the test CLI, launched the same way, scores it, every rank
    printing the metrics."""
    out = spawned["tmp"] / "torchrun"
    (train_rc, _, train_err), (test_rc, test_out, test_err) = spawned["torchrun"]
    assert train_rc == 0, train_err
    assert test_rc == 0, test_err
    assert "global batch 2 on 2 rank(s) (data 1 x spatial 2)" in (out / "log" / "train_logs.txt").read_text()
    assert os.path.exists(out / "model_dump" / "snapshot_0" / "state.pt")
    assert (out / "result" / "metrics_Human36M.json").exists()
    assert test_out.count("MPJPE") >= 2


# --- (g) the server ------------------------------------------------------------------------------------------------


def test_spatial_server_matches_one_process(spawned):
    """``PoseServer(dp=, partition="spatial")`` on two ranks: each forwards the
    whole dispatch's rows 32 of 64 (64 with flip-test's mirrors), and every
    rank returns one process's coords within 1e-5 voxel, with flip-test on
    and off."""
    cfg, sd, patches = spawned["inputs"]["serve"]
    for flip in (True, False):
        want = PoseServer(cfg, {k: torch.from_numpy(v) for k, v in sd.items()}, max_batch=4, flip_test=flip,
                          device="cpu").predict_patches(patches)
        assert np.abs(want - 7.5).max() > 0.5
        for r in spawned[2]["serve"]:
            assert r[f"forwarded_{flip}"] == [((8 if flip else 4), 32, 64, 3)] * 2
            np.testing.assert_allclose(r[f"patches_{flip}"], want, rtol=0, atol=1e-5)


# --- (h) the grid's checks ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("world, spatial, rows, match", [
    (4, 3, 96, "does not divide the 4 rank"),
    (4, 4, 96, None),
    (2, 2, 80, None),
])
def test_uneven_grid_raises(world, spatial, rows, match):
    """S must divide the world, as JAX's make_mesh requires: the one refusal
    left, made before any group is created. Grids whose rows split unevenly
    are taken, as JAX's GSPMD takes them (JAX's eval step runs on a (1, 4)
    mesh at 96x96 and a (1, 2) mesh at 80x80, 3 rows at stride 32): the
    grid keeps the input's rows, and every stage's rows, the empty blocks
    included, add up to the stage's (``mesh.row_range``)."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            mesh.make_grid(mesh.DataParallel(0, world), spatial, rows)
        return
    grid = mesh.make_grid(mesh.DataParallel(0, world), spatial, rows)
    assert (grid.spatial, grid.input_rows, grid.row_axis.input_rows) == (spatial, rows, rows)
    r = rows
    while r > 1:
        spans = [mesh.row_range(r, i, spatial) for i in range(spatial)]
        assert spans[0][0] == 0 and spans[-1][1] == r
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        r = mesh.conv_rows(r, 3, 2, 1)


def _one_process_artifact(cfg, sd, max_batch):
    from ihpr_tpu_torch.engine.export import export_server

    return export_server(PoseServer(cfg, {k: torch.from_numpy(v) for k, v in sd.items()}, max_batch=max_batch,
                                    flip_test=True, device="cpu"))


def test_spatial_server_refuses_export(spawned):
    """A spatial server's model runs one rank's rows; the export traces a
    one-process copy of that model, whose artifact is bitwise the
    one-process server's. With S equal to the world the server creates no
    group, so a DataParallel of world 2 and no group builds one in this
    process. The name is the test's original one, from when the export
    refused a spatial server: it now holds that the export succeeds and
    is the whole-image program."""
    from ihpr_tpu_torch.engine.export import export_server

    cfg, sd, patches = spawned["inputs"]["serve"]
    srv = PoseServer(cfg, {k: torch.from_numpy(v) for k, v in sd.items()}, max_batch=len(patches), device="cpu",
                     dp=mesh.DataParallel(0, 2), partition="spatial", flip_test=True)
    assert srv.model.rows == mesh.DataParallel(0, 2, None, input_rows=64)
    assert export_server(srv) == _one_process_artifact(cfg, sd, len(patches))


def test_spatial_export_on_two_ranks_is_the_whole_image_program(spawned):
    """Two gloo ranks each export ``PoseServer(partition="spatial")``: both
    artifacts are bitwise the one-process server's on the same weights, and
    their coords agree with JAX's artifact (``ihpr_tpu.engine.export``, the
    whole-image ``coords_plain``) within 2e-3 voxel, test_torch_export.py's
    bar, flip-test on."""
    import hashlib

    from ihpr_tpu.engine.export import export_server as jax_export_server
    from ihpr_tpu.engine.export import load_exported as jax_load_exported
    from ihpr_tpu.engine.server import PoseServer as JaxPoseServer

    cfg, sd, patches = spawned["inputs"]["serve"]
    want = hashlib.sha1(_one_process_artifact(cfg, sd, len(patches))).hexdigest()
    jcfg = _jcfg(64, data_axis_size=1)
    _, params, stats = jax_pose_weights(jcfg, seed=8)
    jax_fn = jax_load_exported(jax_export_server(
        JaxPoseServer(jcfg, params, stats, max_batch=len(patches), flip_test=True), platforms=("cpu",)))
    ref = np.asarray(jax_fn(patches, np.ones((len(patches), 3), np.float32)))
    assert np.abs(ref - 7.5).max() > 0.5
    for r in spawned[2]["export"]:
        assert r["sha1"] == want
        np.testing.assert_allclose(r["coords"], ref, rtol=0, atol=2e-3)
