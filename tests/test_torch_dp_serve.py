"""Data-parallel serving in the port on the CPU: ``PoseServer(dp=...,
partition="data")`` on two gloo ranks against one process's server and
against JAX's ``PoseServer(mesh=..., partition="data")`` on two of its
virtual devices (tests/conftest.py gives JAX 8). Beside it, the canvas
path's augmentation on two ranks against one process.

All rank cases run in one ``launch.spawn`` (``torch_dp_ranks.serve_ranks``).
The model is the tiny config of test_torch_models (ResNet-18, 64x64 input,
16x16x16 heatmaps, 18 joints, fp32 "highest") with peaked heatmaps. Each
rank runs its 4 rows of a dispatch of 8 (the per-sample forward of eval-mode
BN does not depend on the batch), so the gathered coords equal one process's
to 1e-6 (oneDNN may pick other blockings for 4 and 8 rows), and JAX's to
2e-3 voxel, the end-to-end bar.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ihpr_tpu.engine.server import PoseServer as JaxPoseServer
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.server import PoseServer
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.parallel import launch
from ihpr_tpu_torch.parallel.mesh import SINGLE, DataParallel
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.parallel.train_step import create_train_state, patch_batch
from test_torch_device_warp import _canvas_batch
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg

import torch_dp_ranks as R

torch.set_num_threads(1)

WORLD = 2


def _requests():
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 256, (160 + 10 * k, 150, 3)).astype(np.uint8) for k in range(5)]
    boxes = np.array([[30, 30, 90, 100], [20, 40, 100, 110], [10, 10, 120, 140], [40, 20, 80, 90],
                      [5, 50, 130, 100]], np.float32)
    request = (images, boxes, np.full(5, 4000.0))
    stream = [(images[: 1 + k], boxes[: 1 + k], np.full(1 + k, 4500.0)) for k in range(3)]
    return request, stream


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_serve")
    jcfg = jax_tiny_cfg(matmul_precision="highest")
    _, params, stats = jax_pose_weights(jcfg, seed=8)
    cfg = to_port_cfg(jcfg)
    sd = from_jax_params(params, stats, cfg)
    model = build_pose_net(cfg, device="cpu", trainable=True)
    model.load_state_dict(sd)
    ckpt = CheckpointManager(str(tmp / "run"))
    ckpt.save(0, create_train_state(model, cfg, 1))
    ckpt.wait()
    patches = np.random.RandomState(6).randint(0, 256, (11, 64, 64, 3)).astype(np.uint8)
    request, stream = _requests()
    canvas = _canvas_batch(seed=9)
    jobs = [("serve", "serve_ranks", (cfg, {k: v.numpy() for k, v in sd.items()}, patches, request, stream,
                                      str(tmp / "run"))),
            ("canvas", "canvas_ranks", (cfg, canvas, (2, 13)))]
    results = launch.spawn(R.run_jobs, WORLD, "gloo", jobs, workdir=str(tmp))
    one = {flip: PoseServer(cfg, sd, max_batch=8, flip_test=flip, device="cpu") for flip in (True, False)}
    return dict(jcfg=jcfg, cfg=cfg, params=params, stats=stats, sd=sd, patches=patches, request=request,
                stream=stream, ranks=[r["serve"] for r in results], one=one,
                canvas=canvas, canvas_ranks=[r["canvas"] for r in results])


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
def test_predict_patches_equals_one_process_and_jax(served, flip):
    """11 patches at max_batch 8: two dispatches, the second padded; every
    rank returns all 11 rows, in order."""
    want = served["one"][flip].predict_patches(served["patches"])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jsrv = JaxPoseServer(served["jcfg"], served["params"], served["stats"], max_batch=8, flip_test=flip,
                         mesh=mesh, partition="data")
    ref = jsrv.predict_patches(served["patches"])
    assert np.abs(want - 7.5).max() > 1.0  # away from the volume centre
    for r in served["ranks"]:
        got = r[f"patches_{flip}"]
        assert got.shape == (11, 18, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


def test_each_rank_forwards_its_rows(served):
    """A rank's model sees 4 of a dispatch's 8 rows (8 with the flip-test's
    mirrors), once per dispatch."""
    for r in served["ranks"]:
        assert r["forwarded_True"] == [(8, 64, 64, 3)] * 2
        assert r["forwarded_False"] == [(4, 64, 64, 3)] * 2


def test_predict_and_predict_stream_equal_one_process(served):
    one = served["one"][False]
    want = [p.coords_img for p in one.predict(*served["request"])]
    want_stream = [[p.coords_img for p in res] for res in one.predict_stream(served["stream"])]
    for r in served["ranks"]:
        np.testing.assert_allclose(np.stack(r["predict"]), np.stack(want), rtol=0, atol=1e-4)
        assert [len(s) for s in r["stream"]] == [1, 2, 3]
        for got, exp in zip(r["stream"], want_stream):
            np.testing.assert_allclose(np.stack(got), np.stack(exp), rtol=0, atol=1e-4)


def test_load_server_passes_dp_through(served):
    want = served["one"][False].predict_patches(served["patches"])
    for r in served["ranks"]:
        np.testing.assert_allclose(r["loaded"], want, rtol=0, atol=1e-6)


def test_refusals_at_world_2(served):
    """max_batch 7 does not divide over 2 ranks (JAX asserts it); the spatial
    partition, JAX's default, is not ported."""
    for r in served["ranks"]:
        assert "7 over 2" in r["odd"]
        assert "partition='data'" in r["spatial"]
    with pytest.raises(ValueError, match="partition"):
        PoseServer(served["cfg"], served["sd"], device="cpu", partition="rows")


def test_world_1_is_the_one_process_server(served):
    """dp of world 1 (and SINGLE) serves as dp=None does, bitwise, whatever
    the partition."""
    want = served["one"][True].predict_patches(served["patches"])
    for dp, partition in ((SINGLE, "spatial"), (DataParallel(0, 1), "data")):
        srv = PoseServer(served["cfg"], served["sd"], max_batch=8, flip_test=True, device="cpu", dp=dp,
                         partition=partition)
        assert srv.dp is None
        np.testing.assert_array_equal(srv.predict_patches(served["patches"]), want)


def test_canvas_augmentation_on_2_ranks_equals_one_process(served):
    """A canvas batch's augmentation is drawn for the global batch and each
    rank takes its rows, so the ranks' patches concatenate to one process's,
    bitwise (a training Trainer's rank on canvas batches)."""
    cfg = served["cfg"]
    one = patch_batch({k: torch.from_numpy(v) for k, v in served["canvas"].items()}, cfg,
                      skeletons.H36M.flip_permutation(), train=True, aug_key=(2, 13))
    assert cfg.data.use_aug
    for name in ("image", "joint_img", "joint_vis"):
        got = np.concatenate([r[name] for r in served["canvas_ranks"]])
        np.testing.assert_array_equal(got, getattr(one, name).numpy(), err_msg=name)
