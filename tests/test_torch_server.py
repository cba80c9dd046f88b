"""ihpr_tpu_torch PoseServer vs the JAX PoseServer on the same weights (CPU).

The tiny serving config of tests/test_server_vis.py (R18, 64x64 input,
16x16 heatmaps, D=16, 18 joints), with the weights of test_torch_models
(BN statistics, deconvs and final conv redrawn so heatmaps are peaked).
Coordinates agree to 2e-3 voxel, the end-to-end bar.
"""

import numpy as np
import pytest
import torch

from ihpr_tpu.engine.server import PoseServer as JaxPoseServer
from ihpr_tpu_torch.engine.server import PoseServer
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg

torch.set_num_threads(1)

MAX_BATCH = 4


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_cfg()
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    return jcfg, params, stats


@pytest.fixture(scope="module", params=[True, False], ids=["flip", "noflip"])
def servers(request, weights):
    from ihpr_tpu_torch.models.convert import from_jax_params

    jcfg, params, stats = weights
    cfg = to_port_cfg(jcfg)
    jax_srv = JaxPoseServer(jcfg, params, stats, max_batch=MAX_BATCH, flip_test=request.param)
    srv = PoseServer(
        cfg, from_jax_params(params, stats, cfg), max_batch=MAX_BATCH, flip_test=request.param,
        device="cpu",
    )
    return jax_srv, srv


def _patches(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)


def test_predict_patches_matches_jax(servers):
    """N=6 is not a multiple of max_batch: the second dispatch is padded by
    repeating the last patch."""
    jax_srv, srv = servers
    patches = _patches(0, 6)
    ref = jax_srv.predict_patches(patches)
    out = srv.predict_patches(patches)
    assert out.shape == (6, 18, 3)
    assert np.abs(ref - 7.5).max() > 1.0  # peaked, not the flat-volume centre
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_submit_patches_short_and_empty(servers):
    jax_srv, srv = servers
    patches = _patches(2, 3)
    dev = srv.submit_patches(patches)
    assert isinstance(dev, torch.Tensor) and dev.shape == (3, 18, 3)
    np.testing.assert_allclose(dev.numpy(), np.asarray(jax_srv.submit_patches(patches)), atol=2e-3)
    np.testing.assert_allclose(dev.numpy(), srv.predict_patches(patches), atol=1e-5)
    assert srv.submit_patches([]).shape == (0, 18, 3)
    assert srv.predict_patches(np.zeros((0, 64, 64, 3), np.uint8)).shape == (0, 18, 3)
    with pytest.raises(ValueError, match="max_batch"):
        srv.submit_patches(_patches(3, MAX_BATCH + 1))
    with pytest.raises(ValueError, match="uint8"):
        srv.submit_patches(np.zeros((2, 32, 32, 3), np.uint8))


def test_predict_full_path_matches_jax(servers):
    """Original images + bboxes through the native warp (both packages bind
    the same native/warp.cc), then warp-back to image pixels and mm."""
    jax_srv, srv = servers
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (200, 180, 3)).astype(np.uint8) for _ in range(3)]
    bboxes = np.array([[40, 40, 100, 120], [10, 30, 150, 90], [60, 20, 80, 160]], np.float32)
    root_z = np.full(3, 4000.0)
    ref = jax_srv.predict(images, bboxes, root_z=root_z)
    out = srv.predict(images, bboxes, root_z=root_z)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.coords_voxel, b.coords_voxel, atol=2e-3)
        # voxel -> pixel scales by input/output = 4 (x, y) and the bbox crop;
        # voxel -> mm scales z by 2000 / 16.
        np.testing.assert_allclose(a.coords_img[:, :2], b.coords_img[:, :2], atol=0.1)
        np.testing.assert_allclose(a.coords_img[:, 2], b.coords_img[:, 2], atol=0.3)


def test_predict_stream_matches_sequential(servers):
    _, srv = servers
    rng = np.random.RandomState(3)
    reqs = []
    for k in range(4):
        n = 1 + k % 3
        images = [rng.randint(0, 256, (160 + 10 * k, 150, 3)).astype(np.uint8) for _ in range(n)]
        bboxes = np.tile(np.array([30, 30, 90, 100], np.float32), (n, 1))
        reqs.append((images, bboxes, np.full(n, 4000.0)))
    seq = [srv.predict(*r) for r in reqs]
    stream = list(srv.predict_stream(reqs, depth=2))
    assert [len(s) for s in stream] == [len(s) for s in seq]
    for a, b in zip(stream, seq):
        for ra, rb in zip(a, b):
            np.testing.assert_allclose(ra.coords_voxel, rb.coords_voxel, atol=1e-6)
            np.testing.assert_allclose(ra.coords_img, rb.coords_img, atol=1e-5)


def test_entry_points_default_to_the_card():
    """PoseServer and build_pose_net run on the card unless the caller asks
    for the CPU, as the Trainer and the Tester do."""
    import inspect

    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    for entry in (PoseServer, build_pose_net, Trainer, Tester):
        assert inspect.signature(entry).parameters["device"].default == "cuda", entry
