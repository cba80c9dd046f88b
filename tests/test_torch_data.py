"""The host helpers the port carries (config, skeletons, geometry, patch
affines) and its finalize_patch, against the JAX package's originals."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.data import geometry as jgeometry
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.data import warp as jwarp
from ihpr_tpu.data.augment import finalize_patch as jax_finalize_patch
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.data import geometry, skeletons, warp
from ihpr_tpu_torch.data.augment import finalize_patch

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_named_configs_match_jax(name):
    ref, cfg = jconfig.get_config(name), tconfig.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.joint_num == ref.joint_num


@pytest.mark.parametrize("name", ["Human36M", "MPII", "MSCOCO"])
def test_skeletons_match_jax(name):
    ref, sk = jskeletons.get_skeleton(name), skeletons.get_skeleton(name)
    assert dataclasses.asdict(sk) == dataclasses.asdict(ref)
    np.testing.assert_array_equal(sk.flip_permutation(), ref.flip_permutation())


def test_geometry_and_affines_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        bbox = rng.uniform([-20, -20, 1, 1], [300, 200, 250, 300]).astype(np.float32)
        a = geometry.process_bbox(bbox, 320, 240, 0.75)
        b = jgeometry.process_bbox(bbox, 320, 240, 0.75)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    args = (rng.uniform(50, 150, 8), rng.uniform(50, 150, 8), rng.uniform(40, 90, 8),
            rng.uniform(40, 90, 8), 256, 192, rng.uniform(0.8, 1.2, 8), rng.uniform(-40, 40, 8))
    for inv in (False, True):
        t = warp.gen_trans_np(*args, inv=inv)
        np.testing.assert_array_equal(t, jwarp.gen_trans_np(*args, inv=inv))
        pts = rng.uniform(0, 100, (8, 2)).astype(np.float32)
        np.testing.assert_array_equal(warp.trans_point2d_np(pts, t), jwarp.trans_point2d_np(pts, t))
    vox = rng.uniform(0, 64, (18, 3)).astype(np.float32)
    kw = dict(output_shape=(64, 48), input_shape=(256, 192), depth_dim=64, bbox_3d_z=2000.0, root_z=4500.0)
    np.testing.assert_array_equal(
        geometry.warp_coord_to_original(vox, t[0], **kw),
        jgeometry.warp_coord_to_original(vox, t[0], **kw),
    )


def test_finalize_patch_matches_jax():
    rng = np.random.RandomState(1)
    patch = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    scale = rng.uniform(0.8, 1.2, (2, 3)).astype(np.float32)
    cfg = tconfig.DataConfig()
    out = finalize_patch(torch.from_numpy(patch), torch.from_numpy(scale), cfg).numpy()
    ref = np.asarray(jax_finalize_patch(jnp.asarray(patch), jnp.asarray(scale), jconfig.DataConfig()))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
