"""The port's vis overlays against the JAX package on the CPU:
``ihpr_tpu_torch/utils/vis.py`` against ``ihpr_tpu/utils/vis.py`` (the same
cv2 and matplotlib calls: bitwise), and ``Tester.evaluate(vis=True)``
against JAX's ``Tester.evaluate(vis=True)`` on the same weights and test
set (tests/test_torch_eval.py's ``setup``): the same file names, and each
port file the JPEG (quality 95) of JAX's ``vis_keypoints`` drawn on the
port's own predictions, byte for byte.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.engine import tester as jtester
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.utils import vis as jvis
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import render_synthetic_image
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.utils import vis
from test_torch_eval import setup  # noqa: F401  (module fixture: the tiny weights and test sets)
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)


def _pose(skel, seed, h=120, w=160):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    joints = np.stack([rng.uniform(-10, w + 10, skel.joint_num), rng.uniform(-10, h + 10, skel.joint_num),
                       rng.uniform(-500, 500, skel.joint_num)], 1).astype(np.float32)
    vis_mask = (rng.rand(skel.joint_num) > 0.25).astype(np.float32)
    return img, joints, vis_mask


@pytest.mark.parametrize("name", ["H36M", "MPII", "MSCOCO"])
@pytest.mark.parametrize("alpha, masked", [(1.0, False), (0.6, True)])
def test_vis_keypoints_is_jax_bitwise(name, alpha, masked):
    skel, jskel = getattr(skeletons, name), getattr(jskeletons, name)
    img, joints, mask = _pose(skel, seed=len(name))
    kw = dict(joint_vis=mask if masked else None, alpha=alpha)
    got = vis.vis_keypoints(img, joints, skel, **kw)
    want = jvis.vis_keypoints(img, joints, jskel, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert not np.array_equal(got, img)  # something was drawn
    assert np.array_equal(img, _pose(skel, seed=len(name))[0])  # the input is left as it was


def test_save_debug_grid_is_jax_bitwise(tmp_path):
    rng = np.random.RandomState(3)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    images = rng.randn(5, 64, 48, 3).astype(np.float32)
    joints = rng.uniform(0, 48, (5, 18, 2)).astype(np.float32)
    got = vis.save_debug_grid(images, joints, skeletons.H36M, str(tmp_path / "port.png"), mean, std)
    want = jvis.save_debug_grid(images, joints, jskeletons.H36M, str(tmp_path / "jax.png"), mean, std)
    assert got.shape == (3 * 64, 3 * 48, 3) and np.array_equal(got, want)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_vis_3d_skeleton_is_jax_bitwise(tmp_path):
    _, joints, mask = _pose(skeletons.H36M, seed=4)
    fig = vis.vis_3d_skeleton(joints, skeletons.H36M, mask, save_path=str(tmp_path / "port.png"), title="p")
    jvis.vis_3d_skeleton(joints, jskeletons.H36M, mask, save_path=str(tmp_path / "jax.png"), title="p")
    assert fig is not None
    got, want = cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "jax.png"))
    assert got is not None and np.array_equal(got, want)


def test_missing_cv2_is_named(monkeypatch):
    """No quiet fallback: without cv2 the overlay raises naming it."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img, joints, _ = _pose(skeletons.H36M, seed=1)
    with pytest.raises(ImportError, match="cv2"):
        vis.vis_keypoints(img, joints, skeletons.H36M)


def test_tester_vis_writes_jax_overlays(setup, tmp_path):  # noqa: F811
    """``Tester.evaluate(vis=True, vis_count=3)`` on the synthetic test set:
    JAX's Tester writes the same names, ``vis/pred_{0,1,2}.jpg``, and each
    of the port's files is cv2's quality-95 JPEG of JAX's vis_keypoints on
    the rendered frame and the port's own predictions (rank 0 only writes:
    one process here)."""
    jcfg, cfg, jmodel, params, stats, model, jds, tds = setup
    jstate, _ = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 1, params=params, batch_stats=stats)
    jax_tester = jtester.Tester(jcfg.replace(output_dir=str(tmp_path / "jax")), dataset=jds, state=jstate,
                                num_workers=0)
    jax_tester.evaluate(vis=True, vis_count=3)
    tester = ttester.Tester(cfg.replace(output_dir=str(tmp_path / "port")), dataset=tds, state=model,
                            num_workers=0, device="cpu")
    try:
        tester.evaluate(vis=True, vis_count=3)
        preds = np.load(tmp_path / "port" / "result" / "preds_Human36M.npy")
        samples = [tds.samples[si] for _, si, _ in tester.loader.index]
    finally:
        tester.close()
    names = sorted(os.listdir(tmp_path / "port" / "vis"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "vis")) == [f"pred_{i}.jpg" for i in range(3)]
    for i in range(3):
        frame = render_synthetic_image(samples[i])
        want = jvis.vis_keypoints(frame, preds[i], jskeletons.H36M)
        ok, blob = cv2.imencode(".jpg", want[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok and (tmp_path / "port" / "vis" / f"pred_{i}.jpg").read_bytes() == blob.tobytes(), i
