"""The port's evaluation slice against the JAX package, on the CPU: the eval
loader, the flip-test eval step, the datasets' metrics and their geometry,
and the Tester, on the same numpy inputs and weights (``from_jax_params``).

The model is the tiny config of test_torch_models (ResNet-18, 64x64 input,
16x16x16 heatmaps, 18 joints) with its BN statistics, deconvs and final
conv redrawn so heatmaps are peaked. JAX's K1 runs in interpret mode
(IHPR_PALLAS=interpret, from conftest).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.data import coco as jcoco
from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import geometry as jgeometry
from ihpr_tpu.data import pipeline as jpipeline
from ihpr_tpu.engine import tester as jtester
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.parallel import make_eval_step as jax_make_eval_step
from ihpr_tpu_torch.data import coco, datasets, geometry, pipeline, skeletons
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.parallel.train_step import make_eval_step
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

EVAL_BATCH = 4
N_TEST = 10  # not a multiple of EVAL_BATCH: the last batch is padded


def _cfgs(**model_kw):
    jcfg = jax_tiny_cfg(**model_kw)
    jcfg = jcfg.replace(
        eval=dataclasses.replace(jcfg.eval, batch_size_per_device=EVAL_BATCH),
        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1),
    )
    return jcfg, to_port_cfg(jcfg)


@pytest.fixture(scope="module")
def setup():
    """fp32 "highest" weights on both sides, and each side's synthetic
    Human36M test split (the same samples from the same seed)."""
    jcfg, cfg = _cfgs(matmul_precision="highest")
    jmodel, params, stats = jax_pose_weights(jcfg, seed=6)
    model = build_pose_net(cfg, device="cpu", state_dict=from_jax_params(params, stats, cfg))
    jds = jdatasets.build_dataset("Human36M", "test", jcfg, "synthetic", N_TEST)
    tds = datasets.build_dataset("Human36M", "test", cfg, "synthetic", N_TEST)
    return jcfg, cfg, jmodel, params, stats, model, jds, tds


def test_eval_loader_matches_jax(setup):
    """Natural order, no augmentation, the last batch padded by repeating its
    last sample: order, padding and sample_idx equal JAX's, patches bitwise
    (both bind native/warp.cc), voxel joints to 1e-5."""
    jcfg, cfg, *_, jds, tds = setup
    ref = jpipeline.BatchLoader([jds], jcfg, EVAL_BATCH, train=False, num_workers=0, host_warp=True)
    loader = pipeline.BatchLoader([tds], cfg, EVAL_BATCH, train=False, num_workers=0)
    assert len(loader) == len(ref) == 3
    got, want = list(loader.epoch(0)), list(ref.epoch(0))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for f in ("patch", "color_scale", "joint_vis", "joints_have_depth", "sample_idx"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        np.testing.assert_allclose(a.joint_img, b.joint_img, rtol=0, atol=1e-5)
    idx = np.concatenate([b.sample_idx for b in got])
    np.testing.assert_array_equal(idx, [*range(N_TEST), N_TEST - 1, N_TEST - 1])
    assert (got[0].color_scale == 1.0).all()
    np.testing.assert_array_equal(got[-1].patch[-1], got[-1].patch[1])  # the repeat
    # a second epoch is the same (no shuffle), and training still drops the tail
    np.testing.assert_array_equal(next(loader.epoch(1)).patch, got[0].patch)
    assert len(pipeline.BatchLoader([tds], cfg, EVAL_BATCH, num_workers=0)) == 2


def _host_batch(setup):
    jcfg, cfg, *_, tds = setup
    loader = pipeline.BatchLoader([tds], cfg, EVAL_BATCH, train=False, num_workers=0)
    return next(loader.epoch(0))


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
def test_eval_step_matches_jax(setup, flip):
    """Flip-test coords (one 2B forward through model.coords, x remapped to
    out_w - 1 - x, joints permuted, averaged) within 2e-3 voxel of JAX's
    make_eval_step, fp32 "highest", the end-to-end bar."""
    jcfg, cfg, jmodel, params, stats, model, *_ = setup
    jcfg = jcfg.replace(eval=dataclasses.replace(jcfg.eval, flip_test=flip))
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, flip_test=flip))
    hb = _host_batch(setup)
    arrays = {f.name: getattr(hb, f.name) for f in dataclasses.fields(hb) if f.name != "sample_idx"}
    ref, _, _ = jax_make_eval_step(jmodel, jcfg)(params, stats, {k: jnp.asarray(v) for k, v in arrays.items()})
    ref = np.asarray(ref)
    assert np.abs(ref - 7.5).max() > 1.0  # away from the volume centre
    fhi.launches = 0
    coords, joint_img, joint_vis = make_eval_step(inference_copy(model), cfg)(
        {k: torch.from_numpy(v) for k, v in arrays.items()}
    )
    assert fhi.launches == 0 and coords.shape == (EVAL_BATCH, 18, 3)
    np.testing.assert_allclose(coords.numpy(), ref, atol=2e-3)
    np.testing.assert_array_equal(joint_img.numpy(), hb.joint_img)
    np.testing.assert_array_equal(joint_vis.numpy(), hb.joint_vis)


# --- metrics and their geometry, on the same numpy predictions ------------------


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    cam = rng.uniform([-500, -500, 3000], [500, 500, 5000], (18, 3))
    f, c = np.array([1100.0, 1090.0]), np.array([200.0, 210.0])
    np.testing.assert_array_equal(geometry.cam2pixel(cam, f, c), jgeometry.cam2pixel(cam, f, c))
    px = geometry.cam2pixel(cam, f, c)
    np.testing.assert_array_equal(geometry.pixel2cam(px, f, c), jgeometry.pixel2cam(px, f, c))
    R, t = np.linalg.qr(rng.randn(3, 3))[0], rng.randn(3)
    np.testing.assert_array_equal(geometry.world2cam(cam, R, t), jgeometry.world2cam(cam, R, t))
    other = cam @ R.T * 1.1 + t
    for a, b in zip(geometry.rigid_transform_3d(cam, other), jgeometry.rigid_transform_3d(cam, other)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(geometry.rigid_align(cam, other), jgeometry.rigid_align(cam, other))
    np.testing.assert_allclose(geometry.rigid_align(cam, other), other, atol=1e-6)


@pytest.mark.parametrize("protocol", [1, 2])
def test_evaluate_h36m_matches_jax(protocol):
    jcfg, cfg = _cfgs()
    jds = jdatasets.build_dataset("Human36M", "test", jcfg, "synthetic", 20)
    tds = datasets.build_dataset("Human36M", "test", cfg, "synthetic", 20)
    rng = np.random.RandomState(protocol)
    preds = np.stack([jdatasets._sample_joint_cam(s) for s in jds.samples]) + rng.randn(20, 18, 3) * 30
    np.testing.assert_array_equal(
        np.stack([datasets._sample_joint_cam(s) for s in tds.samples]),
        np.stack([jdatasets._sample_joint_cam(s) for s in jds.samples]),
    )
    got = datasets.evaluate_h36m(preds, tds.samples, protocol)
    _assert_same_metrics(got, jdatasets.evaluate_h36m(preds, jds.samples, protocol))
    assert 10.0 < got["MPJPE total"] < 100.0 and len(got) > 2  # per-action rows too


@pytest.mark.parametrize("head_box", [False, True], ids=["neck", "head_box"])
def test_evaluate_mpii_pckh_matches_jax(head_box):
    jcfg, cfg = _cfgs()
    tds = datasets.build_dataset("MPII", "test", cfg, "synthetic", 16)
    samples = [dict(s) for s in tds.samples]
    rng = np.random.RandomState(3)
    for s in samples:
        s["joint_vis"] = (rng.rand(16) > 0.2).astype(np.float32)
        if head_box:
            x, y = s["joint_img"][9, :2]
            s["head_box"] = np.array([x - 15, y - 20, x + 15, y + 20], np.float32)
    preds = np.stack([s["joint_img"] for s in samples]) + rng.randn(16, 16, 3) * 8
    got = datasets.evaluate_mpii_pckh(preds, samples)
    _assert_same_metrics(got, jdatasets.evaluate_mpii_pckh(preds, samples))
    assert 0.0 < got["PCKh@0.5"] < 1.0
    assert datasets.MPII_SC_BIAS == jdatasets.MPII_SC_BIAS


def test_evaluate_mscoco_and_keypoint_ap_match_jax():
    jcfg, cfg = _cfgs()
    tds = datasets.build_dataset("MSCOCO", "test", cfg, "synthetic", 12)
    samples = [dict(s, image_id=i // 2) for i, s in enumerate(tds.samples)]  # 2 people per image
    rng = np.random.RandomState(4)
    preds = np.stack([s["joint_img"] for s in samples]) + rng.randn(12, 17, 3) * 6
    got = datasets.evaluate_mscoco(preds, samples)
    _assert_same_metrics(got, jdatasets.evaluate_mscoco(preds, samples))
    assert 0.0 < got["AP"] < 1.0
    gts = [dict(image_id=0, keypoints=np.c_[s["joint_img"][:, :2], np.ones(17)], area=s["area"]) for s in samples[:3]]
    dts = [dict(image_id=0, keypoints=np.c_[p[:, :2], np.ones(17)], score=sc) for p, sc in zip(preds[:3], (0.9, 0.5, 0.7))]
    _assert_same_metrics(coco.keypoint_ap(gts, dts), jcoco.keypoint_ap(gts, dts))
    assert coco.compute_oks(gts[0]["keypoints"], preds[0], 5000.0) == jcoco.compute_oks(
        gts[0]["keypoints"], preds[0], 5000.0
    )


# --- the Tester -----------------------------------------------------------------


def test_tester_matches_jax(setup, tmp_path):
    """Tester.evaluate against the JAX Tester(state=...) on the same weights
    and test set: voxel predictions within 2e-3 voxel; MPJPE within 0.5 mm
    (2e-3 voxel is at most 0.25 mm here, 2000 mm over 16 depth bins, and
    root alignment can double it); the artifact files written."""
    jcfg, cfg, jmodel, params, stats, model, jds, tds = setup
    jstate, _ = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 1, params=params, batch_stats=stats)
    jax_tester = jtester.Tester(jcfg.replace(output_dir=str(tmp_path / "jax")), dataset=jds, state=jstate,
                                num_workers=0)
    ref_vox = jax_tester.predict_voxels()
    ref = jax_tester.evaluate()

    tester = ttester.Tester(cfg.replace(output_dir=str(tmp_path / "port")), dataset=tds, state=model,
                    num_workers=0, device="cpu")
    try:
        assert len(tester.loader) == 3
        vox = tester.predict_voxels()
        assert tester.loader_wait_s > 0.0
        metrics = tester.evaluate()
    finally:
        tester.close()
    assert vox.shape == (N_TEST, 18, 3) and np.abs(ref_vox - 7.5).max() > 1.0
    np.testing.assert_allclose(vox, ref_vox, atol=2e-3)
    assert metrics.keys() == ref.keys()
    for k in ref:
        assert metrics[k] == pytest.approx(ref[k], abs=0.5), k
    result = tmp_path / "port" / "result"
    with open(result / "metrics_Human36M.json") as f:
        assert json.load(f) == metrics
    assert np.load(result / "preds_Human36M.npy").shape == (N_TEST, 18, 3)
    with open(result / "bbox_root_pose_h36m_output.json") as f:
        dump = json.load(f)
    assert len(dump) == N_TEST and np.asarray(dump[0]["joint_cam"]).shape == (18, 3)
    assert sorted(os.listdir(result)) == sorted(os.listdir(tmp_path / "jax" / "result"))


def test_tester_writes_mpii_and_coco_artifacts(tmp_path):
    """The 2D test sets (D=1) through the Tester: PCKh and OKS AP, pred.mat
    (MATLAB 1-based px, through scipy) and the COCOeval detections json."""
    from scipy.io import loadmat

    for name, artifact in (("MPII", "pred.mat"), ("MSCOCO", "person_keypoints_result.json")):
        jcfg = jconfig.get_config("h36m3d_r50").replace(
            model=jconfig.ModelConfig(resnet_type=18),
            data=jconfig.DataConfig(trainset=(name,), testset=name, input_shape=(64, 64),
                                    output_shape=(16, 16), depth_dim=1),
            eval=jconfig.EvalConfig(batch_size_per_device=EVAL_BATCH),
            output_dir=str(tmp_path / name),
        )
        cfg = to_port_cfg(jcfg)
        model = build_pose_net(cfg, skeletons.get_skeleton(name).joint_num, device="cpu")
        dataset = datasets.build_dataset(name, "test", cfg, "synthetic", 6)
        tester = ttester.Tester(cfg, dataset=dataset, state=model, num_workers=0, device="cpu")
        try:
            metrics = tester.evaluate()
        finally:
            tester.close()
        key = "PCKh@0.5" if name == "MPII" else "AP"
        assert np.isfinite(metrics[key])
        assert (tmp_path / name / "result" / artifact).exists()
        if name == "MPII":
            preds = loadmat(tmp_path / name / "result" / artifact)["preds"]
            np.testing.assert_allclose(
                preds, np.load(tmp_path / name / "result" / "preds_MPII.npy")[:, :, :2] + 1.0, rtol=1e-6
            )


def test_tester_needs_a_state(tmp_path):
    """Without a state the Tester loads a snapshot from cfg.output_dir; with
    none there it raises FileNotFoundError, as JAX's Tester does."""
    _, cfg = _cfgs()
    dataset = datasets.build_dataset("Human36M", "test", cfg, "synthetic", 2)
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        ttester.Tester(cfg.replace(output_dir=str(tmp_path)), dataset=dataset, state=None, device="cpu")
