"""The port's device warp path against the JAX package on the CPU: the patch
affines and the bilinear warp (``data/warp.py``), ``make_patch_batch``
(``data/augment.py``), the canvas loader (``extract_canvas``,
``BatchLoader(host_warp=False)``), the train and eval steps and the Tester on
canvas batches, and the server's warp when the native library is missing.

The same numpy inputs go through both packages; where JAX draws the
augmentation (``sample_aug_params(key)``) its draws are fed into the port
through ``patch_batch_from_params``. Models are the tiny config of
test_torch_models (ResNet-18, 64x64 input, 16x16x16 heatmaps, 18 joints,
fp32 "highest") with peaked heatmaps. Bars: affines 1e-5; the warp 1e-2
intensity against JAX, p99 1.5 against cv2 (PARITY.md); canvases one
intensity step; patch images 1e-4 normalized and joints 1e-4 voxel; the
host-warp and device-warp paths at JAX's own bar (PARITY.md "host-warp vs
device-warp paths": joints 1e-2 voxel, pixels p99 < 0.05 normalized); the
train step at PERF.md §2's R18 bounds (loss 1e-5, gradients 2e-4 of each
tensor's largest); coords 2e-3 voxel.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.data import augment as jaugment
from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import native as jnative
from ihpr_tpu.data import pipeline as jpipeline
from ihpr_tpu.data import warp as jwarp
from ihpr_tpu.engine import tester as jtester
from ihpr_tpu.engine.server import PoseServer as JaxPoseServer
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu.parallel import make_eval_step as jax_make_eval_step
from ihpr_tpu.parallel import make_train_step as jax_make_train_step
from ihpr_tpu_torch.data import augment, datasets, native, pipeline, skeletons, warp
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.server import PoseServer
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.parallel import train_step
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from test_torch_train import _rel_err, build_jax_model

torch.set_num_threads(1)

PERM = skeletons.H36M.flip_permutation()


def _t(a):
    return torch.from_numpy(np.array(a))


def _affine_args(rng, n):
    return (rng.uniform(20, 140, n), rng.uniform(20, 140, n), rng.uniform(30, 120, n),
            rng.uniform(30, 120, n), 64, 48, rng.uniform(0.7, 1.3, n), rng.uniform(-60, 60, n))


def test_gen_trans_and_trans_point2d_match_jax():
    rng = np.random.RandomState(0)
    args = _affine_args(rng, 16)
    for inv in (False, True):
        got = warp.gen_trans(*[_t(a.astype(np.float32)) if isinstance(a, np.ndarray) else a for a in args],
                             inv=inv)
        want = np.asarray(jwarp.gen_trans(*args, inv=inv))
        assert got.dtype == torch.float32 and got.shape == (16, 2, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        pts = rng.uniform(-50, 200, (16, 18, 2)).astype(np.float32)
        np.testing.assert_allclose(
            warp.trans_point2d(_t(pts), got[:, None]).numpy(),
            np.asarray(jwarp.trans_point2d(jnp.asarray(pts), jnp.asarray(want)[:, None])),
            rtol=1e-5, atol=1e-5,
        )
    # numbers broadcast as JAX's do
    np.testing.assert_allclose(warp.gen_trans(90.0, 100.0, 140.0, 140.0, 256, 256, 1.1, 20.0).numpy(),
                               np.asarray(jwarp.gen_trans(90.0, 100.0, 140.0, 140.0, 256, 256, 1.1, 20.0)),
                               rtol=1e-5, atol=1e-5)


def test_flips_match_jax():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 60, (3, 18, 3)).astype(np.float32)
    vis = (rng.rand(3, 18) > 0.3).astype(np.float32)
    got = warp.flip_joints(_t(xy), _t(vis), PERM, 64.0)
    want = jwarp.flip_joints(jnp.asarray(xy), jnp.asarray(vis), PERM, 64.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    img = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(warp.flip_image(_t(img)).numpy(), np.asarray(jwarp.flip_image(jnp.asarray(img))))


def _warp_cases():
    """(canvases, inverse affines): rotation and scale, a box past the top
    left, one past the bottom right (both clamp borders), one wholly
    outside, and a patch whose taps sit exactly on pixel centres."""
    rng = np.random.RandomState(1)
    canvas = rng.randint(0, 256, (6, 40, 50, 3)).astype(np.uint8)
    c_x = np.array([25.0, 2.0, 48.0, 200.0, 25.0, 24.5], np.float32)
    c_y = np.array([20.0, 1.0, 39.0, -90.0, 20.0, 19.5], np.float32)
    size = np.array([30.0, 20.0, 24.0, 20.0, 48.0, 32.0], np.float32)
    scale = np.array([1.2, 1.0, 0.9, 1.0, 1.0, 1.0], np.float32)
    rot = np.array([35.0, -20.0, 10.0, 0.0, 0.0, 0.0], np.float32)
    inv = jwarp.gen_trans_np(c_x, c_y, size, size, 32, 32, scale, rot, inv=True)
    return canvas, inv


def test_affine_warp_bilinear_matches_jax():
    canvas, inv = _warp_cases()
    got = warp.affine_warp_bilinear(_t(canvas), _t(inv), (32, 32))
    want = np.asarray(jwarp.affine_warp_bilinear(jnp.asarray(canvas), jnp.asarray(inv), (32, 32)))
    assert got.dtype == torch.float32 and got.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    assert (got[3] == 0).all() and (got[1, :3, :3] == 0).all()  # outside the canvas: zero
    assert (got[1] > 0).any() and (got[2] > 0).any()


def test_affine_warp_bilinear_matches_cv2():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (200, 180, 3)).astype(np.uint8)
    for scale, rot in ((1.0, 0.0), (1.2, 30.0), (0.8, -45.0)):
        fwd = warp.gen_trans_np(90.0, 100.0, 100.0, 100.0, 64, 64, scale, rot)
        inv = warp.gen_trans_np(90.0, 100.0, 100.0, 100.0, 64, 64, scale, rot, inv=True)
        ref = cv2.warpAffine(img, fwd, (64, 64), flags=cv2.INTER_LINEAR).astype(np.float32)
        ours = warp.affine_warp_bilinear(_t(img[None]), _t(inv[None]), (64, 64))[0].numpy()
        diff = np.abs(ours[2:-2, 2:-2] - ref[2:-2, 2:-2])  # cv2's edge handling differs by half a pixel
        assert np.percentile(diff, 99) <= 1.5, (scale, rot, diff.max())


@pytest.mark.parametrize("span", [1.05, 2.0, 3.0], ids=["scale1", "scale_gt1", "scale_gt1_off_frame"])
def test_extract_canvas_matches_jax(span):
    """At span 1.05 the window fits the canvas (a slice and a pad); at 2.0
    and 3.0 it is resampled (JAX: cv2.resize), the last past the frame."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)
    bbox = np.array([120.0, 60.0, 70.0, 90.0] if span < 3 else [-30.0, 150.0, 80.0, 120.0], np.float32)
    canvas, origin, scale = pipeline.extract_canvas(img, bbox, 96, span)
    ref, ref_origin, ref_scale = jpipeline.extract_canvas(img, bbox, 96, span)
    assert (scale > 1.0) == (span > 1.05)
    assert canvas.dtype == np.uint8 and canvas.shape == ref.shape == (96, 96, 3)
    assert np.abs(canvas.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(origin, ref_origin)
    assert scale == ref_scale and origin.dtype == ref_origin.dtype == np.float32


def _canvas_batch(seed=3, b=4, hc=96):
    """Random canvases with labels: the second and third at canvas scale 1.5,
    a joint of the first outside the patch, the last with no depth."""
    rng = np.random.RandomState(seed)
    bbox = np.stack([rng.uniform(10, 40, b), rng.uniform(10, 40, b),
                     rng.uniform(30, 60, b), rng.uniform(30, 60, b)], 1).astype(np.float32)
    joints = np.concatenate([
        bbox[:, None, :2] + rng.uniform(0, 1, (b, 18, 2)) * bbox[:, None, 2:],
        rng.uniform(-900, 900, (b, 18, 1)),
    ], -1).astype(np.float32)
    joints[0, 3, 0] = -40.0
    return {
        "canvas": rng.randint(0, 256, (b, hc, hc, 3)).astype(np.uint8),
        "canvas_origin": rng.uniform(-5, 5, (b, 2)).astype(np.float32),
        "canvas_scale": np.array([1.0, 1.5, 1.5, 1.0][:b], np.float32),
        "bbox": bbox,
        "joints": joints,
        "joint_vis": (rng.rand(b, 18) > 0.2).astype(np.float32),
        "joints_have_depth": np.array([1.0, 1.0, 1.0, 0.0][:b], np.float32),
    }


def _data_cfg(**kw):
    return jconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(64, 64),
                              output_shape=(16, 16), depth_dim=16, **kw)


@pytest.mark.parametrize("draws", ["no_aug", "flip_off", "flip_on"])
def test_make_patch_batch_matches_jax(draws):
    """train=False, and JAX's own sample_aug_params draws (rotation on every
    sample; flips off, then on) fed into the port."""
    jdata = _data_cfg(rot_prob=1.0, flip_prob={"flip_on": 1.0}.get(draws, 0.0))
    data = to_port_cfg(jax_tiny_cfg().replace(data=jdata)).data
    batch = _canvas_batch()
    args = [jnp.asarray(batch[k]) for k in ("canvas", "canvas_origin", "canvas_scale", "bbox", "joints",
                                            "joint_vis", "joints_have_depth")]
    key = jax.random.key(11)
    train = draws != "no_aug"
    want = jaugment.make_patch_batch(*args, PERM, jdata, rng=key, train=train)
    targs = [_t(np.asarray(a)) for a in args]
    if train:
        drawn = [_t(np.asarray(p)) for p in jaugment.sample_aug_params(key, 4, jdata)]
        assert bool(drawn[2].all()) == (draws == "flip_on") and (drawn[1] != 0).all()
        got = augment.patch_batch_from_params(*targs, PERM, data, *drawn)
    else:
        got = augment.make_patch_batch(*targs, PERM, data, train=False)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.joint_img.numpy(), np.asarray(want.joint_img), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.joint_vis.numpy(), np.asarray(want.joint_vis))
    np.testing.assert_array_equal(got.joints_have_depth.numpy(), np.asarray(want.joints_have_depth))
    assert got.joint_vis[0, 3] == 0  # the joint outside the patch
    with pytest.raises(ValueError, match="generator"):
        augment.make_patch_batch(*targs, PERM, data, train=True)


def test_eval_patch_transforms_matches_jax():
    bbox = np.array([[20.0, 30.0, 80.0, 100.0], [-10.0, 5.0, 60.0, 60.0]], np.float32)
    for got, want in zip(augment.eval_patch_transforms(bbox, (64, 48)),
                         jaugment.eval_patch_transforms(bbox, (64, 48))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_aug_generator_same_key_same_draws():
    data = to_port_cfg(jax_tiny_cfg()).data
    a = augment.sample_aug_params(train_step.aug_generator(3, 1, 7), 8, data)
    b = augment.sample_aug_params(train_step.aug_generator(3, 1, 7), 8, data)
    c = augment.sample_aug_params(train_step.aug_generator(3, 1, 8), 8, data)
    d = augment.sample_aug_params(train_step.aug_generator(3, 2, 7), 8, data)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    scale, rot, flip, color = a
    assert scale.shape == rot.shape == flip.shape == (8,) and color.shape == (8, 3)
    assert ((scale >= 0.75) & (scale <= 1.25)).all() and (rot.abs() <= 60).all() and flip.dtype == torch.bool
    assert ((color >= 0.8) & (color <= 1.2)).all()


# --- the canvas loader ----------------------------------------------------------


def _loader_cfgs(use_aug=True, batch=4):
    jcfg = jax_tiny_cfg().replace(data=_data_cfg(use_aug=use_aug),
                                  optim=jconfig.OptimConfig(batch_size_per_device=batch))
    return jcfg, to_port_cfg(jcfg)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_full_matches_jax(train):
    """BatchLoader(host_warp=False, canvas_px=96) against JAX's: every field
    of every HostBatch (canvases resampled where a train box spans more than
    96 / span px), and the rank-2 slices concatenate to the one process's."""
    jcfg, cfg = _loader_cfgs()
    jds = jdatasets.build_dataset("Human36M", "train" if train else "test", jcfg, "synthetic", 10)
    tds = datasets.build_dataset("Human36M", "train" if train else "test", cfg, "synthetic", 10)
    kw = dict(train=train, canvas_px=96, num_workers=0, seed=3, host_warp=False)
    ref = jpipeline.BatchLoader([jds], jcfg, 4, **kw)
    loader = pipeline.BatchLoader([tds], cfg, 4, **kw)
    halves = [pipeline.BatchLoader([tds], cfg, 4, rank=r, world=2, **kw) for r in (0, 1)]
    assert len(loader) == len(ref) == (2 if train else 3) and loader.span == ref.span
    got, want = list(loader.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) and all(isinstance(b, pipeline.HostBatch) for b in got)
    assert any((b.canvas_scale > 1).any() for b in got)
    for a, b, h0, h1 in zip(got, want, halves[0].epoch(1), halves[1].epoch(1)):
        assert np.abs(a.canvas.astype(int) - b.canvas.astype(int)).max() <= 1
        for f in ("canvas_origin", "canvas_scale", "bbox", "joints", "joint_vis", "joints_have_depth",
                  "sample_idx"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(
                np.concatenate([getattr(h0, f.name), getattr(h1, f.name)]), getattr(a, f.name), err_msg=f.name)
    # drop_last: JAX's keyword, defaulting to train
    assert len(pipeline.BatchLoader([tds], cfg, 4, drop_last=not train, **kw)) == (3 if train else 2)


def test_host_and_device_paths_agree():
    """The port's host-warp batch and its canvas batch through
    make_patch_batch(train=False), at JAX's bar for its own two paths."""
    _, cfg = _loader_cfgs(use_aug=False)
    tds = datasets.PoseDataset("Human36M", skeletons.H36M,
                               datasets.make_synthetic(skeletons.H36M, 8, seed=3, img_size=200), True)
    hb = next(pipeline.BatchLoader([tds], cfg, 4, num_workers=0, host_warp=True).epoch(0))
    db = next(pipeline.BatchLoader([tds], cfg, 4, num_workers=0, host_warp=False).epoch(0))
    np.testing.assert_array_equal(hb.sample_idx, db.sample_idx)
    pb = augment.make_patch_batch(
        *[_t(getattr(db, k)) for k in ("canvas", "canvas_origin", "canvas_scale", "bbox", "joints",
                                       "joint_vis", "joints_have_depth")],
        skeletons.H36M.flip_permutation(), cfg.data, train=False,
    )
    np.testing.assert_allclose(pb.joint_img.numpy(), hb.joint_img, rtol=0, atol=1e-2)
    np.testing.assert_array_equal(pb.joint_vis.numpy(), hb.joint_vis)
    host = augment.finalize_patch(_t(hb.patch), _t(hb.color_scale), cfg.data).numpy()
    assert np.percentile(np.abs(host - pb.image.numpy()), 99) < 0.05


def test_native_available_and_the_loader_default(monkeypatch, caplog):
    """available() is True where the library builds (here); the loader's
    default follows it, and with it missing takes the canvas path and logs
    why. warp_batch then raises instead of warping some other way."""
    _, cfg = _loader_cfgs()
    tds = datasets.build_dataset("Human36M", "train", cfg, "synthetic", 4)
    assert native.available() and native.unavailable_reason() is None
    assert pipeline.BatchLoader([tds], cfg, 4, num_workers=0).host_warp
    monkeypatch.setattr(native, "_load", lambda: (None, "OSError: libihprwarp.so: cannot open"))
    with caplog.at_level("WARNING"):
        loader = pipeline.BatchLoader([tds], cfg, 4, num_workers=0)
    assert not loader.host_warp and "cannot open" in caplog.text
    assert isinstance(next(loader.epoch(0)), pipeline.HostBatch)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.warp_batch([np.zeros((8, 8, 3), np.uint8)], np.eye(2, 3, dtype=np.float32)[None],
                          np.zeros(1, np.int32), 4, 4)


# --- steps, Tester and server on the canvas path --------------------------------


def _step_cfgs():
    jcfg = jax_tiny_cfg(matmul_precision="highest", bn_mode="lean").replace(
        data=_data_cfg(rot_prob=1.0, flip_prob=0.5),
        optim=jconfig.OptimConfig(batch_size_per_device=2, lr=1e-3),
    )
    return jcfg, to_port_cfg(jcfg)


def test_canvas_train_step_matches_jax(monkeypatch):
    """One fp32 train step on a canvas batch with augmentation, JAX's draws
    (fold_in(key(1), step 0), which its make_train_step takes) fed into the
    port's: loss 1e-5, every gradient 2e-4 of its tensor's largest."""
    jcfg, cfg = _step_cfgs()
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    batch = _canvas_batch(seed=4, b=2)
    jmodel = build_jax_model(jcfg)
    state, tx = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 10, params=params, batch_stats=stats)
    step = jax_make_train_step(jmodel, tx, jcfg, donate=False, debug_grads=True)
    _, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    drawn = jaugment.sample_aug_params(jax.random.fold_in(jax.random.key(1), 0), 2, jcfg.data)
    drawn = tuple(_t(np.asarray(p)) for p in drawn)

    keys = []
    monkeypatch.setattr(train_step, "sample_aug_params",
                        lambda gen, b, data: (keys.append(b), drawn)[1])
    model = build_pose_net(cfg, device="cpu", trainable=True)
    model.load_state_dict(from_jax_params(params, stats, cfg))
    opt, sched = train_step.make_optimizer(model, cfg, 10)
    got = train_step.make_train_step(model, opt, cfg, scheduler=sched)(
        {k: _t(v) for k, v in batch.items()}, 0, 0)
    assert keys == [2]
    assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    grads = from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), ref["grads"]), stats, cfg)
    for k, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), grads[k].numpy()) <= 2e-4, k
    with pytest.raises(ValueError, match="epoch, step"):
        train_step.make_train_step(model, opt, cfg)({k: _t(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def eval_setup():
    jcfg = jax_tiny_cfg(matmul_precision="highest")
    jcfg = jcfg.replace(eval=dataclasses.replace(jcfg.eval, batch_size_per_device=4),
                        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1))
    cfg = to_port_cfg(jcfg)
    jmodel, params, stats = jax_pose_weights(jcfg, seed=6)
    model = build_pose_net(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, stats, cfg))
    return jcfg, cfg, jmodel, params, stats, model


def test_canvas_eval_step_and_tester_match_jax(eval_setup, monkeypatch, tmp_path):
    """The flip-test eval step on a canvas batch within 2e-3 voxel of JAX's;
    then both Testers on the canvas path (native warp reported missing): the
    padded last batch scattered by HostBatch.sample_idx, predictions within
    2e-3 voxel."""
    jcfg, cfg, jmodel, params, stats, model = eval_setup
    batch = _canvas_batch(seed=5)
    ref, ref_img, _ = jax_make_eval_step(jmodel, jcfg)(params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
    coords, joint_img, _ = train_step.make_eval_step(inference_copy(model), cfg)({k: _t(v) for k, v in batch.items()})
    assert np.abs(np.asarray(ref) - 7.5).max() > 1.0
    np.testing.assert_allclose(coords.numpy(), np.asarray(ref), rtol=0, atol=2e-3)
    np.testing.assert_allclose(joint_img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-4)

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    jds = jdatasets.build_dataset("Human36M", "test", jcfg, "synthetic", 10)
    tds = datasets.build_dataset("Human36M", "test", cfg, "synthetic", 10)
    jstate, _ = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 1, params=params, batch_stats=stats)
    jt = jtester.Tester(jcfg.replace(output_dir=str(tmp_path / "jax")), dataset=jds, state=jstate, num_workers=0)
    tester = ttester.Tester(cfg.replace(output_dir=str(tmp_path / "port")), dataset=tds, state=model,
                            num_workers=0, device="cpu")
    try:
        assert not tester.loader.host_warp and not jt.loader.host_warp
        vox = tester.predict_voxels()
    finally:
        tester.close()
    np.testing.assert_allclose(vox, jt.predict_voxels(), rtol=0, atol=2e-3)


def test_server_device_warp_matches_jax(eval_setup, monkeypatch, caplog):
    """predict() with the native warp reported missing: the images pasted on
    one canvas, warped on the device, uint8 by truncation, as JAX's server
    falls back; coords within 2e-3 voxel of JAX's server doing the same, and
    the patches within one intensity step of the native warp's."""
    jcfg, cfg, _, params, stats, model = eval_setup
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (150 + 20 * i, 170, 3)).astype(np.uint8) for i in range(3)]
    bboxes = np.array([[40, 30, 90, 100], [-20, 10, 120, 90], [60, 20, 80, 140]], np.float32)
    srv = PoseServer(cfg, model, max_batch=4, device="cpu")
    jsrv = JaxPoseServer(jcfg, params, stats, max_batch=4)
    native_patches, _ = srv._preprocess(images, bboxes)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    with caplog.at_level("WARNING"):
        patches, _ = srv._preprocess(images, bboxes)
    assert "device warp" in caplog.text
    jpatches, _ = jsrv._preprocess(images, bboxes)
    assert patches.dtype == np.uint8 and np.abs(patches.astype(int) - jpatches.astype(int)).max() <= 1
    assert np.abs(patches.astype(int) - native_patches.astype(int)).max() <= 1
    got, want = srv.predict(images, bboxes), jsrv.predict(images, bboxes)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.coords_voxel, b.coords_voxel, rtol=0, atol=2e-3)


def test_trainer_on_canvas_batches_is_reproducible(monkeypatch, tmp_path):
    """With the native warp missing the Trainer takes the canvas path, as
    JAX's does; its augmentation is drawn from (seed, epoch, step), so two
    runs of the same config take the same steps."""
    monkeypatch.setattr(native, "available", lambda: False)
    _, cfg = _loader_cfgs(use_aug=True, batch=2)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, matmul_precision="highest"))

    def run(out):
        tr = Trainer(cfg.replace(output_dir=str(tmp_path / out)), "synthetic", num_workers=0, synthetic_size=4,
                     rss_limit_mb=0, device="cpu")
        try:
            assert not tr.loader.host_warp
            tr.train(end_epoch=1)
            return [float(v) for v in tr.losses]
        finally:
            tr.close()

    first = run("a")
    assert len(first) == 2 and np.isfinite(first).all()
    assert run("b") == first
