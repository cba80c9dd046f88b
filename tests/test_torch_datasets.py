"""The port's real-data path against the JAX package, on the CPU: the COCO
index, the Human3.6M / MPII / MSCOCO loaders, ``build_dataset`` with a real
root, ``materialize_synthetic``, loader batches from JPEGs, ``--pretrained``
(both file formats) and the hand-written msgpack decoder, and the CLIs on a
real root.

The annotation trees are ``tests/conftest.py``'s ``h36m_root``,
``mpii_root`` and ``coco_root`` and the committed fixture root
``tests/data/real_root`` (``tests/make_real_fixture.py``). Both packages
decode JPEGs with libjpeg here: the port with ``cv2.imdecode`` (its CPU
codec), JAX with the native library's fused decode + warp.
"""

import dataclasses
import json
import os
import shutil
import sys
import warnings

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import serialization

from ihpr_tpu.data import coco as jcoco
from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.data import pipeline as jpipeline
from ihpr_tpu.data import skeletons as jskeletons
from ihpr_tpu.engine.trainer import Trainer as JaxTrainer
from ihpr_tpu_torch import test as test_cli
from ihpr_tpu_torch import train as train_cli
from ihpr_tpu_torch.data import coco, datasets, skeletons
from ihpr_tpu_torch.data.pipeline import BatchLoader
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models import pretrained
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import inference_copy
from ihpr_tpu_torch.tools.synthetic_root import write_h36m_root, write_torchvision_resnet
from ihpr_tpu_torch.utils import msgpack
from test_torch_engine_io import _tiny_cfg
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_backbone  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "real_root")


def assert_samples_equal(got, want):
    """Sample dicts equal key for key: arrays to 1e-6, everything else exact."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                np.testing.assert_allclose(g[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                assert type(g[k]) is type(v) and g[k] == v, (k, g[k], v)


# ---------------------------------------------------------------------------
# The COCO index and the loaders


@pytest.mark.parametrize("which", ["mpii", "coco", "shuffled"])
def test_coco_index_matches_jax(which, mpii_root, coco_root):
    if which == "shuffled":  # ids out of order, several annotations per image
        rng = np.random.RandomState(0)
        data = dict(images=[dict(id=int(i)) for i in rng.permutation(7)],
                    annotations=[dict(id=int(a), image_id=int(a) % 4) for a in rng.permutation(12)],
                    categories=[dict(id=1, name="person")])
        ours, ref = coco.COCO(dataset=data), jcoco.COCO(dataset=data)
    else:
        path = (f"{mpii_root}/annotations/train.json" if which == "mpii"
                else f"{coco_root}/annotations/person_keypoints_train2017.json")
        ours, ref = coco.COCO(path), jcoco.COCO(path)
    assert ours.get_img_ids() == ref.get_img_ids()
    assert ours.get_ann_ids() == ref.get_ann_ids()
    some = ref.get_img_ids()[::2] + [99]
    assert ours.get_ann_ids(some) == ref.get_ann_ids(some)
    assert ours.load_anns(ref.get_ann_ids()) == ref.load_anns(ref.get_ann_ids())
    assert ours.load_imgs(ref.get_img_ids()) == ref.load_imgs(ref.get_img_ids())
    assert ours.cats == ref.cats


def _flat_joint_3d(root):
    """Rewrite a conftest H36M tree's joint_3d files in the flat
    ``{image_id: joints}`` layout, and give S11's frames an action_name."""
    for subj in (9, 11):
        prefix = f"{root}/annotations/Human36M_subject{subj}_"
        with open(prefix + "data.json") as f:
            data = json.load(f)
        with open(prefix + "joint_3d.json") as f:
            nested = json.load(f)
        flat = {str(img["id"]): nested[str(img["action_idx"])][str(img["subaction_idx"])][str(img["frame_idx"])]
                for img in data["images"]}
        for img in data["images"]:
            del img["action_idx"]
            if subj == 11:
                img["action_name"] = "Posing"
        with open(prefix + "data.json", "w") as f:
            json.dump(data, f)
        with open(prefix + "joint_3d.json", "w") as f:
            json.dump(flat, f)


@pytest.mark.parametrize("layout", ["nested", "flat"])
@pytest.mark.parametrize("protocol,sampling", [(2, None), (2, 1), (2, 3), (1, 1)])
def test_load_h36m_matches_jax(h36m_root, layout, protocol, sampling):
    """Both joint_3d layouts, the Thorax, root-relative z, the protocol's
    subjects and the sampling; without action_name the action_idx - 2
    fallback, with one warning a call."""
    if layout == "flat":
        _flat_joint_3d(h36m_root)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = datasets.load_h36m(h36m_root, "test", protocol, sampling)
    ours = [w for w in caught if "action_name" in str(w.message)]
    assert len(ours) == (1 if layout == "nested" else 0 if protocol == 1 else 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jdatasets.load_h36m(h36m_root, "test", protocol, sampling)
    assert_samples_equal(got, want)
    assert got[0]["joint_img"].shape == (18, 3)


def test_load_h36m_missing_subject_raises(h36m_root):
    """The train split's subjects are not in the tree: both raise."""
    for load in (datasets.load_h36m, jdatasets.load_h36m):
        with pytest.raises(FileNotFoundError, match="subject1_data"):
            load(h36m_root, "train")


@pytest.mark.parametrize("root", ["conftest", "fixture"])
def test_load_mpii_matches_jax(mpii_root, root):
    """Zero-visibility annotations skipped; head_box kept where present (the
    fixture's first frame has one)."""
    path = mpii_root if root == "conftest" else FIXTURE
    got, want = datasets.load_mpii(path, "train"), jdatasets.load_mpii(path, "train")
    assert_samples_equal(got, want)
    assert ("head_box" in got[0]) == (root == "fixture")


def test_load_mscoco_matches_jax(coco_root):
    """Crowd and zero-keypoint annotations skipped; image_id and area kept."""
    with open(f"{coco_root}/annotations/person_keypoints_train2017.json") as f:
        data = json.load(f)
    data["annotations"][1]["num_keypoints"] = 0
    del data["annotations"][2]["area"]
    with open(f"{coco_root}/annotations/person_keypoints_val2017.json", "w") as f:
        json.dump(data, f)
    for split, n in (("train2017", 3), ("val2017", 2)):
        got, want = datasets.load_mscoco(coco_root, split), jdatasets.load_mscoco(coco_root, split)
        assert_samples_equal(got, want)
        assert len(got) == n
    assert [s["image_id"] for s in got] == [0, 2] and got[1]["area"] == 200.0 * 300.0  # area from the bbox


@pytest.mark.parametrize("protocol", [1, 2])
def test_build_dataset_real_roots_match_jax(tmp_path, monkeypatch, protocol, h36m_root, mpii_root, coco_root):
    """One root for every name (its loader's layout), data/<name> when no
    root is given, cfg.eval.protocol's H36M subjects; a missing root raises
    FileNotFoundError in both."""
    jcfg = jax_tiny_cfg()
    jcfg = jcfg.replace(eval=dataclasses.replace(jcfg.eval, protocol=protocol))
    cfg = to_port_cfg(jcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, split, root in (("Human36M", "test", h36m_root), ("MPII", "train", mpii_root),
                                  ("MSCOCO", "train2017", coco_root)):
            got = datasets.build_dataset(name, split, cfg, root)
            want = jdatasets.build_dataset(name, split, jcfg, root)
            assert (got.name, got.is_train, got.joint_num) == (want.name, want.is_train, want.joint_num)
            assert_samples_equal(got.samples, want.samples)
        shutil.copytree(mpii_root, tmp_path / "cwd" / "data" / "MPII")
        monkeypatch.chdir(tmp_path / "cwd")
        assert_samples_equal(datasets.build_dataset("MPII", "train", cfg).samples,
                             jdatasets.build_dataset("MPII", "train", jcfg).samples)
    for build, c in ((datasets.build_dataset, cfg), (jdatasets.build_dataset, jcfg)):
        with pytest.raises(FileNotFoundError):
            build("Human36M", "train", c, str(tmp_path / "nope"))
        with pytest.raises(FileNotFoundError):
            build("MSCOCO", "train2017", c)  # data/MSCOCO is not there


# ---------------------------------------------------------------------------
# materialize_synthetic and loader batches from JPEGs


@pytest.mark.parametrize("hue", ["index", "semantic", "hue_skeleton"])
def test_materialize_synthetic_matches_jax(tmp_path, hue):
    """The same file names (the cache key) and the same bytes (cv2 on both
    sides here); a second call reuses the files; img_path is the only
    change to a sample."""
    kw = dict(hue_mode="semantic") if hue == "semantic" else {}
    if hue == "hue_skeleton":
        kw = dict(hue_skeleton=skeletons.H36M)
        jkw = dict(hue_skeleton=jskeletons.H36M)
    else:
        jkw = kw
    sk, jsk = (skeletons.MPII, jskeletons.MPII) if hue == "hue_skeleton" else (skeletons.H36M, jskeletons.H36M)
    samples = datasets.make_synthetic(sk, 3, seed=5, img_size=96, **kw)
    jsamples = jdatasets.make_synthetic(jsk, 3, seed=5, img_size=96, **jkw)
    got = datasets.materialize_synthetic(samples, str(tmp_path / "t"), quality=90, device="cpu")
    want = jdatasets.materialize_synthetic(jsamples, str(tmp_path / "j"), quality=90)
    for g, w, s in zip(got, want, samples):
        assert os.path.basename(g["img_path"]) == os.path.basename(w["img_path"])
        with open(g["img_path"], "rb") as f, open(w["img_path"], "rb") as h:
            assert f.read() == h.read()
        assert {k: v for k, v in g.items() if k != "img_path"}.keys() == s.keys() - {"img_path"}
    stamps = [os.stat(g["img_path"]).st_mtime_ns for g in got]
    again = datasets.materialize_synthetic(samples, str(tmp_path / "t"), quality=90, device="cpu")
    assert [os.stat(g["img_path"]).st_mtime_ns for g in again] == stamps
    other = datasets.materialize_synthetic(samples, str(tmp_path / "t"), quality=80, device="cpu")
    assert all(o["img_path"] != g["img_path"] for o, g in zip(other, got))


def _fixture_sets(pkg, sk):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        h36m = pkg.load_h36m(FIXTURE, "test", 2, sampling=1)
    return [pkg.PoseDataset("Human36M", sk.H36M, h36m, True),
            pkg.PoseDataset("MPII", sk.MPII, pkg.load_mpii(FIXTURE, "train"), True)]


def test_fixture_loader_batch_is_jaxs_committed_patches():
    """The fixture root's no-aug host-warp batch (h36m3d_r50, H36M + MPII)
    equals the JAX loader's, committed in patches.npz: patches bitwise."""
    from ihpr_tpu_torch.config import get_config

    loader = BatchLoader(_fixture_sets(datasets, skeletons), get_config("h36m3d_r50"), 6, train=False,
                         num_workers=2, host_warp=True, device="cpu")
    try:
        hb = next(loader.epoch(0))
    finally:
        loader.close()
    ref = np.load(os.path.join(FIXTURE, "patches.npz"))
    np.testing.assert_array_equal(hb.sample_idx, ref["sample_idx"])
    np.testing.assert_array_equal(hb.patch, ref["patch"])
    np.testing.assert_allclose(hb.joint_img, ref["joint_img"], atol=1e-5)
    np.testing.assert_array_equal(hb.joint_vis, ref["joint_vis"])


@pytest.mark.parametrize("host_warp", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_from_jpegs_match_jax(host_warp, train):
    """Batches of the fixture's JPEGs through both loaders, augmented and
    not, host-warped and as canvases: patches and canvases bitwise (both
    decode with libjpeg here), joints to 1e-5."""
    from ihpr_tpu import config as jconfig

    jcfg = jconfig.get_config("h36m3d_r50")
    jcfg = jcfg.replace(parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1))
    cfg = to_port_cfg(jcfg)
    kw = dict(train=train, num_workers=2, host_warp=host_warp, seed=3, canvas_px=256)
    ours = BatchLoader(_fixture_sets(datasets, skeletons), cfg, 4, device="cpu", **kw)
    ref = jpipeline.BatchLoader(_fixture_sets(jdatasets, jskeletons), jcfg, 4, **kw)
    try:
        got, want = list(ours.epoch(1)), list(ref.epoch(1))
    finally:
        ours.close()
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.sample_idx, w.sample_idx)
        if host_warp:
            np.testing.assert_array_equal(g.patch, w.patch)
            np.testing.assert_array_equal(g.color_scale, w.color_scale)
            np.testing.assert_allclose(g.joint_img, w.joint_img, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.canvas, w.canvas)
            np.testing.assert_allclose(g.canvas_origin, w.canvas_origin, atol=1e-5)
            np.testing.assert_allclose(g.joints, w.joints, atol=1e-5)
        np.testing.assert_array_equal(g.joint_vis, w.joint_vis)


def test_loader_names_an_unreadable_file(tmp_path):
    """A corrupt JPEG in a batch raises, naming the file; a missing one
    raises FileNotFoundError."""
    root = tmp_path / "root"
    shutil.copytree(FIXTURE, root)
    (root / "images" / "mpii_1.jpg").write_bytes(b"\xff\xd8 not really a jpeg")
    sets = [datasets.PoseDataset("MPII", skeletons.MPII, datasets.load_mpii(str(root), "train"), True)]
    loader = BatchLoader(sets, to_port_cfg(jax_tiny_cfg()), 2, train=False, num_workers=0, device="cpu")
    with pytest.raises(ValueError, match="mpii_1.jpg"):
        next(loader.epoch(0))
    (root / "images" / "mpii_1.jpg").unlink()
    with pytest.raises(FileNotFoundError):
        next(loader.epoch(0))


# ---------------------------------------------------------------------------
# --pretrained and the msgpack decoder


def _pretrained_files(tmp_path, resnet_type):
    """(a seeded torchvision-layout state_dict, its .pth, its flax msgpack by
    convert_torch_ckpt.convert_backbone)."""
    pth, mp = str(tmp_path / "resnet.pth"), str(tmp_path / "resnet.msgpack")
    sd = write_torchvision_resnet(pth, resnet_type)
    params, stats = convert_backbone(sd, resnet_type)
    with open(mp, "wb") as f:
        f.write(serialization.to_bytes({"params": params, "batch_stats": stats}))
    return sd, pth, mp


@pytest.fixture(scope="module")
def pretrained_trainers(tmp_path_factory):
    """A JAX Trainer and two port Trainers (tiny R18, fp32 "highest"), each
    given the same seeded backbone: JAX from the msgpack, the port from the
    .pth and from the msgpack."""
    tmp = tmp_path_factory.mktemp("pretrained")
    jcfg = jax_tiny_cfg(matmul_precision="highest")
    jcfg = jcfg.replace(output_dir=str(tmp / "jax"),
                        parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1))
    cfg = to_port_cfg(jcfg)
    jds = jdatasets.PoseDataset("Human36M", jskeletons.H36M,
                                jdatasets.make_synthetic(jskeletons.H36M, 4, seed=0, img_size=200), True)
    ds = datasets.PoseDataset("Human36M", skeletons.H36M,
                              datasets.make_synthetic(skeletons.H36M, 4, seed=0, img_size=200), True)
    jtrainer = JaxTrainer(jcfg, datasets=[jds], num_workers=0)
    ports = [Trainer(cfg.replace(output_dir=str(tmp / f"port{i}")), datasets=[ds], num_workers=0, device="cpu")
             for i in range(2)]
    sd, pth, mp = _pretrained_files(tmp, 18)
    before = {k: v.clone() for k, v in ports[0].model.state_dict().items()}
    jtrainer.load_pretrained_backbone(mp)
    ports[0].load_pretrained_backbone(pth)
    ports[1].load_pretrained_backbone(mp)
    for t in ports:
        t.close()
    return jcfg, cfg, jtrainer, ports, sd, before, (pth, mp)


def test_pretrained_backbone_matches_jax(pretrained_trainers):
    """The backbone from either file equals JAX's loaded state to 1e-6;
    the head and the optimizer's moments are untouched."""
    jcfg, cfg, jtrainer, ports, sd, before, _ = pretrained_trainers
    state = jax.tree.map(np.asarray, jtrainer.state)
    want = from_jax_params(state.params, state.batch_stats, cfg)
    for t in ports:
        got = t.model.state_dict()
        for k, v in got.items():
            if k.startswith("backbone."):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                assert torch.equal(v, before[k]), k
        assert all(not s for s in t.state.optimizer.state.values())
    np.testing.assert_array_equal(ports[0].model.backbone.layer2_0.down_conv.weight.detach().numpy(),
                                  sd["layer2.0.downsample.0.weight"].numpy())


def test_pretrained_forward_matches_jax(pretrained_trainers):
    """One fp32 forward of the pretrained backbone under the same seeded,
    peaked head: coords within 2e-3 voxel of JAX's."""
    jcfg, cfg, jtrainer, ports, _, _, _ = pretrained_trainers
    _, peaked, peaked_stats = jax_pose_weights(jcfg, seed=2)
    params = {**jtrainer.state.params, "head": peaked["head"]}
    stats = {**jtrainer.state.batch_stats, "head": peaked_stats["head"]}
    head = {k: v for k, v in from_jax_params(params, stats, cfg).items() if k.startswith("head.")}
    model = inference_copy(ports[0].model)
    model.load_state_dict({**model.state_dict(), **head})
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jtrainer.model.apply({"params": params, "batch_stats": stats}, x, train=False,
                                          method=jtrainer.model.coords))
    with torch.inference_mode():
        got = model.coords(torch.from_numpy(x)).numpy()
    assert np.abs(ref - ref.mean(0)).max() > 0.1  # peaked heatmaps: the coords are not all central
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("fault", ["missing", "unknown", "shape", "truncated", "trailing"])
def test_malformed_pretrained_files_raise(pretrained_trainers, tmp_path, fault):
    _, _, _, ports, sd, _, (pth, mp) = pretrained_trainers
    backbone = ports[0].model.backbone
    if fault in ("truncated", "trailing"):
        blob = open(mp, "rb").read()
        path = str(tmp_path / "bad.msgpack")
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2] if fault == "truncated" else blob + b"\x00")
        with pytest.raises(ValueError, match="truncated" if fault == "truncated" else "after the value"):
            pretrained.load_backbone(backbone, path)
        return
    bad = dict(sd)
    if fault == "missing":
        del bad["layer3.1.bn2.running_var"]
        match = "missing.*layer3_1.bn2.running_var"
    elif fault == "unknown":
        bad["layer9.0.conv1.weight"] = torch.zeros(1)
        match = "unknown.*layer9"
    else:
        bad["layer1.0.conv2.weight"] = torch.zeros(64, 64, 1, 1)
        match = "mis-shaped.*layer1_0.conv2.weight"
    path = str(tmp_path / "bad.pth")
    torch.save(bad, path)
    stamp = {k: v.clone() for k, v in backbone.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        pretrained.load_backbone(backbone, path)
    assert all(torch.equal(v, stamp[k]) for k, v in backbone.state_dict().items())  # nothing half-loaded


def test_msgpack_decoder_reads_flax_trees():
    """Nested dicts, fp32 / bf16 / int / uint / bool arrays, an empty array,
    numpy and Python scalars, strings and lists, as flax.serialization
    writes them."""
    rng = np.random.RandomState(0)
    tree = {
        "params": {"conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32)},
                   "bn": {"scale": jax.numpy.asarray(rng.randn(7), jax.numpy.bfloat16)}},
        "ints": {"i8": np.arange(-3, 3, dtype=np.int8), "i64": np.array([2**40, -5], np.int64),
                 "u16": np.arange(4, dtype=np.uint16), "mask": np.array([True, False])},
        "empty": np.zeros((0, 3), np.float32),
        "step": np.int32(12), "lr": np.float32(0.5), "n": -7, "big": 2**33, "pi": 3.25, "name": "r50",
        "none": None, "flag": True, "layers": [1, "two", {"x": 3.0}],
    }
    got = msgpack.unpackb(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(serialization.to_bytes(tree))

    def check(g, w, path):
        if isinstance(w, dict):
            assert isinstance(g, dict) and g.keys() == w.keys(), path
            for k in w:
                check(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            w = np.asarray(w)
            assert isinstance(g, torch.Tensor) and tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
            np.testing.assert_array_equal(g.float().numpy() if w.dtype.name == "bfloat16" else g.numpy(),
                                          w.astype(np.float32) if w.dtype.name == "bfloat16" else w)
        else:
            assert type(g) is type(w) and g == w, path

    check(got, want, "")


# ---------------------------------------------------------------------------
# The CLIs on a real root


def test_cli_train_and_test_on_a_jpeg_root(tmp_path, monkeypatch):
    """``train --data_root R --pretrained P`` then ``test --data_root R`` on
    the tiny config (the CLIs' main, on the CPU): a materialized synthetic
    H36M root (JPEGs written by the port, read back by its loader), the
    backbone from the .pth, one snapshot, finite MPJPE; --spatial accepted;
    ``--vis`` writes JAX's overlay files, ``vis/pred_{i}.jpg`` for the 4
    test frames, each decoding to its frame's size."""
    from ihpr_tpu_torch.config import CONFIGS

    monkeypatch.setattr(train_cli, "install_graceful_shutdown", lambda: None)
    monkeypatch.setattr(test_cli, "install_graceful_shutdown", lambda: None)
    monkeypatch.setitem(CONFIGS, "tiny_r18", _tiny_cfg())
    root = tmp_path / "root"
    write_h36m_root(str(root), n_train=8, n_test=4, size=96, device="cpu")
    sd, pth, _ = _pretrained_files(tmp_path, 18)
    out = str(tmp_path / "run")
    seen = {}
    real_train = Trainer.train

    def spy(self, *a, **k):
        seen["conv1"] = self.model.backbone.conv1.weight.detach().clone()
        seen["img_path"] = self.loader.datasets[0].samples[0]["img_path"]
        return real_train(self, *a, **k)

    monkeypatch.setattr(Trainer, "train", spy)
    common = ["--config", "tiny_r18", "--data_root", str(root), "--device", "cpu", "--output_dir", out,
              "--num_workers", "0"]
    train_cli.main([*common, "--pretrained", pth, "--steps", "2", "--end_epoch", "1"])
    assert torch.equal(seen["conv1"], sd["conv1.weight"]) and seen["img_path"].startswith(str(root))
    assert os.path.isdir(os.path.join(out, "model_dump"))
    metrics = test_cli.main(common + ["--vis"])
    assert np.isfinite(metrics["MPJPE total"])
    assert train_cli.parse_args([*common, "--spatial", "2"]).spatial == 2
    assert sorted(os.listdir(os.path.join(out, "vis"))) == [f"pred_{i}.jpg" for i in range(4)]
    for i in range(4):
        frame = cv2.imread(os.path.join(out, "vis", f"pred_{i}.jpg"))
        assert frame.shape == (96, 96, 3)
