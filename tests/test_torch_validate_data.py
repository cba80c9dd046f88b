"""The port's data preflight on the CPU: ``ihpr_tpu_torch/tools/validate_data.py``
against the repository's ``tools/validate_data.py``, and
``ihpr_tpu_torch/tools/dress_rehearsal.py`` against ``tools/dress_rehearsal.py``.

- Each validator on ``tests/conftest.py``'s ``h36m_root`` / ``mpii_root`` /
  ``coco_root`` and on broken copies of them (a missing file, malformed and
  ragged camera arrays, a missing image id, truncated keypoints, an empty
  annotation list, missing image files): the same errors, warnings and
  ``stats``, and ``main``'s exit code by them.
- ``build_tree`` of both packages from the same arguments: the same
  annotation files and, on the CPU (cv2 encodes both), the same JPEG bytes;
  the port's tree passes both validators, and its samples sit inside their
  frames as JAX's test requires.
- ``dress_rehearsal.main --run`` on that tree drives the port's train and
  test CLIs (in this process: the commands' ``main`` called with their
  arguments, ``h36m3d_r50`` replaced by a tiny config), which write a
  snapshot, metrics and the ``--vis`` overlays.
"""

import filecmp
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from ihpr_tpu_torch.tools import dress_rehearsal, validate_data
from ihpr_tpu_torch.utils import shutdown
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The repository's ``tools/<name>.py``, loaded from its file."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edit_json(path, edit):
    with open(path) as f:
        data = json.load(f)
    edit(data)
    with open(path, "w") as f:
        json.dump(data, f)


def _h36m_cam(root):
    return f"{root}/annotations/Human36M_subject9_camera.json"


def _drop_id(data):
    del data["images"][0]["id"]
    del data["images"][0]["action_idx"]


# (fixture, how to break it, validator, its arguments)
CASES = {
    "h36m_test": ("h36m_root", None, "validate_h36m", ("test", 2, 0)),
    "h36m_train_missing_subjects": ("h36m_root", None, "validate_h36m", ("train", 2, 0)),
    "h36m_images_missing": ("h36m_root", None, "validate_h36m", ("test", 2, 4)),
    "h36m_no_camera_file": ("h36m_root", lambda r: os.rename(_h36m_cam(r), _h36m_cam(r) + ".bak"),
                            "validate_h36m", ("test", 2, 0)),
    "h36m_bad_f": ("h36m_root", lambda r: _edit_json(_h36m_cam(r), lambda c: c["1"].update(f=[1.0])),
                   "validate_h36m", ("test", 2, 0)),
    "h36m_ragged_R": ("h36m_root", lambda r: _edit_json(
        _h36m_cam(r), lambda c: c["1"].update(R=[[1, 0, 0], [0, 1], [0, 0, 1]])), "validate_h36m", ("test", 2, 0)),
    "h36m_missing_id": ("h36m_root", lambda r: _edit_json(f"{r}/annotations/Human36M_subject9_data.json", _drop_id),
                        "validate_h36m", ("test", 2, 0)),
    "mpii": ("mpii_root", None, "validate_mpii", ("train", 0)),
    "mpii_short_keypoints": ("mpii_root", lambda r: _edit_json(
        f"{r}/annotations/train.json",
        lambda d: d["annotations"][0].update(keypoints=d["annotations"][0]["keypoints"][:30])),
        "validate_mpii", ("train", 0)),
    "mpii_no_annotations": ("mpii_root", lambda r: _edit_json(f"{r}/annotations/train.json",
                                                              lambda d: d.update(annotations=[])),
                            "validate_mpii", ("train", 0)),
    "mpii_missing_split": ("mpii_root", None, "validate_mpii", ("val", 0)),
    "mscoco": ("coco_root", None, "validate_mscoco", ("train2017", 0)),
    "mscoco_images_missing": ("coco_root", None, "validate_mscoco", ("train2017", 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_validator_gives_jax_verdict(case, request):
    """Both validators on the same (possibly broken) tree: the same errors,
    warnings and stats."""
    fixture, breaker, fn, args = CASES[case]
    root = request.getfixturevalue(fixture)
    if breaker is not None:
        breaker(root)
    want = getattr(_jax_tool("validate_data"), fn)(root, *args)
    got = getattr(validate_data, fn)(root, *args)
    assert got.errors == want.errors
    assert got.warnings == want.warnings
    assert got.stats == want.stats
    expect_errors = case not in ("h36m_test", "mpii", "mscoco")
    assert bool(got.errors) == expect_errors, got.errors


def test_check_images_probes_spread_not_prefix(h36m_root):
    """A tree whose last subject's images are missing fails the probe even
    with fewer probes than the first subject's frames, in both packages."""
    from ihpr_tpu_torch.data.datasets import load_h36m

    samples = load_h36m(h36m_root, "test", protocol=2, sampling=1)
    for s in samples:
        if "s9_" in os.path.basename(s["img_path"]):
            os.makedirs(os.path.dirname(s["img_path"]), exist_ok=True)
            open(s["img_path"], "wb").write(b"x")
    jax_v = _jax_tool("validate_data")
    got, want = validate_data.Report(), jax_v.Report()
    validate_data._check_images(samples, 2, got)
    jax_v._check_images(samples, 2, want)
    assert got.errors == want.errors and any("missing" in e for e in got.errors)
    assert got.stats == want.stats == {"images_checked": 2}


@pytest.mark.parametrize("argv, code", [
    (["--dataset", "MPII", "--split", "train", "--check_images", "0"], 0),
    (["--dataset", "MPII", "--split", "val", "--check_images", "0"], 1),
])
def test_validate_data_main_exits_by_the_report(mpii_root, monkeypatch, capsys, argv, code):
    monkeypatch.setattr(shutdown, "install_graceful_shutdown", lambda: None)
    with pytest.raises(SystemExit) as exc:
        validate_data.main(argv + ["--data_root", mpii_root])
    assert exc.value.code == code
    assert capsys.readouterr().out.rstrip().endswith("validate_data: " + ("OK" if code == 0 else "FAIL"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same small tree built by JAX's and the port's ``build_tree``."""
    base = tmp_path_factory.mktemp("dress")
    args = dict(frames_train=10, frames_test=64, img_size=160)
    _jax_tool("dress_rehearsal").build_tree(str(base / "jax"), **args)
    dress_rehearsal.build_tree(str(base / "port"), **args, device="cpu")
    yield base
    import shutil

    shutil.rmtree(base, ignore_errors=True)


def test_port_tree_is_jax_tree(trees):
    """The same files: annotations and (cv2 q95 on the CPU) JPEG bytes."""
    cmp = filecmp.dircmp(trees / "jax", trees / "port")
    names = []

    def walk(c, prefix=""):
        assert not c.left_only and not c.right_only, (c.left_only, c.right_only)
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right, c.common_files, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
        names.extend(prefix + f for f in c.common_files)
        for sub, s in c.subdirs.items():
            walk(s, prefix + sub + "/")

    walk(cmp)
    assert sum(n.startswith("annotations/") for n in names) == 7 * 3 + 1
    assert sum(n.endswith(".jpg") for n in names) == 5 * 10 + 2 * 64 + 64


def test_port_tree_passes_both_validators(trees):
    """The port-built tree through both validators (H36M train and test,
    MPII train): no errors, the same stats, and its samples inside their
    frames with the bbox around the joints (JAX's test's checks)."""
    from ihpr_tpu_torch.data.datasets import load_h36m

    root = str(trees / "port")
    jax_v = _jax_tool("validate_data")
    for split, expect in (("train", 10), ("test", 2)):
        got = validate_data.validate_h36m(root, split, protocol=2, check_images=4)
        want = jax_v.validate_h36m(root, split, protocol=2, check_images=4)
        assert not got.errors and not want.errors, (got.errors, want.errors)
        assert got.stats == want.stats and got.stats["samples"] == expect
    got = validate_data.validate_mpii(root, "train", check_images=4)
    want = jax_v.validate_mpii(root, "train", check_images=4)
    assert not got.errors and got.stats == want.stats
    dress_rehearsal.validate(root)
    for s in load_h36m(root, "train", protocol=2)[:5]:
        ji = s["joint_img"]
        h, w = s["img_shape"]
        assert (ji[:, 0] >= 0).all() and (ji[:, 0] < w).all()
        assert (ji[:, 1] >= 0).all() and (ji[:, 1] < h).all()
        x, y, bw, bh = s["bbox"]
        assert x <= ji[:, 0].min() + 1 and x + bw >= ji[:, 0].max() - 1
        assert np.abs(ji[:, 2]).max() < 750.0


def test_validate_raises_on_a_broken_tree(trees, tmp_path):
    import shutil

    root = tmp_path / "broken"
    shutil.copytree(trees / "port" / "annotations", root / "annotations")
    os.remove(root / "annotations" / "train.json")
    with pytest.raises(AssertionError, match="Human36M train"):
        dress_rehearsal.validate(str(root))


def test_run_drives_the_port_clis(trees, tmp_path, monkeypatch):
    """``main --run`` on the built tree (reused: its ``annotations`` exist):
    the train CLI for 2 steps and the test CLI with ``--vis``, each command's
    ``main`` called with its arguments (``h36m3d_r50`` replaced by a tiny R18
    config): a snapshot, the metrics and JAX's overlay names."""
    import subprocess

    from ihpr_tpu_torch import config as tconfig
    from ihpr_tpu_torch import test as test_cli
    from ihpr_tpu_torch import train as train_cli

    cfg = tconfig.Config(
        name="h36m3d_r50",
        model=tconfig.ModelConfig(resnet_type=18, compute_dtype="float32", fp32_logits=True, bn_mode="lean"),
        data=tconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(64, 64),
                                output_shape=(16, 16), depth_dim=16, use_aug=False),
        optim=tconfig.OptimConfig(batch_size_per_device=4),
        eval=tconfig.EvalConfig(batch_size_per_device=2),
    )
    monkeypatch.setitem(tconfig.CONFIGS, "h36m3d_r50", cfg)
    for mod in (shutdown, train_cli, test_cli, dress_rehearsal):
        if hasattr(mod, "install_graceful_shutdown"):
            monkeypatch.setattr(mod, "install_graceful_shutdown", lambda: None)
    ran = []

    def run(cmd, check, env, timeout):
        assert cmd[:2] == [sys.executable, "-m"] and check
        ran.append(cmd[2])
        {"ihpr_tpu_torch.train": train_cli, "ihpr_tpu_torch.test": test_cli}[cmd[2]].main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(dress_rehearsal.subprocess, "run", run)
    out = tmp_path / "out"
    dress_rehearsal.main(["--root", str(trees / "port"), "--run", "--device", "cpu", "--output_dir", str(out)])
    assert ran == ["ihpr_tpu_torch.train", "ihpr_tpu_torch.test"]
    assert os.listdir(out / "model_dump")
    assert os.path.exists(out / "result" / "metrics_Human36M.json")
    assert sorted(os.listdir(out / "vis")) == ["pred_0.jpg", "pred_1.jpg"]
