"""The port's serving artifacts (ihpr_tpu_torch/engine/export.py) on the CPU,
mirroring the JAX package's tests/test_export.py: the loaded program must
reproduce the live PoseServer with the weights baked in, through the
flip-test branch and a symbolic batch; it must agree with JAX's own
artifact on the same weights, load in a process that has torch alone, and
come out of the export CLI from a snapshot.

The model is the tiny config of test_torch_models (ResNet-18, 64x64 input,
16x16x16 heatmaps, 18 joints) in fp32 "highest", with its BN statistics,
deconvs and final conv redrawn so heatmaps are peaked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ihpr_tpu.engine.export import export_server as jax_export_server
from ihpr_tpu.engine.export import load_exported as jax_load_exported
from ihpr_tpu.engine.server import PoseServer as JaxPoseServer
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.export import METADATA, export_server, load_exported
from ihpr_tpu_torch.engine.server import PoseServer
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.parallel.train_step import create_train_state
from ihpr_tpu_torch.tools import export_artifact
from test_torch_models import jax_pose_weights, jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_setup():
    jcfg = jax_tiny_cfg(matmul_precision="highest")
    _, params, stats = jax_pose_weights(jcfg, seed=5)
    cfg = to_port_cfg(jcfg)
    return jcfg, cfg, params, stats, from_jax_params(params, stats, cfg)


def _server(setup, max_batch, flip_test, state=None):
    _, cfg, _, _, sd = setup
    return PoseServer(cfg, state or sd, max_batch=max_batch, flip_test=flip_test, device="cpu")


def _patches(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 64, 64, 3)).astype(np.uint8)


def _ones(n):
    return np.ones((n, 3), np.float32)


def test_export_roundtrip_matches_server(tiny_setup):
    server = _server(tiny_setup, 4, flip_test=False)
    patches = _patches(0, 4)
    ref = server.predict_patches(patches)
    assert np.abs(ref - 7.5).max() > 1.0  # peaked heatmaps, not the volume centre

    blob = export_server(server)
    assert isinstance(blob, bytes) and len(blob) > 0
    fn = load_exported(blob)
    assert fn.metadata["batch"] == 4 and fn.metadata["device"] == "cpu"
    out = fn(patches, _ones(4)).numpy()
    assert out.shape == (4, 18, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_export_covers_flip_test_branch(tiny_setup):
    server = _server(tiny_setup, 2, flip_test=True)
    patches = _patches(1, 2)
    ref = server.predict_patches(patches)
    fn = load_exported(export_server(server))
    assert fn.metadata["flip_test"]
    np.testing.assert_allclose(fn(patches, _ones(2)).numpy(), ref, atol=1e-5)


def test_export_batch_polymorphic(tiny_setup):
    """One artifact, any batch size, through the flip-test branch, whose
    concat doubles the symbolic batch."""
    server = _server(tiny_setup, 4, flip_test=True)
    fn = load_exported(export_server(server, batch="poly"), device="cpu")
    assert fn.metadata["batch"] == "poly"
    for n in (1, 3):
        patches = _patches(n, n)
        ref = server.predict_patches(patches)
        np.testing.assert_allclose(fn(patches, _ones(n)).numpy(), ref, atol=1e-5)


def test_export_is_weight_dependent(tiny_setup):
    """The weights are baked in: other weights, other results (compared
    exactly, as JAX's test does)."""
    _, cfg, _, _, _ = tiny_setup
    other = build_pose_net(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    a = _server(tiny_setup, 2, flip_test=False)
    b = _server(tiny_setup, 2, flip_test=False, state=other.state_dict())
    patches = _patches(2, 2)
    fa, fb = load_exported(export_server(a)), load_exported(export_server(b))
    assert not np.array_equal(fa(patches, _ones(2)).numpy(), fb(patches, _ones(2)).numpy())


def test_export_leaves_server_and_flags(tiny_setup, monkeypatch):
    """Export changes nothing in the server (its weights and outputs, bitwise)
    nor the process's TF32 flags, which the "highest" forward turns off while
    it runs; the loaded callable leaves them as it found them too. Flags set
    to their non-defaults here, so a reset to defaults would show."""
    server = _server(tiny_setup, 2, flip_test=True)
    patches = _patches(3, 2)
    before = server.predict_patches(patches)
    state = {k: v.clone() for k, v in server.model.state_dict().items()}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    fn = load_exported(export_server(server))
    assert fn.metadata["matmul_precision"] == "highest"
    fn(patches, _ones(2))
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is False
    for k, v in server.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    np.testing.assert_array_equal(server.predict_patches(patches), before)


def test_artifact_matches_the_jax_artifact(tiny_setup):
    """The port's artifact against JAX's (``ihpr_tpu.engine.export``) on the
    same weights and patches, flip-test on: 2e-3 voxel, the end-to-end bar
    (PARITY.md)."""
    jcfg, _, params, stats, _ = tiny_setup
    jax_fn = jax_load_exported(
        jax_export_server(JaxPoseServer(jcfg, params, stats, max_batch=3, flip_test=True), platforms=("cpu",))
    )
    fn = load_exported(export_server(_server(tiny_setup, 3, flip_test=True)))
    patches = _patches(4, 3)
    ref = np.asarray(jax_fn(patches, _ones(3)))
    assert np.abs(ref - 7.5).max() > 1.0
    np.testing.assert_allclose(fn(patches, _ones(3)).numpy(), ref, atol=2e-3)


_TORCH_ONLY = """
import sys
import numpy as np
import torch
extra = {%(meta)r: ""}
program = torch.export.load(sys.argv[1], extra_files=extra).module()
patches = np.load(sys.argv[2])
out = program(torch.from_numpy(patches), torch.ones(len(patches), 3))
np.save(sys.argv[3], out.detach().numpy())
assert "ihpr_tpu_torch" not in sys.modules and "ihpr_tpu" not in sys.modules
print(extra[%(meta)r])
"""


def test_artifact_loads_in_a_process_with_torch_alone(tiny_setup, tmp_path):
    """torch.export.load in a fresh interpreter that cannot import the
    package (run outside the repository, PYTHONPATH cleared) reproduces the
    live server; the metadata travels inside the artifact."""
    server = _server(tiny_setup, 2, flip_test=True)
    patches = _patches(5, 2)
    (tmp_path / "pose.pt2").write_bytes(export_server(server))
    np.save(tmp_path / "patches.npy", patches)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _TORCH_ONLY % {"meta": METADATA}, "pose.pt2", "patches.npy", "out.npy"],
        cwd=tmp_path, env={**env, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["flip_test"] is True
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), server.predict_patches(patches), atol=1e-5)


def test_load_exported_raises_on_a_missing_device(tiny_setup):
    blob = export_server(_server(tiny_setup, 1, flip_test=False))
    missing = f"cuda:{torch.cuda.device_count()}" if torch.cuda.is_available() else "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(blob, device=missing)


# JAX's sidecar keys (tools/export_artifact.py), with "platforms" replaced by
# "device" and "matmul_precision" added.
_SIDECAR_KEYS = {
    "config", "inputs", "output", "joint_names", "flip_pairs", "input_shape", "output_shape",
    "depth_dim", "bbox_3d_shape_mm", "flip_test_fused", "device", "matmul_precision", "to_pixels",
}


def test_export_cli_from_a_snapshot(tiny_setup, tmp_path, monkeypatch):
    """``python -m ihpr_tpu_torch.tools.export_artifact`` on a snapshot that
    CheckpointManager wrote: the artifact reproduces load_server's
    predictions, and the sidecar has JAX's keys."""
    _, cfg, params, stats, _ = tiny_setup
    monkeypatch.setitem(tconfig.CONFIGS, "tiny_export", cfg.replace(name="tiny_export"))
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict=from_jax_params(params, stats, cfg))
    ckpt = CheckpointManager(str(tmp_path / "run"))
    ckpt.save(2, create_train_state(model, cfg, 1))
    ckpt.wait()
    out = str(tmp_path / "pose.pt2")
    meta = export_artifact.main(["--config", "tiny_export", "--snapshot_dir", str(tmp_path / "run"),
                                 "--batch", "2", "--flip_test", "--device", "cpu", "--out", out])
    with open(out + ".json") as f:
        assert json.load(f) == meta
    assert set(meta) == _SIDECAR_KEYS
    assert meta["flip_test_fused"] and meta["device"] == "cpu" and meta["matmul_precision"] == "highest"
    assert meta["joint_names"][0] == "Pelvis" and len(meta["joint_names"]) == 18
    assert meta["input_shape"] == [64, 64] and meta["depth_dim"] == 16
    patches = _patches(6, 2)
    served = PoseServer(cfg, model.state_dict(), max_batch=2, flip_test=True, device="cpu")
    fn = load_exported((tmp_path / "pose.pt2").read_bytes())
    np.testing.assert_allclose(fn(patches, _ones(2)).numpy(), served.predict_patches(patches), atol=1e-5)
    assert export_artifact.parse_args(["--config", "c", "--snapshot_dir", "d", "--out", "o",
                                       "--batch", "poly"]).batch == "poly"
