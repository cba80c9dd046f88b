"""What reads and drives the port's snapshots, on the CPU: ``Tester(state=None)``,
``load_server``, the ``train`` and ``test`` CLIs, the graceful SIGTERM
handler and the RSS limit.

The model is the tiny config of test_torch_models (ResNet-18, 64x64 input,
16x16x16 heatmaps, 18 joints) with peaked heatmaps: its BN statistics,
deconvs and final conv redrawn with numpy (``jax_pose_weights``).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from ihpr_tpu.data import datasets as jdatasets
from ihpr_tpu.engine import tester as jtester
from ihpr_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from ihpr_tpu.parallel import create_train_state as jax_create_train_state
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch import test as test_cli
from ihpr_tpu_torch import train as train_cli
from ihpr_tpu_torch.data import datasets
from ihpr_tpu_torch.engine import tester as ttester
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.server import PoseServer, load_server
from ihpr_tpu_torch.models.convert import from_jax_params, from_jax_train_state
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.parallel.train_step import create_train_state
from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL, host_rss_mb, host_total_mb, resolve_rss_limit_mb
from test_torch_eval import N_TEST, _cfgs
from test_torch_models import jax_pose_weights
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tiny config under a name the CLIs can look up (flagship dtypes, batch 4).
_TINY = """
from ihpr_tpu_torch import config as tconfig
TINY = tconfig.Config(
    name="tiny_r18",
    model=tconfig.ModelConfig(resnet_type=18, compute_dtype="bfloat16", fp32_logits=False, bn_mode="lean"),
    data=tconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(64, 64),
                            output_shape=(16, 16), depth_dim=16, use_aug=False),
    optim=tconfig.OptimConfig(batch_size_per_device=4),
    eval=tconfig.EvalConfig(batch_size_per_device=4),
)
tconfig.CONFIGS["tiny_r18"] = TINY
"""


def _tiny_cfg():
    scope = {}
    exec(_TINY, scope)
    del tconfig.CONFIGS["tiny_r18"]
    return scope["TINY"]


@pytest.fixture(scope="module")
def weights():
    """fp32 "highest" configs and peaked weights on both sides, and each
    side's synthetic Human36M test split."""
    jcfg, cfg = _cfgs(matmul_precision="highest")
    jmodel, params, stats = jax_pose_weights(jcfg, seed=6)
    jds = jdatasets.build_dataset("Human36M", "test", jcfg, "synthetic", N_TEST)
    tds = datasets.build_dataset("Human36M", "test", cfg, "synthetic", N_TEST)
    return jcfg, cfg, jmodel, params, stats, jds, tds


def _port_snapshot(cfg, params, stats, out, epoch=3):
    """A port model with the given JAX weights, saved as snapshot ``epoch``
    under ``out``; returns the model."""
    model = build_pose_net(cfg, device="cpu", trainable=True, state_dict=from_jax_params(params, stats, cfg))
    ckpt = CheckpointManager(str(out))
    ckpt.save(epoch, create_train_state(model, cfg, 1))
    ckpt.wait()
    return model


def test_tester_from_a_snapshot_equals_the_tester_of_its_model(weights, tmp_path):
    """Tester(state=None) loads the latest snapshot, or ``test_epoch``, from
    cfg.output_dir and predicts bitwise what Tester(state=model) predicts;
    it logs to {output_dir}/log/test_logs.txt."""
    _, cfg, _, params, stats, _, tds = weights
    cfg = cfg.replace(output_dir=str(tmp_path))
    model = _port_snapshot(cfg, params, stats, tmp_path, epoch=3)
    _port_snapshot(cfg, params, stats, tmp_path, epoch=1)
    preds = []
    for kw in (dict(state=model), dict(state=None), dict(state=None, test_epoch=1)):
        tester = ttester.Tester(cfg, dataset=tds, num_workers=0, device="cpu", **kw)
        try:
            preds.append(tester.predict_voxels())
        finally:
            tester.close()
    assert np.abs(preds[0] - 7.5).max() > 1.0  # away from the volume centre
    np.testing.assert_array_equal(preds[1], preds[0])
    np.testing.assert_array_equal(preds[2], preds[0])
    log = (tmp_path / "log" / "test_logs.txt").read_text()
    assert "loaded snapshot_3" in log and "loaded snapshot_1" in log


def test_jax_snapshot_converted_gives_the_jax_testers_metrics(weights, tmp_path):
    """A JAX snapshot, restored with JAX's CheckpointManager and converted
    with from_jax_train_state into a port snapshot: the port's
    Tester(state=None) matches the JAX Tester(state=None) on the same
    snapshot to the bound of test_tester_matches_jax (voxels within 2e-3,
    MPJPE within 0.5 mm)."""
    jcfg, cfg, jmodel, params, stats, jds, tds = weights
    jcfg = jcfg.replace(output_dir=str(tmp_path / "jax"))
    jstate, _ = jax_create_train_state(jmodel, jcfg, jax.random.key(0), 1, params=params, batch_stats=stats)
    jckpt = JaxCheckpointManager(jcfg.output_dir)
    jckpt.save(2, jstate, jax.random.key(0))
    jckpt.wait()
    jax_tester = jtester.Tester(jcfg, dataset=jds, num_workers=0)
    ref_vox = jax_tester.predict_voxels()
    ref = jax_tester.evaluate()

    restored, _, _, _ = jckpt.load(2, jstate, jax.random.key(0))
    restored = jax.tree.map(np.asarray, restored)
    cfg = cfg.replace(output_dir=str(tmp_path / "port"))
    holder = create_train_state(build_pose_net(cfg, device="cpu", trainable=True), cfg, 1)
    holder.load_state_dict(
        from_jax_train_state(restored.params, restored.batch_stats, restored.opt_state, restored.step, cfg)
    )
    ckpt = CheckpointManager(cfg.output_dir)
    ckpt.save(2, holder)
    ckpt.wait()
    tester = ttester.Tester(cfg, dataset=tds, num_workers=0, device="cpu")
    try:
        vox = tester.predict_voxels()
        metrics = tester.evaluate()
    finally:
        tester.close()
    assert np.abs(ref_vox - 7.5).max() > 1.0
    np.testing.assert_allclose(vox, ref_vox, atol=2e-3)
    assert metrics.keys() == ref.keys()
    for k in ref:
        assert metrics[k] == pytest.approx(ref[k], abs=0.5), k


def test_load_server_equals_pose_server(weights, tmp_path):
    """load_server(cfg, dir) serves the snapshot's weights: predict_patches
    equals a PoseServer on the same model, bitwise; a directory without a
    snapshot raises FileNotFoundError."""
    _, cfg, _, params, stats, _, _ = weights
    model = _port_snapshot(cfg, params, stats, tmp_path / "run", epoch=0)
    patches = np.random.RandomState(3).randint(0, 256, (6, 64, 64, 3)).astype(np.uint8)
    want = PoseServer(cfg, model, max_batch=4, device="cpu").predict_patches(patches)
    for kw in (dict(), dict(epoch=0)):
        got = load_server(cfg, str(tmp_path / "run"), max_batch=4, device="cpu", **kw).predict_patches(patches)
        np.testing.assert_array_equal(got, want)
    assert np.abs(want - 7.5).max() > 1.0
    served = load_server(cfg.replace(output_dir=str(tmp_path / "run")), max_batch=4, device="cpu")
    np.testing.assert_array_equal(served.predict_patches(patches), want)
    with pytest.raises(FileNotFoundError):
        load_server(cfg, str(tmp_path / "empty"), device="cpu")


# --- the CLIs --------------------------------------------------------------------


def test_train_and_test_cli_main(tmp_path, monkeypatch, capsys):
    """train.main --device cpu --output_dir D trains and snapshots; --continue
    resumes from the latest snapshot; test.main evaluates the latest one.
    Both install the SIGTERM handler first (recorded here, so this process
    keeps its own) and write their logs under D/log."""
    monkeypatch.setitem(tconfig.CONFIGS, "tiny_r18", _tiny_cfg())
    installed = []
    for cli in (train_cli, test_cli):
        monkeypatch.setattr(cli, "install_graceful_shutdown", lambda: installed.append(True))
    out = str(tmp_path / "run")
    common = ["--config", "tiny_r18", "--synthetic", "--device", "cpu", "--output_dir", out,
              "--synthetic_size", "4", "--num_workers", "0"]
    train_cli.main([*common, "--end_epoch", "1", "--rss_limit_mb", "0"])
    assert CheckpointManager(out)._epochs_on_disk() == [0]
    train_cli.main([*common, "--end_epoch", "2", "--continue", "--rss_check_steps", "0"])
    assert CheckpointManager(out)._epochs_on_disk() == [0, 1]
    log = (tmp_path / "run" / "log" / "train_logs.txt").read_text()
    assert "resumed from snapshot_0" in log and "saving snapshot_1" in log
    capsys.readouterr()
    metrics = test_cli.main(common)
    assert np.isfinite(metrics["MPJPE total"])
    assert str(metrics) in capsys.readouterr().out
    assert "loaded snapshot_1" in (tmp_path / "run" / "log" / "test_logs.txt").read_text()
    with open(tmp_path / "run" / "result" / "metrics_Human36M.json") as f:
        assert json.load(f) == metrics
    assert installed == [True] * 3


def test_steps_without_end_epoch_hands_train_what_jax_does(tmp_path, monkeypatch):
    """``--steps 2`` without ``--end_epoch``: the port's train.main caps the
    epochs at 2 steps and hands Trainer.train the end_epoch that the
    repository's train.py hands the JAX Trainer (None: the config's
    optim.end_epoch, 25 epochs of 2 steps), not one epoch."""
    import importlib.util

    import ihpr_tpu.utils.shutdown as jshutdown
    from ihpr_tpu import config as jconfig
    from ihpr_tpu.engine import trainer as jtrainer
    from ihpr_tpu_torch.engine.trainer import Trainer

    calls = {"port": [], "jax": []}
    monkeypatch.setitem(tconfig.CONFIGS, "tiny_r18", _tiny_cfg())
    monkeypatch.setattr(train_cli, "install_graceful_shutdown", lambda: None)
    monkeypatch.setattr(
        Trainer, "train", lambda self, end_epoch=None, **kw: calls["port"].append((end_epoch, self.steps_per_epoch))
    )
    train_cli.main(["--config", "tiny_r18", "--synthetic", "--device", "cpu", "--output_dir",
                    str(tmp_path), "--synthetic_size", "16", "--num_workers", "0", "--steps", "2"])

    class JaxTrainerRecorder:  # what train.py calls on the JAX Trainer
        def __init__(self, cfg, **kw):
            self.steps_per_epoch = None

        def cap_steps_per_epoch(self, n):
            self.steps_per_epoch = n

        def train(self, end_epoch=None, **kw):
            calls["jax"].append((end_epoch, self.steps_per_epoch))

    monkeypatch.setattr(jtrainer, "Trainer", JaxTrainerRecorder)
    monkeypatch.setattr(jshutdown, "install_graceful_shutdown", lambda: None)
    spec = importlib.util.spec_from_file_location("jax_train_cli", os.path.join(REPO, "train.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(sys, "argv", ["train.py", "--config", "h36m3d_r50", "--synthetic", "--steps", "2"])
    jax_cli.main()
    assert calls["port"] == calls["jax"] == [(None, 2)]
    port_epochs = tconfig.get_config("h36m3d_r50").optim.end_epoch
    assert port_epochs == jconfig.get_config("h36m3d_r50").optim.end_epoch == 25


def test_cli_flags_ported_and_refused():
    """train accepts --continue, --output_dir, --profile_dir, --rss_limit_mb,
    --rss_check_steps, --multihost, --shard_opt_state, --pretrained and
    --spatial; test accepts --multihost, --spatial and --vis (ported: the
    overlays); both accept a real --data_root."""
    args = train_cli.parse_args([
        "--synthetic", "--continue", "--output_dir", "o", "--profile_dir", "p",
        "--rss_limit_mb", "0", "--rss_check_steps", "5",
    ])
    assert (args.continue_train, args.output_dir, args.profile_dir) == (True, "o", "p")
    assert (args.rss_limit_mb, args.rss_check_steps) == (0.0, 5)
    assert train_cli.parse_args(["--synthetic"]).rss_check_steps == 100
    assert train_cli.parse_args(["--synthetic", "--pretrained", "x.msgpack"]).pretrained == "x.msgpack"
    assert train_cli.parse_args(["--synthetic", "--spatial", "2"]).spatial == 2
    args = train_cli.parse_args(["--synthetic", "--multihost", "--shard_opt_state"])
    assert args.multihost and args.shard_opt_state
    args = test_cli.parse_args(["--synthetic", "--test_epoch", "3", "--output_dir", "o"])
    assert (args.test_epoch, args.output_dir, args.synthetic_size) == (3, "o", 128)
    assert test_cli.parse_args(["--synthetic", "--multihost"]).multihost
    assert test_cli.parse_args(["--synthetic", "--spatial", "2"]).spatial == 2
    assert test_cli.parse_args(["--synthetic", "--vis"]).vis
    assert not test_cli.parse_args(["--synthetic"]).vis
    for cli in (train_cli, test_cli):
        args = cli.parse_args(["--data_root", "/data/Human36M"])
        assert (args.data_root, args.synthetic) == ("/data/Human36M", False)


def test_rss_preempt_exit_code_reaches_the_shell(tmp_path):
    """``python -m ihpr_tpu_torch.train`` past --rss_limit_mb snapshots mid
    epoch and exits with EX_TEMPFAIL (75)."""
    out = str(tmp_path / "run")
    code = _TINY + (
        "import runpy, sys\n"
        f"sys.argv = ['train', '--config', 'tiny_r18', '--synthetic', '--device', 'cpu', "
        f"'--output_dir', {out!r}, '--synthetic_size', '8', '--num_workers', '0', "
        "'--rss_limit_mb', '1', '--rss_check_steps', '1']\n"
        "runpy.run_module('ihpr_tpu_torch.train', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == EX_TEMPFAIL, proc.stderr[-2000:]
    _, epoch, itr = CheckpointManager(out).load(0)
    assert (epoch, itr) == (0, 0)


def test_make_output_tree(tmp_path):
    """The reference's output layout under output_dir."""
    from ihpr_tpu_torch.utils.dirs import make_output_tree

    tree = make_output_tree(str(tmp_path / "run"))
    assert sorted(tree) == ["log", "model_dump", "result", "vis"]
    assert all(os.path.isdir(p) and os.path.dirname(p) == str(tmp_path / "run") for p in tree.values())
    assert make_output_tree(str(tmp_path / "run")) == tree  # idempotent


def test_resolve_rss_limit_mb():
    """None -> 80% of MemTotal (None without /proc); 0 or negative -> off;
    positive -> as given."""
    total = host_total_mb()
    assert resolve_rss_limit_mb(None) == (0.8 * total if total > 0 else None)
    assert resolve_rss_limit_mb(0) is None and resolve_rss_limit_mb(-5) is None
    assert resolve_rss_limit_mb(512) == 512.0
    assert host_rss_mb() > 0 and EX_TEMPFAIL == 75


# --- the graceful SIGTERM handler (tests/test_shutdown.py, on the port's copy) ----

_CHILD = r"""
import atexit, sys, time
from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

assert install_graceful_shutdown() is True
atexit.register(lambda: print("ATEXIT-RAN", flush=True))
try:
    print("READY", flush=True)
    while True:
        time.sleep(0.05)
finally:
    print("FINALLY-RAN", flush=True)
"""


def _sigterm(code):
    """Run ``code`` until it prints READY, send SIGTERM; (rc, output, s)."""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", line
        t0 = time.time()
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=30)[0]
        return proc.returncode, out, time.time() - t0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_port_sigterm_exits_cleanly_with_unwind():
    rc, out, _ = _sigterm(_CHILD)
    # 143 = 128 + SIGTERM through SystemExit, not a signal death (-15).
    assert rc == 143, (rc, out)
    assert "FINALLY-RAN" in out and "ATEXIT-RAN" in out and "exiting cleanly" in out


def test_port_install_refuses_foreign_handler():
    code = r"""
import signal
signal.signal(signal.SIGTERM, lambda *_: None)
from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown
assert install_graceful_shutdown() is False
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_port_install_refuses_non_main_thread():
    code = r"""
import signal, threading
from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown
result = {}
t = threading.Thread(target=lambda: result.setdefault("r", install_graceful_shutdown()))
t.start()
t.join()
assert result["r"] is False
assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.default_int_handler)
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_port_hard_exit_cap_when_teardown_hangs():
    code = r"""
import time
from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown
install_graceful_shutdown(hard_exit_s=1.0)
try:
    print("READY", flush=True)
    while True:
        time.sleep(0.05)
finally:
    time.sleep(3600)
"""
    rc, out, elapsed = _sigterm(code)
    assert rc == 143, (rc, out)
    assert elapsed < 15, elapsed
