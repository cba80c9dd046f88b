"""The Trainer's profile window on its exit paths, on the CPU.

- A trace export that fails inside a window (a full disk) while the RSS
  watchdog trips: ``train`` still leaves with ``SystemExit(75)``, the
  supervisor's relaunch code, and the watchdog's snapshot is on disk.
- A window that would end past the first epoch closes at that epoch's end,
  and its trace is named by the update count it closed at.

The tiny config and data of test_torch_checkpoint (ResNet-18, 64x64, batch
4, augmentation off).
"""

import json

import pytest
import torch

from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL
from test_torch_checkpoint import BATCH, _cfg, _trainer
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)


def test_failed_trace_export_keeps_exit_75_and_drains_the_snapshot(tmp_path, monkeypatch):
    def full_disk(self, path):
        raise OSError(28, "No space left on device", path)

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", full_disk)
    trainer = _trainer(_cfg(tmp_path / "run", end_epoch=2, snapshot_interval=10), samples=4 * BATCH,
                       rss_limit_mb=1.0, rss_check_interval_steps=1)
    try:
        with pytest.raises(SystemExit) as exc:
            trainer.train(end_epoch=2, profile_dir=str(tmp_path / "prof"), profile_steps=(0, 3))
    finally:
        trainer.close()
    assert exc.value.code == EX_TEMPFAIL
    assert trainer._profiler is None
    # The watchdog's mid-epoch snapshot was drained to disk before train() left.
    assert trainer.ckpt._epochs_on_disk() == [0]
    _, epoch, itr = trainer.ckpt.load_latest()
    assert (epoch, itr) == (0, 0)
    assert "closing the profile window failed" in (tmp_path / "run" / "log" / "train_logs.txt").read_text()


def test_window_past_the_first_epoch_closes_at_its_end(tmp_path):
    trainer = _trainer(_cfg(tmp_path / "run", end_epoch=2, snapshot_interval=10), samples=4 * BATCH,
                       rss_limit_mb=0)
    assert trainer.steps_per_epoch == 4
    open_at_epoch = {}
    epoch_fn = trainer.loader.epoch

    def recording(epoch, *args, **kw):
        open_at_epoch[epoch] = trainer._profiler is not None
        return epoch_fn(epoch, *args, **kw)

    trainer.loader.epoch = recording
    try:
        trainer.train(end_epoch=2, profile_dir=str(tmp_path / "prof"), profile_steps=(2, 25))
    finally:
        trainer.close()
    assert trainer.state.step == 8
    assert open_at_epoch == {0: False, 1: False}  # closed before epoch 1 began
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_step4.json"
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]


# --- the supervisor: ihpr_tpu_torch/tools/train_supervised.sh ------------------------------------------------------

# Imported at each child interpreter's start (``sitecustomize``, found first
# on its PYTHONPATH): a tiny config the train CLI can name, and, where the
# marker file is still missing, host RSS reported at 1 TB so that the
# watchdog trips, once per marker.
_SITE = """
import os
from ihpr_tpu_torch import config as c
c.CONFIGS["supervised_r18"] = c.Config(
    name="supervised_r18",
    model=c.ModelConfig(resnet_type=18, matmul_precision="highest", bn_mode="lean"),
    data=c.DataConfig(trainset=("Human36M",), input_shape=(64, 64), output_shape=(16, 16), depth_dim=16,
                      use_aug=False),
    optim=c.OptimConfig(batch_size_per_device=4, snapshot_interval=10),
)
marker = os.environ.get("PREEMPT_ONCE_MARKER")
if marker and not os.path.exists(marker):
    open(marker, "w").close()
    from ihpr_tpu_torch.utils import hostmem
    hostmem.host_rss_mb = lambda: 1e6
"""


def test_supervisor_relaunches_after_exit_75_and_ends_on_the_unbroken_state(tmp_path):
    """A CPU train whose watchdog trips once (mid-epoch, itr 0 of epoch 0)
    exits 75; the supervisor relaunches it with --continue, and it ends
    with exit 0 after that one relaunch, its last snapshot bitwise the
    unbroken run's."""
    import os
    import subprocess
    import sys

    from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
    from test_torch_checkpoint import _assert_same_state

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE)
    env = {**os.environ, "PYTHONPATH": f"{site}{os.pathsep}{repo}", "PYTHON": sys.executable,
           "OMP_NUM_THREADS": "2"}
    args = ["--config", "supervised_r18", "--synthetic", "--synthetic_size", "8", "--end_epoch", "2",
            "--device", "cpu", "--num_workers", "0", "--rss_limit_mb", "100000", "--rss_check_steps", "1"]
    script = os.path.join(repo, "ihpr_tpu_torch", "tools", "train_supervised.sh")
    runs = {
        name: subprocess.Popen(["bash", script, *args, "--output_dir", str(tmp_path / name)],
                               env={**env, "PREEMPT_ONCE_MARKER": str(tmp_path / f"{name}.tripped")}
                               if name == "supervised" else env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("supervised", "unbroken")
    }
    out = {name: proc.communicate(timeout=600) for name, proc in runs.items()}
    for name, proc in runs.items():
        assert proc.returncode == 0, (name, out[name][1][-3000:])
    assert out["supervised"][1].count("relaunching with --continue") == 1
    assert "preempt #1" in out["supervised"][1] and "preempt" not in out["unbroken"][1]
    log = (tmp_path / "supervised" / "log" / "train_logs.txt").read_text()
    assert "exiting 75" in log and "mid-epoch, itr 0" in log
    got, epoch, itr = CheckpointManager(str(tmp_path / "supervised")).load_latest()
    want, want_epoch, _ = CheckpointManager(str(tmp_path / "unbroken")).load_latest()
    assert (epoch, itr) == (want_epoch, -1) == (1, -1)
    _assert_same_state(got, want)
