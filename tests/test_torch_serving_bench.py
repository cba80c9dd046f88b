"""``python -m ihpr_tpu_torch.tools.serving_bench`` on the CPU at the tiny
config of test_torch_models (ResNet-18, 64x64 input, 16x16x16 heatmaps):
every phase runs and the JSON line carries the JAX tool's keys with finite
values; a failing phase fails the tool."""

import json
import math
import re
from pathlib import Path

import pytest
import torch

from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.engine import export
from ihpr_tpu_torch.tools import serving_bench
from test_torch_models import jax_tiny_cfg, to_port_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_keys() -> set:
    """The keys of the JSON line of the JAX package's tools/serving_bench.py."""
    src = (ROOT / "tools" / "serving_bench.py").read_text()
    body = src[src.index("out = {"):src.index("print(json.dumps(out))")]
    return set(re.findall(r'"(\w+)":', body))


def test_run_gives_the_jax_keys_with_finite_values(capsys):
    out = serving_bench.run(to_port_cfg(jax_tiny_cfg()), max_batch=4, n_chunks=2, device="cpu")
    keys = _jax_keys()
    assert len(keys) == 14 and keys <= set(out)
    for k in keys - {"flip_test"}:
        assert isinstance(out[k], (int, float)) and math.isfinite(out[k]) and out[k] > 0, k
    assert out["max_batch"] == 4 and out["chunks"] == 2 and out["flip_test"] is True
    assert out["device"].startswith("cpu")
    printed = capsys.readouterr().out
    for phase in ("request latency", "sustained serving", "chip-side", "native warp", "(control)",
                  "exported artifact", "pipelined full-path"):
        assert phase in printed, phase


def test_a_failing_phase_fails_the_tool(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("export failed")

    monkeypatch.setattr(export, "export_server", broken)
    with pytest.raises(RuntimeError, match="export failed"):
        serving_bench.run(to_port_cfg(jax_tiny_cfg()), max_batch=2, n_chunks=1, device="cpu")


def test_main_prints_the_json_line(monkeypatch, capsys):
    cfg = to_port_cfg(jax_tiny_cfg())
    monkeypatch.setattr(tconfig, "get_config", lambda name: cfg if name == "tiny" else None)
    monkeypatch.setattr("ihpr_tpu_torch.utils.shutdown.install_graceful_shutdown", lambda: None)
    assert serving_bench.main(["--config", "tiny", "--max_batch", "2", "--chunks", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _jax_keys() <= set(line) and line["max_batch"] == 2
