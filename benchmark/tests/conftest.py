"""Tests of the benchmark (``python -m pytest benchmark/tests -q``): the
manifest, the counts, each traffic mix at a tiny size through the port's CPU
path against the reference, the controls and planted faults. Tests marked
``cuda`` run on the card and skip elsewhere."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips with a reason on a host without one")


@pytest.fixture()
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


TINY_CONFIG = {"input_shape": [64, 64], "output_shape": [16, 16], "depth_dim": 16, "batch_size": 4}
# Warm-up on the CPU: two groups, whatever their times.
TINY_WARMUP = {"groups": 2, "tolerance": 100.0, "max_s": 5.0}
TINY_TRAIN = {"ring": 4, "trace_after_steps": 1, "trace_steps": 2, "warmup_group": 1, "warmup": TINY_WARMUP}
TINY_SERVE = {"frame_hw": [96, 160], "pool": 4, "frame_blobs": 6, "max_batch": 8,
              "people": {"min": 1, "max": 4, "alpha": 1.2}, "block": 8, "person_height_px": [20.0, 80.0],
              "warmup_group": 2, "warmup": TINY_WARMUP, "calibration_people": 8, "check_requests": 4,
              "trace_after_s": 0.3, "trace_seconds": 0.5}
# Limits of the tiny cells, between the CPU readings at the tests' seed (four
# threads) of the program (train: loss 0.0012, grad 0.012, change 0.014,
# coords 0.075, the loss after the window 0.001; serve: 0.039 voxel) and of
# its fp8 control (coords 0.152; 0.685 voxel) and the planted faults (half
# batch: loss 0.143, grad 0.46, the loss after the window 0.11; unchanged
# state: change 1; a 1-voxel alteration). The tiny cells' own, not the chip's.
TINY_TRAIN_LIMITS = {"loss_gap": 0.05, "grad_gap": 0.2, "change_gap": 0.5, "coords_gap": 0.11,
                     "window_loss_gap": 0.005, "nonfinite_losses": 0.0}
TINY_SERVE_LIMITS = {"coord_gap": 0.2, "missing_answers": 0.0}


def add_tiny_cells(root: Path) -> Path:
    """A copy of the benchmark under ``root`` with two tiny cells added by new
    files and manifest entries alone: ``tiny_train`` and ``tiny_serve``."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "h36m3d_r50.json").read_text())
    config.update(TINY_CONFIG, reduced=sorted(TINY_CONFIG))
    (bench / "configs" / "tiny_r50.json").write_text(json.dumps(config))
    train = json.loads((bench / "traffic" / "train_resident.json").read_text())
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps({**train, **TINY_TRAIN}))
    serve = json.loads((bench / "traffic" / "serve_stream.json").read_text())
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps({**serve, **TINY_SERVE}))
    (bench / "limits" / "tiny_train.json").write_text(json.dumps(TINY_TRAIN_LIMITS))
    (bench / "limits" / "tiny_serve.json").write_text(json.dumps(TINY_SERVE_LIMITS))
    spec["configs"].append({"name": "tiny_r50", "source": "https://arxiv.org/abs/1711.08229",
                            "file": "benchmark/configs/tiny_r50.json", "reduced": config["reduced"],
                            "why": "the flagship at 64x64, batch 4, for tests on the CPU"})
    spec["workloads"] += [
        {"name": "tiny_train", "config": "tiny_r50", "traffic": "tiny_train", "chips": 1, "why": "a test cell"},
        {"name": "tiny_serve", "config": "tiny_r50", "traffic": "tiny_serve", "chips": 1, "why": "a test cell"},
    ]
    for metric in spec["end_to_end"] + spec["per_layer"]:
        cells = metric.get("workloads")
        if cells is not None and any("train" in c for c in cells):
            cells.append("tiny_train")
        if cells is not None and any("serve" in c for c in cells):
            cells.append("tiny_serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return add_tiny_cells(tmp_path_factory.mktemp("tiny"))
