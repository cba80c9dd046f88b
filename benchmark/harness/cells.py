"""Cells by name: ``BENCHMARK.json`` names each cell's configuration and
traffic mix, and the harness finds their files, the cell's limits and its
per-layer metrics by those names alone:

- ``benchmark/configs/<config>.json`` (the file the manifest names): the
  configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  generator that reads it;
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: a reader with ``read(run)``.

A cell, configuration, mix or metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]

# Keys of a configuration file that set a field of the port's Config:
# key -> (Config section, field).
CONFIG_FIELDS = {
    "resnet_type": ("model", "resnet_type"),
    "num_deconv_layers": ("model", "num_deconv_layers"),
    "deconv_channels": ("model", "deconv_channels"),
    "head_final_init_std": ("model", "head_final_init_std"),
    "compute_dtype": ("model", "compute_dtype"),
    "matmul_precision": ("model", "matmul_precision"),
    "fp32_logits": ("model", "fp32_logits"),
    "bn_mode": ("model", "bn_mode"),
    "bn_momentum": ("model", "bn_momentum"),
    "bn_epsilon": ("model", "bn_epsilon"),
    "fused_1x1": ("model", "fused_1x1"),
    "fused_conv3": ("model", "fused_conv3"),
    "s2d_stem": ("model", "s2d_stem"),
    "block_remat": ("model", "block_remat"),
    "trainset": ("data", "trainset"),
    "testset": ("data", "testset"),
    "input_shape": ("data", "input_shape"),
    "output_shape": ("data", "output_shape"),
    "depth_dim": ("data", "depth_dim"),
    "bbox_3d_shape": ("data", "bbox_3d_shape"),
    "pixel_mean": ("data", "pixel_mean"),
    "pixel_std": ("data", "pixel_std"),
    "bbox_margin": ("data", "bbox_margin"),
    "batch_size": ("optim", "batch_size_per_device"),
    "lr": ("optim", "lr"),
    "lr_dec_epoch": ("optim", "lr_dec_epoch"),
    "lr_dec_factor": ("optim", "lr_dec_factor"),
    "weight_decay": ("optim", "weight_decay"),
    "grad_clip_norm": ("optim", "grad_clip_norm"),
    "flip_test": ("eval", "flip_test"),
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    sizes: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path


def manifest(root: Path = ROOT) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: Dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest, its files read."""
    root = Path(root)
    spec = manifest(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; the manifest has {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _in_cell(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _in_cell(m, name) and m["moves"] in reported]
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"], sizes=_json(root / config["file"]),
        traffic_name=w["traffic"], traffic=_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "benchmark" / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer,
        root=root,
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(sizes: Dict):
    """The port's Config for a configuration file: its named config
    (``port_config``) with every key of ``CONFIG_FIELDS`` the file gives."""
    from ihpr_tpu_torch.config import get_config

    cfg = get_config(sizes["port_config"])
    sections = {s: {} for s in ("model", "data", "optim", "eval")}
    for key, (section, field) in CONFIG_FIELDS.items():
        if key in sizes:
            value = sizes[key]
            sections[section][field] = tuple(value) if isinstance(value, list) else value
    return cfg.replace(**{s: dataclasses.replace(getattr(cfg, s), **kw) for s, kw in sections.items()})
