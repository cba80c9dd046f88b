"""BENCHMARK.json against the rules its format keeps, and the files it names."""

import ast
import json
import re

import pytest

from benchmark.harness import cells, common
from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_KEYS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|channels")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names():
    assert set(SPEC) == KEYS["top"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    for c in SPEC["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH_KEYS.search(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == KEYS["cell"] and NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[kind]}) == len(SPEC[kind])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for w in SPEC["workloads"]:
        cell = cells.load(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    cell_names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cell_names):
            assert c in cell_names and c in e2e[m["moves"]].get("workloads", cell_names)
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"`{m['layer']}`" in perf for m in SPEC["per_layer"])


def test_files_are_found_by_name():
    for w in SPEC["workloads"]:
        cell = cells.load(w["name"], ROOT)
        assert cell.traffic["kind"] in ("train_resident", "serve_stream")
        assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"], ROOT))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_ports_config(config):
    """A configuration file sets the port's named config, changed only where
    ``reduced`` says."""
    import dataclasses

    from ihpr_tpu_torch.config import get_config

    sizes = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    assert sizes["reduced"] == entry["reduced"] and sizes["source"] == entry["source"]
    built, named = cells.port_config(sizes), get_config(sizes["port_config"])
    changed = {f"{s}.{f.name}" for s in ("model", "data", "optim", "eval")
               for f in dataclasses.fields(getattr(named, s))
               if getattr(getattr(built, s), f.name) != getattr(getattr(named, s), f.name)}
    allowed = {"{}.{}".format(*cells.CONFIG_FIELDS[k]) for k in entry["reduced"]}
    assert changed <= allowed
    assert sizes["joint_num"] == built.joint_num


def test_run_seconds_fit_the_check():
    n = 24
    total = (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(common.BANNED_MODULES), path
        if "reference" in path.parts:
            assert tops <= {"__future__", "contextlib", "typing", "torch", "numpy"}, (path, tops)


def test_banned_modules_compare_whole_top_level_names():
    assert common.banned_modules(["ihpr_tpu_torch", "ihpr_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert common.banned_modules(["ihpr_tpu.ops", "jax.numpy", "flax", "jaxlib"]) == ["flax", "ihpr_tpu", "jax",
                                                                                       "jaxlib"]
