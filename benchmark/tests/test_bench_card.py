"""The cells at their own sizes on the card (``-m cuda``; they skip
elsewhere): a run through ``benchmark/run.py`` prints a correct result line
with every key the format needs, and the lower-precision control and each planted
fault at the cell's size are not correct on three seeds."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import control
from benchmark.harness import cells, common, faults, serve, train
from benchmark.reference import precision
from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
FAULTS = {"train_resident": ("unchanged_state", "half_batch"), "serve_stream": ("altered_answer", "half_dispatch")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_a_correct_result(cuda, name, trace):
    # The manifest's window: a traced run's stretch starts seconds into it.
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(SEEDS[0]),
                           "--seconds", str(SPEC["run_seconds"]), "--trace", str(trace)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line) and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name):
    cell = cells.load(name, ROOT)
    fn = control.control_train if cell.traffic["kind"] == "train_resident" else control.control_serve
    quant = getattr(precision, cell.sizes["control_precision"])
    for seed in SEEDS:
        numbers = fn(cell, seed, cuda, quant)
        correct, checks = common.judge({k: v for k, v in numbers.items() if k in cell.limits}, cell.limits)
        assert not correct, (seed, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", [(w["name"], f) for w in SPEC["workloads"]
                                        for f in FAULTS[cells.load(w["name"], ROOT).traffic["kind"]]])
def test_planted_fault_is_not_correct(cuda, name, fault):
    cell = cells.load(name, ROOT)
    runner = train.run if cell.traffic["kind"] == "train_resident" else serve.run
    for seed in SEEDS:
        with faults.FAULTS[fault]():
            out = runner(cell, seed, 1.0, None, cuda, time.perf_counter())
        correct, checks = common.judge(out["numbers"], cell.limits)
        assert not correct, (seed, checks)
