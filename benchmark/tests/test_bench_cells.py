"""Each traffic mix at a tiny size, through the port's CPU path (the plain
versions of its kernels) against the reference: cells added from new files
alone (``conftest.add_tiny_cells``). A sound run is correct; the
lower-precision control and each planted fault are not."""

import time

import pytest
import torch

from benchmark import control, run
from benchmark.harness import cells, common, faults
from benchmark.reference import precision

CPU = torch.device("cpu")
SEED = 2**33 + 12345


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _execute(root, name, trace=False, seconds=0.5):
    return run.execute(cells.load(name, root), SEED, seconds, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
def test_sound_run_is_correct(tiny_root, name):
    # Two seconds, so that a request is answered inside the window on a busy host.
    correct, result, checks = _execute(tiny_root, name, seconds=2.0)
    assert correct, checks
    cell = cells.load(name, tiny_root)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
def test_traced_run_reads_its_metrics(tiny_root, name):
    correct, result, checks = _execute(tiny_root, name, trace=True, seconds=1.0)
    assert correct, checks
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    names = {m["name"] for m in cells.load(name, tiny_root).per_layer}
    assert set(result["metrics"]) <= names


def test_result_line_has_checks_last(tiny_root, capsys):
    correct, result, checks = _execute(tiny_root, "tiny_serve")
    common.emit(result, checks)
    out, err = capsys.readouterr()
    line = __import__("json").loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"coord_gap", "missing_answers"}
    assert err.strip().splitlines()[-1].startswith("check missing_answers")


@pytest.mark.parametrize("name,fault", [("tiny_train", "unchanged_state"), ("tiny_train", "half_batch"),
                                        ("tiny_serve", "altered_answer"), ("tiny_serve", "half_dispatch")])
def test_planted_fault_is_not_correct(tiny_root, name, fault):
    with faults.FAULTS[fault]():
        correct, _, checks = _execute(tiny_root, name)
    assert not correct, checks


@pytest.mark.parametrize("name", ["tiny_train", "tiny_serve"])
def test_lower_precision_control_is_not_correct(tiny_root, name):
    cell = cells.load(name, tiny_root)
    fn = control.control_train if cell.traffic["kind"] == "train_resident" else control.control_serve
    numbers = fn(cell, SEED, CPU, getattr(precision, cell.sizes["control_precision"]))
    correct, checks = common.judge({k: v for k, v in numbers.items() if k in cell.limits}, cell.limits)
    assert not correct, checks
