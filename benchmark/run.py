"""Run one cell of the benchmark of ``ihpr_tpu_torch`` once, on the CUDA card
of the machine it is started on, and print the result as the last line of
standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up and warm-up, then ``--seconds`` of the cell's traffic, then the
check of what the window produced against the plain reference
(``benchmark/reference``). ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` traces a steady stretch of the window with
``torch.profiler`` and reports its per-layer metrics. Exits 2, printing no
result, where there is no CUDA card or fewer than the cell asks for, and 3
where a module of JAX or of the JAX package was loaded by the end.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True, check=True).stdout.strip()


def execute(cell, seed: int, seconds: float, trace: bool, device, start: float):
    """Run ``cell`` once on ``device``: (correct, result, checks)."""
    from benchmark.harness import cells, common, peaks, serve, train
    from benchmark.harness.trace import Tracer

    runner = {"train_resident": train.run, "serve_stream": serve.run}[cell.traffic["kind"]]
    tracer = Tracer(device) if trace else None
    if tracer is not None:
        tracer.warm()
    out = runner(cell, seed, seconds, tracer, device, start)
    correct, checks = common.judge(out["numbers"], cell.limits)
    device_block = dict(out["device"])
    metrics = {}
    if trace:
        tr = tracer.result
        run = types.SimpleNamespace(trace=tr, counters=out["counters"], sizes=cell.sizes, traffic=cell.traffic,
                                    peak=peaks.peak(device_block["kind"]) if device_block["platform"] == "gpu"
                                    else peaks.PEAKS["H100"])
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_block.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_block}
    if trace:
        result["breakdown"] = {"device_ops": tracer.result.device_ops(), "idle_gaps": tracer.result.idle_gaps()}
    return correct, result, checks


def main(argv=None) -> int:
    args = parse_args(argv)
    # One process with few host threads: PyTorch's OpenMP pool and the native
    # warp's (a second OpenMP runtime) take four threads each, which sleep
    # rather than spin when idle. Eight spinning threads a pool held three of
    # the machine's eight cores and made the host-bound serving cell's rate
    # spread twice as wide (PERF.md).
    os.environ["OMP_NUM_THREADS"] = "4"
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    # The program's build and kernel caches stay inside the checkout, at fixed paths.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells, common

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    correct, result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), device, START)
    banned = common.banned_modules()
    if banned:
        print(f"modules of JAX or of the JAX package were loaded: {banned}", file=sys.stderr)
        return 3
    print(f"{args.workload} seed {args.seed}: {card}; correct {correct}", file=sys.stderr)
    common.emit({**result, "card": card}, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
