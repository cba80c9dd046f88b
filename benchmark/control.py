"""The readings a cell's limits are set from, on the chip at the cell's own
sizes, in one process (the benchmark's runs do not run this):

- ``program``: sound runs of the program, one a seed (a short window each);
- ``control``: the reference put in the program's place in the
  configuration's ``control_precision`` (``reference/precision.py``),
  against the float32 reference, on the same inputs (and, for training, at
  the state a short window of the program left);
- each fault of ``--faults`` (``harness/faults.py``) planted in the program.

One JSON line of numbers a reading, to standard output and to ``--out``:

    python3 benchmark/control.py --workload r50_train_b128 --program 1,2,3 \\
        --control 7,8,9 --faults half_batch [--seconds 1] [--out F]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_train(cell, seed, device, quant, seconds=1.0):
    from benchmark.harness import traffic, weights
    from benchmark.harness import train as ht
    from benchmark.reference import train as rt

    sizes, t = cell.sizes, cell.traffic
    batches = traffic.train_ring(dict(t, ring=ht.FIRST_STEPS), sizes, seed, device)
    ref = rt.train_steps(sizes, weights.draw(sizes, seed, device), batches, t["steps_per_epoch"])
    low = rt.train_steps(sizes, weights.draw(sizes, seed, device), batches, t["steps_per_epoch"], quant=quant)
    names = rt.leaf_names(sizes)
    numbers = ht.compare(names, low["losses"], [low["grad_norms"][n] for n in names],
                         [low["change_norms"][n] for n in names], ref, low["coords"])
    del ref, low
    # The state a window of the program left: the control's loss there against the reference's.
    out = ht.run(cell, seed, seconds, None, device, time.perf_counter())
    end, batch = out["end_state"], out["end_batch"]
    numbers["window_loss_gap"] = ht.loss_gap(rt.loss_at(sizes, end, batch, quant), rt.loss_at(sizes, end, batch))
    return numbers


def control_serve(cell, seed, device, quant):
    import torch

    from benchmark.harness import common, traffic
    from benchmark.harness import serve as hs
    from benchmark.reference import serve as rs

    sizes, t = cell.sizes, cell.traffic
    frames = traffic.frames(t, seed, device)
    state = hs.serving_state(sizes, t, seed, device, frames)
    gen = traffic.requests(t, seed)
    reqs = [next(gen) for _ in range(t["check_requests"])]
    ref = rs.answer(sizes, state, frames, reqs)
    low = rs.answer(sizes, state, frames, reqs, quant=quant)
    del frames, state
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    numbers = {"coord_gap": hs.answers_gap(sizes, [list(r["coords"]) for r in low], ref)}
    numbers["people"] = float(sum(len(b) for _, b in reqs))
    common.sync(device)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="", help="seeds of sound program runs")
    ap.add_argument("--control", default="", help="seeds of the lower-precision control")
    ap.add_argument("--faults", default="", help="comma-separated names of harness/faults.py's FAULTS")
    ap.add_argument("--fault_seeds", default="", help="seeds of each fault (default: --control's)")
    ap.add_argument("--seconds", type=float, default=1.0, help="window of each program run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal at a small size")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells, faults, serve, train
    from benchmark.reference import precision

    cell = cells.load(args.workload, ROOT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    kind = cell.traffic["kind"]
    runner = {"train_resident": train.run, "serve_stream": serve.run}[kind]
    out = open(args.out, "a") if args.out else None

    def emit(reading, seed, numbers, t0):
        line = json.dumps({"cell": cell.name, "reading": reading, "seed": seed, **numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in _seeds(args.program):
        t0 = time.perf_counter()
        res = runner(cell, seed, args.seconds, None, device, t0)
        emit("program", seed, res["numbers"], t0)
    quant = getattr(precision, cell.sizes["control_precision"])
    for seed in _seeds(args.control):
        t0 = time.perf_counter()
        numbers = (control_train(cell, seed, device, quant, args.seconds) if kind == "train_resident"
                   else control_serve(cell, seed, device, quant))
        emit(f"control_{cell.sizes['control_precision']}", seed, numbers, t0)
    for name in [f for f in args.faults.split(",") if f]:
        for seed in _seeds(args.fault_seeds or args.control):
            t0 = time.perf_counter()
            with faults.FAULTS[name]():
                res = runner(cell, seed, args.seconds, None, device, t0)
                emit(name, seed, res["numbers"], t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
