"""``train_resident`` cells: the port's train step back to back on a ring of
distinct batches resident on the device.

Set-up builds one model (``build_pose_net(..., trainable=True)`` from the
benchmark's weights), its optimizer and schedule (``make_optimizer``) and the
step the Trainer runs between log points (``make_train_step(...,
lean=True)``), and drives that step through its first three updates on the
ring's first three batches, reading what the check needs as it goes: the
first update's coords (a forward hook on the head), each loss, each leaf's
first gradient from Adam's first moment after update 1 (``exp_avg = (1 -
b1) g``), and each leaf's change after update 3. The same step then runs
on the ring's next batches until its pace is steady
(``common.warm_until_steady``), and then the window: update after update,
each on the ring's next batch, until ``--seconds`` have passed, closed by
one synchronize. ``train_img_per_s`` is every image of every update in the
window over the window. One more update after the window, on the ring's
next batch, gives the program's loss at the state the window left.

Once the window is over and the program's state is freed, the reference
follows the same three updates from the same weights on the same batches,
and ``compare`` reads: the worst update's relative loss gap; the median
leaf's gap between the program's norm and the reference's (first gradient,
change), each over the larger of the reference's norm of that leaf and of
the median leaf; the worst leaf's; and the first update's coords against the
reference's (``coords_gap``). ``window_loss_gap`` is the relative gap of
the loss after the window from the reference's at the same state on the
same batch. A cell's limits file names the numbers that are compared;
PERF.md gives the readings behind each choice.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import torch

from benchmark.harness import common, traffic, weights
from benchmark.harness.cells import Cell, port_config
from benchmark.reference import train as ref_train

FIRST_STEPS = 3
# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone: their change is not compared.
NOUGHT_GRAD = 1e-3


def _norms(tensors) -> List[float]:
    return [float(n) for n in torch._foreach_norm([t.detach() for t in tensors])]


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], leaves) -> List[float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(reference.values())
    return [abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in leaves]


def run(cell: Cell, seed: int, seconds: float, tracer, device, setup_t0: float) -> Dict:
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    sizes, t = cell.sizes, cell.traffic
    cfg = port_config(sizes)
    ring = traffic.train_ring(t, sizes, seed, device)
    model = build_pose_net(cfg, device=device, trainable=True, state_dict=weights.draw(sizes, seed, device))
    opt, sched = make_optimizer(model, cfg, t["steps_per_epoch"])
    step = make_train_step(model, opt, cfg, lean=True, scheduler=sched)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    seen = []
    hook = model.head.register_forward_hook(lambda mod, args, out: seen.append(out.detach().clone()))
    losses = [step(ring[0])["loss"]]
    hook.remove()
    coords = seen[0]
    b1 = opt.param_groups[0]["betas"][0]
    moments = [opt.state[p]["exp_avg"] if "exp_avg" in opt.state[p] else torch.zeros_like(p) for p in params]
    grad_norms = [n / (1 - b1) for n in _norms(moments)]
    for k in range(1, FIRST_STEPS):
        losses.append(step(ring[k])["loss"])
    change_norms = _norms(torch._foreach_sub([p.detach() for p in params], start))
    del start, moments
    losses = [float(x) for x in losses]
    batch = sizes["batch_size"]
    done = FIRST_STEPS

    def warm_group():
        nonlocal done
        for _ in range(t["warmup_group"]):
            step(ring[done % len(ring)])
            done += 1

    warm_times = common.warm_until_steady(warm_group, device, t["warmup"])
    print(f"warm-up groups of {t['warmup_group']} updates (s): {[round(x, 4) for x in warm_times]}",
          file=sys.stderr)
    trace_from = t["trace_after_steps"]
    common.sync(device)
    setup_s = common.now() - setup_t0
    window_losses, n = [], 0
    t0 = common.now()
    while True:
        if tracer is not None and n == trace_from:
            tracer.start()
        window_losses.append(step(ring[(done + n) % len(ring)])["loss"])
        n += 1
        if tracer is not None and n == trace_from + t["trace_steps"]:
            tracer.stop()
        if common.now() - t0 >= seconds and (tracer is None or tracer.result is not None):
            break
    common.sync(device)
    window_s = common.now() - t0
    nonfinite = int((~torch.isfinite(torch.stack(window_losses))).sum())
    info = common.device_info(device)
    # The state the window left, and the program's loss there: one more
    # update through the window's own call, on the ring's next batch.
    end_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    end_batch = ring[(done + n) % len(ring)]
    end_loss = float(step(end_batch)["loss"])
    del model, opt, sched, step, params, window_losses
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_train.train_steps(sizes, weights.draw(sizes, seed, device), ring[:FIRST_STEPS], t["steps_per_epoch"])
    numbers = compare(names, losses, grad_norms, change_norms, ref, coords)
    numbers["window_loss_gap"] = loss_gap(end_loss, ref_train.loss_at(sizes, end_state, end_batch))
    numbers["nonfinite_losses"] = float(nonfinite)
    counters = {"steps": t["trace_steps"], "images": t["trace_steps"] * batch}
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": n, "failed": nonfinite,
        "e2e": {"train_img_per_s": n * batch / window_s},
        "numbers": numbers, "counters": counters, "device": info, "end_state": end_state, "end_batch": end_batch,
    }


def loss_gap(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)


def coords_gap(coords: torch.Tensor, ref: torch.Tensor) -> float:
    """rms(coords - ref) over rms(ref - its mean per axis): the first step's
    forward against the reference's, on the scale of what the network's
    output varies by."""
    ref = ref.to(torch.float64)
    spread = (ref - ref.mean(dim=(0, 1))).pow(2).mean().sqrt()
    return float((coords.to(ref) - ref).pow(2).mean().sqrt() / spread.clamp_min(1e-30))


def compare(names, losses, grad_norms, change_norms, ref, coords=None) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, the median
    leaf's gaps of the first gradient and of the change after the first
    steps (``leaf_gaps``; leaves whose reference gradient is nought to
    rounding are left out of the change), and the first step's
    ``coords_gap``. ``worst_*``: the worst leaf's, for the record."""
    rg, rc = ref["grad_norms"], ref["change_norms"]
    pg, pc = dict(zip(names, grad_norms)), dict(zip(names, change_norms))
    med = statistics.median(rg.values())
    moving = [n for n in rc if rg[n] >= NOUGHT_GRAD * med]
    grads, changes = leaf_gaps(pg, rg, rg), leaf_gaps(pc, rc, moving)
    out = {
        "loss_gap": max(loss_gap(a, b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": statistics.median(grads),
        "change_gap": statistics.median(changes),
        "worst_grad_gap": max(grads),
        "worst_change_gap": max(changes),
    }
    if coords is not None:
        out["coords_gap"] = coords_gap(coords, ref["coords"])
    return out
