"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
stretch of the window (on the card its CUDA activity alone, so that the
host's ops are not slowed by recording them), reduced to what the
per-layer readers take.

- ``window_s``: the stretch's length on the host's clock, between two
  synchronizes, so every device operation of the stretch lies in it;
- ``kernels``: (name, start_s, seconds) of every kernel in it;
- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``gaps``: (seconds, label) of the ten longest intervals between device
  operations in which the device ran nothing, each labelled by the
  innermost host event (a CUDA runtime call, or on the CPU an op) that
  covers its middle; the idle time before the first and after the last
  operation of the stretch is one more entry.

The trace goes to a temporary file under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List, Tuple

import torch

from benchmark.harness import common

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
EDGES = "stretch edges (profiler start and stop)"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]
    gaps: List[Tuple[float, str]]

    def device_ops(self, top: int = 10) -> list:
        total = {}
        for name, _, dur in self.kernels:
            total[name] = total.get(name, 0.0) + dur
        return sorted(([short(n), s] for n, s in total.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        return [[label, s] for s, label in sorted(self.gaps, key=lambda g: -g[0])[:top]]


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).removeprefix("void ")[:120]


def reduce_events(events: list, window_s: float, top: int = 10) -> Trace:
    """A chrome trace's events over a stretch of ``window_s`` seconds -> ``Trace``."""
    dev, host, kernels = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in _DEVICE_CATS:
            dev.append((a, b))
            if cat == "kernel":
                kernels.append((e["name"], a * 1e-6, (b - a) * 1e-6))
        elif cat in _HOST_CATS:
            host.append((a, b, e["name"]))
    dev.sort()
    busy, gaps = 0.0, []
    edge = dev[0][0] if dev else 0.0
    for a, b in dev:
        if a > edge:
            gaps.append((a - edge, edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    span = (edge - dev[0][0]) * 1e-6 if dev else 0.0
    labelled = []
    for length, a, b in sorted(gaps, reverse=True)[:top]:
        mid = (a + b) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "host: no event"
        labelled.append((length * 1e-6, label))
    if window_s > span:
        labelled.append((window_s - span, EDGES))
    return Trace(window_s=window_s, busy_s=busy * 1e-6, kernels=kernels, gaps=labelled)


class Tracer:
    """``start()`` / ``stop()`` around a stretch of the window; ``result`` after.
    ``warm()`` in set-up pays the profiler's first start there."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = None
        self.result: Trace | None = None

    def _profile(self):
        on_card = torch.device(self.device).type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if on_card else torch.profiler.ProfilerActivity.CPU]
        return torch.profiler.profile(activities=acts)

    def warm(self):
        with self._profile():
            torch.ones(8, device=self.device).sum()
            common.sync(self.device)

    def start(self):
        common.sync(self.device)
        self.prof = self._profile()
        self.prof.start()
        self.t0 = common.now()

    def stop(self):
        common.sync(self.device)
        window_s = common.now() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.result = reduce_events(events, window_s)
