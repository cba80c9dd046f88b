"""What every cell shares: seeds, the device, checks and the result line."""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# Top-level module names no run may hold once its window has closed: the JAX
# package and its framework. Compared whole, since the port's name begins with
# the JAX package's.
BANNED_MODULES = ("jax", "jaxlib", "flax", "ihpr_tpu")

# Streams of random numbers drawn from one --seed.
WEIGHTS, TRAIN_INPUTS, FRAMES, REQUESTS, SAMPLE = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number >= 0)."""
    hi, lo = np.random.SeedSequence([int(seed), stream]).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & (2**63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def banned_modules(names: Optional[Iterable[str]] = None) -> list:
    """The banned top-level names among ``names`` (default: ``sys.modules``)."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(BANNED_MODULES))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def warm_until_steady(work, device, spec: Dict) -> list:
    """Set-up's last warm-up: call ``work()`` (a fixed amount of the cell's
    own work), group after group, until the last ``spec["groups"]`` groups'
    times lie within ``spec["tolerance"]`` of the fastest of them, or
    ``spec["max_s"]`` have passed. Returns each group's seconds (host clock,
    between synchronizes)."""
    times, begin = [], now()
    while True:
        sync(device)
        t0 = now()
        work()
        sync(device)
        times.append(now() - t0)
        last = times[-spec["groups"]:]
        if len(times) >= spec["groups"] and max(last) <= (1 + spec["tolerance"]) * min(last):
            return times
        if now() - begin >= spec["max_s"]:
            return times


def device_info(device) -> Dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def finite(x) -> Optional[float]:
    x = float(x)
    return x if math.isfinite(x) else None


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, checks) over the numbers the cell's limits name: each at or
    under its limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = finite(numbers[name]) if name in numbers else None
        ok = ok and v is not None and v <= limit
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: Dict, checks: Dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result's line, ``checks`` last, on standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
