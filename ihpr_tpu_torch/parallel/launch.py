"""Start local ranks of a process group without torchrun.

    results = spawn(fn, 2, "gloo", arg1, arg2)

runs ``fn(rank, world, arg1, arg2)`` in ``world`` new processes (the spawn
start method), each a rank of the default process group over ``backend``.
The ranks meet through a ``FileStore`` in a temporary directory, never a
fixed port, so concurrent launches on one host cannot collide. ``fn`` must
be importable (a module-level function) and return something ``torch.save``
takes; ``spawn`` returns the ranks' results in rank order. A rank that
raises exits 1, one that raises ``SystemExit(n)`` exits n; ``spawn`` then
raises ``RanksFailed`` with every rank's exit code, after giving the others
``grace_s`` seconds to finish (a rank left waiting in a collective is
terminated).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ihpr_tpu_torch.parallel import mesh


class RanksFailed(RuntimeError):
    def __init__(self, exitcodes: List[Optional[int]]):
        super().__init__(f"ranks exited with codes {exitcodes}")
        self.exitcodes = exitcodes


def _rank_main(fn: Callable, rank: int, world: int, backend: str, workdir: str, args: tuple):
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    mesh.init_process_group("cpu", rank=rank, world=world, store=store, backend=backend)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable,
    world: int,
    backend: str,
    *args,
    workdir: Optional[str] = None,
    timeout_s: float = 900.0,
    grace_s: float = 30.0,
) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` local ranks; see the
    module docstring. ``workdir``: where the store and results go (a new
    temporary directory, removed after, by default)."""
    with tempfile.TemporaryDirectory(prefix="ihpr_ranks_", dir=workdir) as tmp:
        ctx = mp.get_context("spawn")
        procs = [
            ctx.Process(target=_rank_main, args=(fn, rank, world, backend, tmp, args), name=f"rank{rank}")
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        deadline, failed_at = time.monotonic() + timeout_s, None
        try:
            while any(p.is_alive() for p in procs):
                now = time.monotonic()
                if failed_at is None and any(p.exitcode for p in procs):
                    failed_at = now
                if now > deadline or (failed_at is not None and now > failed_at + grace_s):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RanksFailed(codes)
        return [
            torch.load(os.path.join(tmp, f"result_{rank}.pt"), weights_only=False)
            for rank in range(world)
        ]
