"""Graceful SIGTERM handling for the port's CLIs (the port's copy of
``ihpr_tpu.utils.shutdown``).

A job scheduler, a preempting supervisor or ``timeout N python ...`` stops
a run with SIGTERM, whose default action ends the process without
unwinding: no ``finally`` runs. The Trainer writes its snapshots in a
background thread, and ``Trainer.train``'s ``finally`` drains the one in
flight; a process that dies without unwinding can leave that snapshot
half written under its temporary name, so the newest restorable epoch is
an older one. This module turns SIGTERM into ``SystemExit(143)`` so that
``finally`` blocks and ``atexit`` handlers run, with a daemon hard-exit
timer so that a teardown which hangs still ends the process.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

_INSTALLED = False


def install_graceful_shutdown(hard_exit_s: float = 90.0) -> bool:
    """Install a SIGTERM handler that exits the interpreter cleanly.

    Call at the top of a CLI's ``main()``. Returns True if the handler is
    installed; False when it cannot or should not be (not the main thread,
    a non-default handler already owns SIGTERM, or no SIGTERM on this OS).

    ``hard_exit_s``: if the unwind itself hangs, a daemon timer
    ``os._exit(143)``s. Keep it under any ``timeout -k`` kill grace.
    """
    global _INSTALLED
    if _INSTALLED:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    if not hasattr(signal, "SIGTERM"):  # pragma: no cover - non-POSIX
        return False
    current = signal.getsignal(signal.SIGTERM)
    if current not in (signal.SIG_DFL, None):
        # Someone else (an embedding server, a test harness) owns SIGTERM.
        return False

    def _handler(signum, frame):  # pragma: no cover - exercised in a subprocess
        timer = threading.Timer(hard_exit_s, os._exit, args=(143,))
        timer.daemon = True
        timer.start()
        print(
            "ihpr_tpu_torch: SIGTERM — exiting cleanly so the snapshot in flight is "
            f"drained (hard exit in {hard_exit_s:.0f}s if teardown hangs)",
            file=sys.stderr,
            flush=True,
        )
        # 143 = 128 + SIGTERM, the code a default-action SIGTERM death gives.
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _handler)
    _INSTALLED = True
    return True
