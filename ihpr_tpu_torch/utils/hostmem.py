"""Host-memory watchdog helpers (the port's copy of ``ihpr_tpu.utils.hostmem``).

The JAX package guards against a host-RSS leak of its TPU client, which
grows by one batch per host-to-device transfer (PARITY.md). The port's
CUDA host has no such leak. Here the watchdog is insurance: a run that
nears the host's memory, or a supervisor that wants a run to stop at a
step boundary, gets a snapshot and a clean exit with ``EX_TEMPFAIL``
instead of the OOM killer's SIGKILL, and ``--continue`` resumes it bit for
bit (deterministic data stream + full-state snapshots).
"""

from __future__ import annotations

from typing import Optional

#: sysexits.h EX_TEMPFAIL — "temporary failure, retry". A supervisor
#: relaunches with --continue on this code.
EX_TEMPFAIL = 75


def host_rss_mb() -> float:
    """This process's resident set size in MB (0.0 if /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def host_total_mb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def resolve_rss_limit_mb(limit: Optional[float]) -> Optional[float]:
    """None -> auto (80% of MemTotal; None if /proc is absent).
    0 or negative -> disabled (None). Positive -> as given."""
    if limit is None:
        total = host_total_mb()
        return 0.8 * total if total > 0 else None
    if limit <= 0:
        return None
    return float(limit)
