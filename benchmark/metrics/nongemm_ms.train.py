"""nongemm_ms.train: device ms a traced train step in kernels that are
neither convolutions nor GEMMs nor the program's own kernels (``_kernels``'s
classes): train-mode BatchNorm's statistics and apply, ReLU, adds, casts and
Adam. Moves ``train_img_per_s``."""

import re

from benchmark.metrics._kernels import CONV, GEMM, HAND

_OTHER = [re.compile(p) for p in CONV + GEMM + HAND]


def read(run):
    if run.trace is None or not run.counters.get("steps"):
        return None
    rest = sum(dur for name, _, dur in run.trace.kernels if not any(p.search(name) for p in _OTHER))
    return 1e3 * rest / run.counters["steps"]
