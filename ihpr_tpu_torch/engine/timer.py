"""tic/toc timer with a running average, the port of
``ihpr_tpu/engine/timer.py`` (reference ``common/timer.py:Timer``): the
host clock around a phase of each iteration. The first 10 tocs are left
out of the average, as JAX's leave out its compile-dominated first
iterations; here they hold the kernels' first builds and cuDNN's plans.
For device time use CUDA events: a toc after an asynchronous launch
measures the enqueue, not the kernel."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
        self.warm_up = 0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        """Seconds since ``tic``; after the warm-up, the running average of
        the tocs counted so far (``average``) or this one."""
        self.diff = time.perf_counter() - self.start_time
        if self.warm_up < 10:
            self.warm_up += 1
            return self.diff
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def reset(self):
        self.__init__()
