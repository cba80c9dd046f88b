"""k1_roofline.serve: the least time of the fused head's forward work
(``flops.head_forward`` at the dispatch's images: the 2 x max_batch crops
and mirrors the kernel is handed, padding included) over the device time of
the kernels that did it (K1 and the weight's transpose before it), in %.
Moves ``serve_img_per_s``."""

import re

from benchmark.harness import flops
from benchmark.metrics._kernels import K1, TRANSPOSE


def read(run):
    if run.trace is None:
        return None
    ks = sorted(run.trace.kernels, key=lambda k: k[1])
    launches, seconds = 0, 0.0
    for i, (name, _, dur) in enumerate(ks):
        if re.search(K1, name):
            launches += 1
            seconds += dur
            if i > 0 and re.search(TRANSPOSE, ks[i - 1][0]):
                seconds += ks[i - 1][2]
    if not launches:
        return None
    ops, nbytes = flops.head_forward(run.sizes, run.counters["dispatch_images"])
    return 100.0 * launches * flops.bound_s(ops, nbytes, run.peak) / seconds
