"""k2_roofline.train: the least time of the fused head's backward work
(``flops.head_backward`` at the train batch: the dfeat and dW products, db,
read once and written once) over the device time of the kernels that did it
(K2: the weight's transpose, dfeat, dW and the partials' reduction), in %.
Moves ``train_img_per_s``."""

import re

from benchmark.harness import flops
from benchmark.metrics._kernels import K2, K2_AFTER, TRANSPOSE


def read(run):
    if run.trace is None:
        return None
    ks = sorted(run.trace.kernels, key=lambda k: k[1])
    launches, seconds = 0, 0.0
    for i, (name, _, dur) in enumerate(ks):
        if not re.search(K2, name):
            continue
        launches += 1
        seconds += dur
        if i > 0 and re.search(TRANSPOSE, ks[i - 1][0]):
            seconds += ks[i - 1][2]
        for pattern, k in zip(K2_AFTER, ks[i + 1:i + 3]):
            if re.search(pattern, k[0]):
                seconds += k[2]
    if not launches:
        return None
    ops, nbytes = flops.head_backward(run.sizes, run.sizes["batch_size"])
    return 100.0 * launches * flops.bound_s(ops, nbytes, run.peak) / seconds
