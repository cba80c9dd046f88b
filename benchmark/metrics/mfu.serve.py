"""mfu.serve: the forward FLOPs of the people answered in the traced window,
twice each for the flip-test (padding not counted), over the traced
window, as a share of the card's dense bf16 peak. Moves ``serve_img_per_s``."""

from benchmark.harness import flops


def read(run):
    if run.trace is None or not run.counters.get("people_traced"):
        return None
    work = 2.0 * flops.forward_flops(run.sizes) * run.counters["people_traced"]
    return 100.0 * work / run.trace.window_s / run.peak["bf16_flops_per_s"]
