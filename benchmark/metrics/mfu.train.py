"""mfu.train: the model FLOPs of the traced train steps (3 x the forward's
convolutions, deconvolutions and final conv, counted from the
configuration's shapes; ``harness/flops.py``) over the traced window, as a
share of the card's dense bf16 peak. Moves ``train_img_per_s``."""

from benchmark.harness import flops


def read(run):
    if run.trace is None or "images" not in run.counters:
        return None
    return 100.0 * flops.train_flops(run.sizes) * run.counters["images"] / run.trace.window_s / run.peak[
        "bf16_flops_per_s"]
