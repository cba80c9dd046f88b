"""idle_share.serve: the share of the traced window in which the device ran
no kernel, copy or set (1 minus the union of their intervals over the
window). Moves ``serve_img_per_s``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
