"""The gradient regularizer's share of the traced steps' device time, in %:
the kernels launched while the benchmark's span around the regularizer's
entry (``Trainer.reg_fn``) was open, on any host thread, over all device
time. Nothing to read where the recipe has no regularizer."""

from portbench.trace import REGULARIZER as SPAN


def read(ctx):
    t = ctx["trace"]
    if not t or not t["span_s"].get(SPAN) or t["device_s"] <= 0:
        return None
    return 100.0 * t["span_s"][SPAN] / t["device_s"]
