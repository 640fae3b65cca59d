"""The work of a step after its chunks, in % of the traced window's device
time: the device time of the kernels launched under the port's
``fbt.reduce_pass``, ``fbt.modify_gradient`` and ``fbt.update`` spans (the
pass's reduction, the norm bias, clip and noise, the SGD step and the EMA;
:func:`portbench.spans.reduce`), over all device time in the window. None,
not 0, where the trace holds no such span (a port that opens none)."""

from portbench.spans import MODIFY_GRADIENT, REDUCE_PASS, UPDATE

PHASES = (REDUCE_PASS, MODIFY_GRADIENT, UPDATE)


def read(ctx):
    s = (ctx["trace"] or {}).get("spans")
    if not s or not any(s["opened"].get(p) for p in PHASES) or s["device_s"] <= 0:
        return None
    return 100.0 * sum(s["span_s"][p] for p in PHASES) / s["device_s"]
