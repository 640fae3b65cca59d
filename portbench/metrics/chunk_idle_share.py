"""Share of the traced window's wall time that the device idled while the
host issued a chunk's own work, in %: the idle gaps ended by launches under
the port's ``fbt.chunk`` span but not under ``fbt.regularizer``
(:func:`portbench.spans.reduce`), over the window's wall time. That window
records every host operation, which slows the host's issue, so this share,
``regularizer_idle_share`` and ``step_edge_idle_share`` add up to its idle
share, somewhat above ``device_idle_share``'s device-only window. None, not
0, where the trace holds no program span (a port that opens none)."""

from portbench.spans import CHUNK


def read(ctx):
    s = (ctx["trace"] or {}).get("spans")
    if not s or not s["opened"].get(CHUNK) or s["window_s"] <= 0:
        return None
    return 100.0 * s["idle_s"].get(CHUNK, 0.0) / s["window_s"]
