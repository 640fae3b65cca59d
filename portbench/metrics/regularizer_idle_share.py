"""Share of the traced window's wall time that the device idled while the
host issued the gradient regularizer, in %: the idle gaps ended by launches
under the port's ``fbt.regularizer`` span (:func:`portbench.spans.reduce`),
over the window's wall time. That window records every host operation,
which slows the host's issue, so this share, ``chunk_idle_share`` and
``step_edge_idle_share`` add up to its idle share, somewhat above
``device_idle_share``'s device-only window. None, not 0, where the trace
holds no such span: a recipe without a regularizer, or a port that opens
none."""

from portbench.spans import REGULARIZER


def read(ctx):
    s = (ctx["trace"] or {}).get("spans")
    if not s or not s["opened"].get(REGULARIZER) or s["window_s"] <= 0:
        return None
    return 100.0 * s["idle_s"].get(REGULARIZER, 0.0) / s["window_s"]
