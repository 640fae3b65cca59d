"""Share of the traced window's wall time that the device idled outside the
chunks, in %: every idle gap of the window (:func:`portbench.spans.reduce`)
but those ended by launches under the port's ``fbt.chunk`` span, its
``fbt.regularizer`` included; that is, launches under ``fbt.stage``,
``fbt.reduce_pass``, ``fbt.modify_gradient``, ``fbt.update`` or
``fbt.to_host``, under no program span, and the window's tail, over the
window's wall time. That window records every host operation, which slows
the host's issue, so this share, ``chunk_idle_share`` and
``regularizer_idle_share`` add up to its idle share, somewhat above
``device_idle_share``'s device-only window. None, not 0, where the trace
holds no program span (a port that opens none)."""

from portbench.spans import CHUNK, REGULARIZER


def read(ctx):
    s = (ctx["trace"] or {}).get("spans")
    if not s or not s["opened"] or s["window_s"] <= 0:
        return None
    idle = s["idle_s"]
    edge = sum(idle.values()) - idle.get(CHUNK, 0.0) - idle.get(REGULARIZER, 0.0)
    return 100.0 * edge / s["window_s"]
