"""Reduce a ``torch.profiler`` run to what the per-layer metrics read.

Every device activity (kernels, copies, fills; not the device's copy of a
span) counts towards the busy time: the union of their intervals inside
the window, on the profiler's clock. A kernel belongs to a layer where the host operation
that launched it (its linked correlation) started inside one of that
layer's operations on the same host thread: the convolutions are
``aten::convolution`` and ``aten::convolution_backward``, BatchNorm is the
port's ``BNTrain`` and ``BNTrainBackward``. A span of the benchmark's own
(``record_function``) owns the kernels whose launching operation started
while it was open, on any thread: the backward of ``torch.autograd.grad``
runs on the autograd engine's device thread.

An idle gap, a stretch of the window in which nothing ran on the device,
is put down to the host operation that launched the activity ending it:
the host was still issuing up to that launch.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
REGULARIZER = "portbench.regularizer"    # the benchmark's span on the regularizer's entry
LAYER_OPS = {"conv": ("aten::convolution", "aten::convolution_backward"),
             "bn": ("BNTrain", "BNTrainBackward")}
NAME_CHARS = 96


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


class _Index:
    """Membership of a time in a union of intervals."""

    def __init__(self, intervals):
        self.merged = merge(intervals)
        self.starts = [s for s, _ in self.merged]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.merged[i][1]


def is_device(event) -> bool:
    return event.device_type().name in ("CUDA", "PrivateUse1")


def is_launch(name: str) -> bool:
    """A kernel, as against a copy or a fill the runtime does itself."""
    return not name.startswith(("Memcpy", "Memset"))


def busy_s(events, start_ns: int, end_ns: int) -> float:
    """Seconds of ``[start_ns, end_ns]`` (the profiler's clock, time since
    the epoch) in which some device activity ran."""
    spans = merge((max(e.start_ns(), start_ns), min(e.end_ns(), end_ns)) for e in events
                  if is_device(e) and not e.is_user_annotation()
                  and e.end_ns() > start_ns and e.start_ns() < end_ns)
    return sum(e - s for s, e in spans) / 1e9


def reduce(events, spans=()) -> dict | None:
    """The summary of the kineto ``events`` of one traced window
    (``prof.profiler.kineto_results.events()``), or None where it holds no
    window span. Times in seconds. ``spans`` names the benchmark's own spans
    whose device time to report."""
    ops, device, window, span_times = {}, [], None, defaultdict(list)
    layer_times = {layer: defaultdict(list) for layer in LAYER_OPS}
    for e in events:
        name = e.name()
        if is_device(e):
            # a span's copy on the device's timeline is no activity
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id()))
            continue
        if e.linked_correlation_id():
            continue    # a runtime call: its correlation id is the runtime's own
        start, end, thread = e.start_ns(), e.end_ns(), e.start_thread_id()
        if name == WINDOW:
            window = (start, end)
        elif name in spans:
            span_times[name].append((start, end))
        for layer, names in LAYER_OPS.items():
            if name in names:
                layer_times[layer][thread].append((start, end))
        # the profiler's own events inside an operation share its id
        if e.correlation_id() not in ops or start < ops[e.correlation_id()][0]:
            ops[e.correlation_id()] = (start, thread, name)
    if window is None:
        return None
    w0, w1 = window
    inside = [d for d in device if d[1] > w0 and d[0] < w1]
    layer_index = {layer: {t: _Index(iv) for t, iv in by_thread.items()}
                   for layer, by_thread in layer_times.items()}
    span_index = {name: _Index(iv) for name, iv in span_times.items()}
    layer_s = dict.fromkeys(LAYER_OPS, 0.0)
    span_s = dict.fromkeys(spans, 0.0)
    by_name = defaultdict(float)
    launches = 0
    for start, end, name, linked in inside:
        seconds = (min(end, w1) - max(start, w0)) / 1e9
        by_name[name[:NAME_CHARS]] += seconds
        launches += is_launch(name)
        op = ops.get(linked)
        if op is None:
            continue
        for layer, index in layer_index.items():
            if op[1] in index and op[0] in index[op[1]]:
                layer_s[layer] += seconds
        for span, index in span_index.items():
            if op[0] in index:
                span_s[span] += seconds
    busy = merge((max(s, w0), min(e, w1)) for s, e, _, _ in inside)
    gaps = defaultdict(float)
    ends = [(s, linked) for s, _, _, linked in sorted(inside)]
    cursor = w0
    for start, end in busy:
        if start > cursor:
            # the activity that ends this gap starts at ``start``
            i = bisect.bisect_left(ends, (start, -1))
            op = ops.get(ends[i][1]) if i < len(ends) else None
            gaps[op[2] if op else "_no_host_operation_"] += (start - cursor) / 1e9
        cursor = max(cursor, end)
    if w1 > cursor:
        gaps["_window_end_"] += (w1 - cursor) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_s": sum(by_name.values()), "launches": launches,
            "layer_s": layer_s, "span_s": span_s,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
