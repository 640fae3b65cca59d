"""Put a traced window's device time and idle gaps down to the program's own
spans: the ``record_function`` spans the port opens around the phases of a
full-batch step (``fullbatchtraining_tpu_torch/tracing.py``).

It reads the kineto events of the window that recorded host and device
together, the events :func:`.trace.reduce` reads, on the same clock. A span
owns the device activities whose launching host operation started while it
was open, on any thread: the backward of ``torch.autograd.grad`` launches
from the autograd engine's device thread. A span nested in another (the
regularizer in its chunk) counts towards both.

Idle gaps follow :func:`.trace.reduce`'s rule: a stretch of the window in
which nothing ran on the device goes to the launch of the activity that
ends it, here to the innermost program span open when that launch began,
and to ``OUTSIDE`` where none was open or no launch is known; the stretch
after the last activity is ``WINDOW_END``. The gaps partition the window's
idle time. That window records every host operation, which slows the
host's issue, so its idle share reads above the device-only window's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import WINDOW, _Index, is_device, merge

# the port's span names; the benchmark keeps its own copy, since it also
# runs a program that opens none of them. It reads every host span whose
# name starts with ``PREFIX``, these and any the port adds.
PREFIX = "fbt."
STAGE = "fbt.stage"
CHUNK = "fbt.chunk"
REGULARIZER = "fbt.regularizer"
REDUCE_PASS = "fbt.reduce_pass"
MODIFY_GRADIENT = "fbt.modify_gradient"
UPDATE = "fbt.update"
TO_HOST = "fbt.to_host"
SPANS = (STAGE, CHUNK, REGULARIZER, REDUCE_PASS, MODIFY_GRADIENT, UPDATE, TO_HOST)
OUTSIDE = "outside"
WINDOW_END = "window_end"


def _innermost(flat, starts, t):
    """The name of the latest-opened span of ``flat`` (sorted by start)
    that is open at ``t``, or None."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if flat[i][1] >= t:
            return flat[i][2]
    return None


def reduce(events) -> dict | None:
    """The program spans' summary of the window ``portbench.window`` in the
    kineto ``events``, or None where they hold no window. ``opened``
    counts each span's occurrences, ``span_s`` their device seconds (every
    span of ``SPANS``, 0 where none opened, and every other ``PREFIX`` span
    met) and ``idle_s`` the idle seconds put down to each span, ``OUTSIDE``
    and ``WINDOW_END``. Times in seconds."""
    ops, device, window, opened = {}, [], None, defaultdict(list)
    for e in events:
        name = e.name()
        if is_device(e):
            # a span's copy on the device's timeline is no activity
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.linked_correlation_id()))
            continue
        if e.linked_correlation_id():
            continue    # a runtime call: its correlation id is the runtime's own
        start = e.start_ns()
        if name == WINDOW:
            window = (start, e.end_ns())
        elif name.startswith(PREFIX):
            opened[name].append((start, e.end_ns()))
        elif e.correlation_id() not in ops or start < ops[e.correlation_id()]:
            # the profiler's own events inside an operation share its id
            ops[e.correlation_id()] = start
    if window is None:
        return None
    w0, w1 = window
    inside = sorted(d for d in device if d[1] > w0 and d[0] < w1)
    index = {name: _Index(intervals) for name, intervals in opened.items()}
    span_s = dict.fromkeys([*SPANS, *opened], 0.0)
    device_s = 0.0
    for start, end, linked in inside:
        seconds = (min(end, w1) - max(start, w0)) / 1e9
        device_s += seconds
        launched = ops.get(linked)
        if launched is None:
            continue
        for name, spans in index.items():
            if launched in spans:
                span_s[name] += seconds
    flat = sorted((s, e, name) for name, intervals in opened.items() for s, e in intervals)
    starts = [s for s, _, _ in flat]
    busy = merge((max(s, w0), min(e, w1)) for s, e, _ in inside)
    idle = defaultdict(float)
    firsts = [(s, linked) for s, _, linked in inside]
    cursor = w0
    for start, end in busy:
        if start > cursor:
            # the activity that ends this gap starts at ``start``
            launched = ops.get(firsts[bisect.bisect_left(firsts, (start, -1))][1])
            span = None if launched is None else _innermost(flat, starts, launched)
            idle[span or OUTSIDE] += (start - cursor) / 1e9
        cursor = max(cursor, end)
    if w1 > cursor:
        idle[WINDOW_END] += (w1 - cursor) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "device_s": device_s,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "opened": {name: len(intervals) for name, intervals in opened.items()},
            "span_s": span_s, "idle_s": dict(idle)}
