"""``portbench/spans.py`` and the metrics that read it, on hand-made
profiler events."""

from __future__ import annotations

import pytest

from portbench import cells, spans, trace
from portbench.tests.test_portbench_trace import Event as TraceEvent

READERS = ("chunk_idle_share", "regularizer_idle_share", "step_edge_idle_share",
           "update_share")


class Event(TraceEvent):
    def is_user_annotation(self):
        return self.name().startswith(spans.PREFIX) or super().is_user_annotation()


def program_spans():
    """The port's spans on the host (thread 1) and their copies on the
    device's timeline: a stage, a chunk with its regularizer, the pass's
    reduction, the update and the copy to the host."""
    host = [(spans.STAGE, 0, 50), (spans.CHUNK, 50, 600), (spans.REGULARIZER, 300, 550),
            (spans.REDUCE_PASS, 600, 700), (spans.UPDATE, 700, 800), (spans.TO_HOST, 800, 950)]
    return ([Event(name, s, e, corr=100 + i) for i, (name, s, e) in enumerate(host)]
            + [Event(name, s + 5, e + 5, device=True, corr=100 + i)
               for i, (name, s, e) in enumerate(host)])


def work():
    """A 1000 ns window; each host operation launches one activity: a copy
    from the stage (launched at 20, runs 60-100), a convolution from the
    chunk (120, 150-250), a BN backward on the autograd thread inside the
    regularizer (320, 330-450), a multiply from the chunk after it (560,
    580-620), an add from the reduction (650, 660-700), a subtraction from
    the update (720, 730-780) and a cat under no span (960, 970-990)."""
    ops = [("aten::copy_", 20, 60, 100, 1), ("aten::convolution", 120, 150, 250, 1),
           ("BNTrainBackward", 320, 330, 450, 2), ("aten::mul", 560, 580, 620, 1),
           ("aten::add", 650, 660, 700, 1), ("aten::_foreach_sub", 720, 730, 780, 1),
           ("aten::cat", 960, 970, 990, 1)]
    out = [Event(trace.WINDOW, 0, 1000, corr=1), Event(trace.WINDOW, 10, 990, device=True, corr=1)]
    for i, (name, launch, start, end, thread) in enumerate(ops):
        corr = 10 + i
        out += [Event(name, launch, launch + 8, corr=corr, thread=thread),
                Event("cudaLaunchKernel", launch + 2, launch + 6, corr=corr, linked=corr,
                      thread=thread),
                Event(f"kernel_{name}", start, end, device=True, linked=corr)]
    return out


def ctx(events):
    summary = trace.reduce(events)
    summary["spans"] = spans.reduce(events)
    return {"trace": summary}


def read(name, context):
    return cells.reader(name)(context)


def test_device_time_goes_to_every_span_open_at_the_launch():
    s = spans.reduce(work() + program_spans())
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["device_s"] == pytest.approx(410e-9) == pytest.approx(s["busy_s"])
    assert s["opened"] == {name: 1 for name in spans.SPANS
                           if name != spans.MODIFY_GRADIENT}
    expected = {spans.STAGE: 40, spans.CHUNK: 100 + 120 + 40, spans.REGULARIZER: 120,
                spans.REDUCE_PASS: 40, spans.MODIFY_GRADIENT: 0, spans.UPDATE: 50,
                spans.TO_HOST: 0}
    assert s["span_s"] == pytest.approx({k: v * 1e-9 for k, v in expected.items()})


def test_a_gap_goes_to_the_innermost_span_open_at_the_launch():
    s = spans.reduce(work() + program_spans())
    expected = {spans.STAGE: 60, spans.CHUNK: 50 + 130,
                spans.REGULARIZER: 80,        # launched on the autograd thread
                spans.REDUCE_PASS: 40, spans.UPDATE: 30, spans.OUTSIDE: 190,
                spans.WINDOW_END: 10}
    assert s["idle_s"] == pytest.approx({k: v * 1e-9 for k, v in expected.items()})


def test_the_idle_shares_partition_the_window_idle():
    c = ctx(work() + program_spans())
    values = {name: read(name, c) for name in READERS}
    assert values["chunk_idle_share"] == pytest.approx(18.0)
    assert values["regularizer_idle_share"] == pytest.approx(8.0)
    assert values["step_edge_idle_share"] == pytest.approx(33.0)
    idle = 100.0 * (1.0 - c["trace"]["spans"]["busy_s"] / c["trace"]["spans"]["window_s"])
    assert (values["chunk_idle_share"] + values["regularizer_idle_share"]
            + values["step_edge_idle_share"]) == pytest.approx(idle)


def test_update_share_sums_its_three_spans():
    c = ctx(work() + program_spans())
    s = c["trace"]["spans"]["span_s"]
    three = s[spans.REDUCE_PASS] + s[spans.MODIFY_GRADIENT] + s[spans.UPDATE]
    assert read("update_share", c) == pytest.approx(100.0 * three / (410e-9))
    assert read("update_share", c) == pytest.approx(100.0 * 90 / 410)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_program_spans(name):
    assert read(name, ctx(work())) is None                  # a port without the spans
    assert read(name, {"trace": trace.reduce(work())}) is None   # a summary without them
    assert read(name, {"trace": None}) is None


def test_no_regularizer_span_no_regularizer_share():
    events = [e for e in work() + program_spans() if e.name() != spans.REGULARIZER]
    c = ctx(events)
    assert read("regularizer_idle_share", c) is None
    assert read("chunk_idle_share", c) == pytest.approx(26.0)


def test_trace_reduce_ignores_the_program_spans():
    assert trace.reduce(work() + program_spans()) == trace.reduce(work())


def test_no_window_no_summary():
    assert spans.reduce([e for e in work() if e.name() != trace.WINDOW]) is None


def test_the_names_are_the_ports():
    from fullbatchtraining_tpu_torch import tracing

    assert spans.SPANS == tracing.SPANS


def test_a_span_the_benchmark_does_not_know_is_read():
    """A later span of the port (``fbt.extra``, around the update's launch
    at 720) gets its device time and the idle gap its launch ends; the
    seven known spans stay, ``fbt.modify_gradient`` at 0."""
    extra = [Event("fbt.extra", 715, 790, corr=200), Event("fbt.extra", 720, 795, device=True,
                                                           corr=200)]
    s = spans.reduce(work() + program_spans() + extra)
    assert s["opened"]["fbt.extra"] == 1
    assert s["span_s"]["fbt.extra"] == pytest.approx(50e-9)
    assert s["idle_s"]["fbt.extra"] == pytest.approx(30e-9)     # innermost at the launch
    assert spans.UPDATE not in s["idle_s"]
    assert s["span_s"][spans.UPDATE] == pytest.approx(50e-9)
    assert set(spans.SPANS) < set(s["span_s"]) and s["span_s"][spans.MODIFY_GRADIENT] == 0.0
    assert s == spans.reduce(extra + program_spans() + work())


def test_the_harness_hands_the_readers_the_spans(monkeypatch):
    """``traced_steps`` reduces the same events for the trace and the spans."""
    from portbench import harness
    from portbench.tests.test_portbench_runs import run
    from portbench.tests.tiny import WORKLOADS, tiny

    seen, reduced = [], []
    for module in (spans, trace):
        def wrapped(events, *args, _reduce=module.reduce, **kwargs):
            seen.append(events)
            reduced.append(_reduce(events, *args, **kwargs))
            return reduced[-1]
        monkeypatch.setattr(module, "reduce", wrapped)
    result = run(tiny(WORKLOADS[0], float64=True), traced=True)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert reduced[0]["spans"] is reduced[1]
    assert result["correct"]
