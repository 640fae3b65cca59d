"""``portbench/trace.py`` on hand-made profiler events."""

from __future__ import annotations

import types

import pytest

from portbench import trace


class Event:
    def __init__(self, name, start, end, device=False, corr=0, linked=0, thread=1):
        self._v = (name, start, end, device, corr, linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return types.SimpleNamespace(name="CUDA" if self._v[3] else "CPU")

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[0].startswith("portbench.")


def events():
    """A 1000 ns window: a convolution (100-300) launching a kernel at
    150-250, a BN backward on another thread (400-500) launching one at
    450-600, an add launching one at 700-800 and a copy at 780-820; the
    regularizer's span (350-650) on the main thread."""
    return [
        Event(trace.WINDOW, 0, 1000, corr=1),
        Event(trace.WINDOW, 10, 990, device=True, corr=1),
        Event("Activity Buffer Request", 125, 126, corr=3),
        Event("aten::convolution", 100, 300, corr=2),
        Event("aten::cudnn_convolution", 120, 280, corr=3),
        Event("sm90_conv_kernel", 150, 250, device=True, linked=3),
        Event("portbench.regularizer", 350, 650, corr=4),
        Event("BNTrainBackward", 400, 500, corr=5, thread=2),
        Event("bwd_apply_kernel", 450, 600, device=True, linked=5),
        Event("aten::add", 690, 700, corr=6),
        Event("cudaLaunchKernel", 690, 695, corr=6, linked=6),
        Event("vectorized_add", 700, 800, device=True, linked=6),
        Event("Memcpy DtoH", 780, 820, device=True, linked=6),
        Event("outside", 1100, 1200, device=True, linked=6),
    ]


def test_busy_layers_spans_and_launches():
    s = trace.reduce(events(), spans=("portbench.regularizer",))
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((100 + 150 + 120) * 1e-9)
    assert s["device_s"] == pytest.approx((100 + 150 + 100 + 40) * 1e-9)
    assert s["layer_s"]["conv"] == pytest.approx(100e-9)
    assert s["layer_s"]["bn"] == pytest.approx(150e-9)
    assert s["span_s"]["portbench.regularizer"] == pytest.approx(150e-9)
    assert s["launches"] == 3      # the copy is not a launch; the last is outside


def test_idle_gaps_go_to_the_launching_host_operation():
    s = trace.reduce(events())
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::cudnn_convolution"] == pytest.approx(150e-9)   # 0-150
    assert gaps["BNTrainBackward"] == pytest.approx(200e-9)           # 250-450
    assert gaps["aten::add"] == pytest.approx(100e-9)                 # 600-700
    assert gaps["_window_end_"] == pytest.approx(180e-9)              # 820-1000
    assert sum(gaps.values()) == pytest.approx(1000e-9 - s["busy_s"])


def test_no_window_no_summary():
    assert trace.reduce([e for e in events() if e.name() != trace.WINDOW]) is None


def test_merge():
    assert trace.merge([(5, 6), (1, 3), (2, 4), (4, 4)]) == [[1, 4], [5, 6]]
