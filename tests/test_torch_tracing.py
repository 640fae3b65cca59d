"""The spans of :mod:`fullbatchtraining_tpu_torch.tracing` in a full-batch
step.

``hyp=gradreg`` on ResNet-18 (width 4), 16 images in one block of two
chunks of 8, two steps, each followed by a validation. Without a profiler
:func:`~fullbatchtraining_tpu_torch.tracing.span` is one shared no-op, and
the run is bitwise the run with no spans at all, as is the run under
``torch.profiler``. Under the profiler each span is recorded as often as
the step opens it, ``fbt.regularizer`` inside ``fbt.chunk``, and every span
on the wall clock (time since the epoch) that the benchmark's window and
``portbench.trace.busy_s`` use.
"""

import collections
import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fullbatchtraining_tpu_torch import tracing
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import train, training

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

BASE = ["model=resnet18", "model.width=4", "hyp=gradreg", "data.size=16",
        "data.path=/tmp/__torch_nodata__", "data.batch_size=16", "hyp.sub_batch=8",
        "hyp.steps=2", "hyp.warmup=0", "impl.validate_every_nth_step=1", "seed=0"]
STEPS, CHUNKS = 2, 2
COUNTS = {tracing.STAGE: STEPS, tracing.CHUNK: STEPS * CHUNKS,
          tracing.REGULARIZER: STEPS * CHUNKS, tracing.REDUCE_PASS: STEPS,
          tracing.MODIFY_GRADIENT: STEPS, tracing.UPDATE: STEPS,
          tracing.TO_HOST: 2 * STEPS}   # a step's metrics and its validation's


def _setup(config_dir):
    cfg = load_config(config_dir, overrides=BASE)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
    return model, bundle, cfg


def _result(state, stats):
    return state.model.state_dict(), {k: v for k, v in stats.items() if k != "train_time"}


@pytest.fixture(scope="module")
def traced(config_dir):
    """Two steps under ``torch.profiler``: ``(params and running stats,
    stats, the spans' kineto events, wall clock before, after)``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, bundle, cfg = _setup(config_dir)
        before = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            result = _result(*train(model, bundle, cfg, device="cpu"))
        after = time.time_ns()
    finally:
        torch.set_num_threads(threads)
    spans = [e for e in prof.profiler.kineto_results.events() if e.name() in tracing.SPANS]
    return (*result, spans, before, after)


def test_off_span_is_a_shared_no_op_and_changes_nothing(config_dir, traced, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span(tracing.CHUNK) is tracing.span(tracing.UPDATE)
    assert isinstance(tracing.span(tracing.STAGE), contextlib.nullcontext)
    ours, stats = _result(*train(*_setup(config_dir), device="cpu"))
    monkeypatch.setattr(training, "span", lambda name: contextlib.nullcontext())
    ref, ref_stats = _result(*train(*_setup(config_dir), device="cpu"))
    for state, st in ((ours, stats), traced[:2]):
        assert [k for k in ref if not torch.equal(state[k], ref[k])] == []
        assert st == ref_stats


def test_profiler_records_each_span_as_often_as_a_step_opens_it(traced):
    assert collections.Counter(e.name() for e in traced[2]) == COUNTS


def test_regularizer_lies_inside_its_chunk(traced):
    spans = traced[2]
    chunks = [e for e in spans if e.name() == tracing.CHUNK]
    for reg in (e for e in spans if e.name() == tracing.REGULARIZER):
        assert [c for c in chunks if c.start_thread_id() == reg.start_thread_id()
                and c.start_ns() <= reg.start_ns() and reg.end_ns() <= c.end_ns()]


def test_spans_are_on_the_wall_clock(traced):
    _, _, spans, before, after = traced
    assert all(before <= e.start_ns() <= e.end_ns() <= after for e in spans)
