"""Named spans of the full-batch step's phases, for whatever ``torch.profiler``
records: ``impl.trace``'s :class:`~.training.training.StepTrace` or a caller's
own profiler.

:func:`span` opens a ``record_function`` span only while a profiler records;
otherwise it returns one shared no-op context, so a step that nobody traces
pays a flag check a span. The spans are host events of the profiler's own
trace, on the clock of its device activities; nothing here keeps a clock or
a trace of its own.

A full-batch step opens ``STAGE`` once, ``CHUNK`` once for each chunk of the
pass (its augmentation, forward, backward, squared norm, regularizer and
streaming mean), ``REGULARIZER`` inside it around the gradient regularizer,
``REDUCE_PASS``, ``MODIFY_GRADIENT`` and ``UPDATE`` (the SGD step and the
EMA) once each, and ``TO_HOST`` once, and once more for a validation.
"""

from __future__ import annotations

import contextlib

import torch

STAGE = "fbt.stage"
CHUNK = "fbt.chunk"
REGULARIZER = "fbt.regularizer"
REDUCE_PASS = "fbt.reduce_pass"
MODIFY_GRADIENT = "fbt.modify_gradient"
UPDATE = "fbt.update"
TO_HOST = "fbt.to_host"
SPANS = (STAGE, CHUNK, REGULARIZER, REDUCE_PASS, MODIFY_GRADIENT, UPDATE, TO_HOST)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` span while a profiler records, else a
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
