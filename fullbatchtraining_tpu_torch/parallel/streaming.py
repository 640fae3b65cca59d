"""Host-resident epochs streamed to the device in segments
(``fullbatchtraining_tpu/parallel/mesh.py: stream_segments``, with the host
row gather of ``native/fbt_data.cpp: gather_rows``).

An epoch above ``impl.hbm_epoch_max_bytes`` (``data.pipeline.stream_plan``)
stays in host memory as :class:`HostRows`: the rows of a host array, a
memmap too, that a step reads, in the step's order, not yet gathered. The
consumer walks them with :func:`stream_segments`, a segment of whole blocks
at a time.

On CUDA two pinned host buffers and two device buffers hold a segment each.
While the compute stream works on segment ``k``, a host thread gathers the
rows of segment ``k + 1`` into the other pinned buffer (one
``torch.index_select(..., out=pinned)``, or a slice copy where the rows are
consecutive) and queues its copy to the other device buffer on a side
stream (``non_blocking``). The waits are explicit events:

* the host thread refills a pinned buffer only after the copy that last
  read it has completed;
* the copy into a device buffer waits for the compute stream's event
  recorded once the consumer had queued all its work on the segment that
  last used it;
* the compute stream waits for the copy's event before the segment is
  handed out.

So the host gathers only a segment at a time (the JAX package's staging
gathers a shuffled epoch whole, a second host copy of it), and the rows a
consumer sees are the rows a resident epoch holds, byte for byte. On the
CPU the segments are views of the host array (or its gather, where the
rows are not consecutive) and nothing is copied to a device.

``counts`` adds up the segments handed out and the bytes copied host to
device, for the smoke run.
"""

from __future__ import annotations

import dataclasses
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

counts = {"segments": 0, "h2d_bytes": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """A tensor sharing ``array``'s memory, a read-only memmap too (which
    the port only ever reads)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "not writable"
        return torch.from_numpy(array)


@dataclasses.dataclass(frozen=True)
class HostRows:
    """Rows of a host array not yet on the device: items ``source[index]``
    (``index`` None: ``source[:rows * per_row]`` in order), laid out
    ``[rows, per_row, *source.shape[1:]]``, that stream ``seg_rows`` rows
    at a time."""

    source: np.ndarray
    index: np.ndarray | None
    rows: int
    per_row: int
    seg_rows: int

    @property
    def shape(self) -> tuple:
        return (self.rows, self.per_row, *self.source.shape[1:])

    def gather(self, lo: int, hi: int, out: torch.Tensor | None = None) -> torch.Tensor:
        """Rows ``lo:hi`` as ``[hi - lo, per_row, ...]``: into ``out`` where
        given, else a view of the source where its items are consecutive
        (a gather where they are not)."""
        item = self.source.shape[1:]
        a, b = lo * self.per_row, hi * self.per_row
        idx = np.arange(a, b) if self.index is None else self.index[a:b]
        first = int(idx[0])
        if idx[-1] - first == len(idx) - 1 and (len(idx) == 1 or bool((np.diff(idx) == 1).all())):
            src = host_tensor(self.source[first:first + len(idx)])
            rows = src if out is None else out.view(len(idx), *item).copy_(src)
        else:
            dst = None if out is None else out.view(len(idx), *item)
            rows = torch.index_select(host_tensor(self.source), 0,
                                      torch.from_numpy(np.ascontiguousarray(idx, np.int64)),
                                      out=dst)
        return rows.view(hi - lo, self.per_row, *item)


def stream_segments(rows: HostRows, device) -> Iterator[tuple[int, torch.Tensor]]:
    """``(first row, rows on device)`` for each segment of ``rows.seg_rows``
    rows of ``rows`` in order. A segment's tensor is valid until the
    generator is resumed: work the consumer queued on it by then runs
    before its buffer is refilled."""
    device = torch.device(device)
    if device.type != "cuda":
        for start in range(0, rows.rows, rows.seg_rows):
            counts["segments"] += 1
            yield start, rows.gather(start, min(start + rows.seg_rows, rows.rows)).to(device)
        return
    yield from _stream_cuda(rows, device)


def _stream_cuda(rows: HostRows, device: torch.device):
    bounds = [(lo, min(lo + rows.seg_rows, rows.rows)) for lo in range(0, rows.rows, rows.seg_rows)]
    slots = min(2, len(bounds))
    shape = (min(rows.seg_rows, rows.rows), *rows.shape[1:])
    pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
    on_card = [torch.empty(shape, dtype=torch.uint8, device=device) for _ in range(slots)]
    # per slot: the last copy out of its pinned buffer, and the compute
    # stream's event once the consumer is done with its device buffer
    copied = [torch.cuda.Event() for _ in range(slots)]
    consumed: list = [None] * slots
    compute = torch.cuda.current_stream(device)
    copy_stream = torch.cuda.Stream(device)

    def load(k):
        """Host thread: gather segment ``k`` into its pinned buffer and queue
        the copy to its device buffer on the side stream."""
        slot, (lo, hi) = k % slots, bounds[k]
        copied[slot].synchronize()           # the previous copy out of this buffer is done
        host = rows.gather(lo, hi, out=pinned[slot][:hi - lo])
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            if consumed[slot] is not None:
                copy_stream.wait_event(consumed[slot])
            on_card[slot][:hi - lo].copy_(host, non_blocking=True)
            copied[slot].record(copy_stream)
        counts["h2d_bytes"] += host.numel() * host.element_size()

    pool = ThreadPoolExecutor(1, thread_name_prefix="stream_segments")
    try:
        pending = pool.submit(load, 0)
        for k, (lo, hi) in enumerate(bounds):
            pending.result()
            if k + 1 < len(bounds):
                # slot (k + 1) % 2 last held segment k - 1, whose consumed
                # event is recorded
                pending = pool.submit(load, k + 1)
            slot = k % slots
            compute.wait_event(copied[slot])
            counts["segments"] += 1
            yield lo, on_card[slot][:hi - lo]
            consumed[slot] = compute.record_event()
    finally:
        pool.shutdown(wait=True)
        copy_stream.synchronize()   # no copy still writes a buffer that is freed
