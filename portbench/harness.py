"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison with the reference.

Set-up builds the port's training step and drives it from the seed through
its first ``check_steps`` steps, whose readings the comparison takes; that
same object then runs the window. The window runs whole steps until
``seconds`` have passed: ``images_per_s`` is every image of those steps over
the time from the first step's start to the last step's end, which waits
for the device. With ``trace`` the traced steps follow the window under
``torch.profiler`` (:func:`traced_steps`), and the per-layer metrics read
both, with the cell and its work (``ctx``: ``cell``, ``work``, ``window``,
``trace``). The reference runs last, after the peak memory was read and the
program's state freed. The result's ``setup_parts`` split ``setup_s`` at
the process's age when the run began (imports and the look for a card),
when the program was built and when its checked steps were done.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from . import compare, inputs, spans, trace
from .cells import reader
from .program import Program
from .work import step_work


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(program, seconds: float) -> dict:
    """Whole steps until ``seconds`` have passed."""
    losses, ends = [], []
    start = time.perf_counter()
    while True:
        losses.append(program.step()["train_loss"])
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds:
            break
    return {"steps": len(losses), "seconds": ends[-1],
            "failed": sum(not math.isfinite(x) for x in losses),
            "step_s": [b - a for a, b in zip([0.0] + ends, ends)]}


def traced_steps(program, steps: int) -> dict | None:
    """``steps`` whole steps traced twice. First the device's activity alone:
    ``busy_s``, the union of its intervals inside that window, and
    ``window_s``, the window's wall time, both of this one window (recording
    every host operation as well slows the host's issue by half or more,
    and the card would idle behind the profiler). Then host and device
    together, the regularizer's entry wrapped in a span of its own, reduced
    by :func:`.trace.reduce` for the layers' device time and the breakdown,
    and by :func:`.spans.reduce` for the program's own spans
    (``summary["spans"]``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = program.device.type == "cuda"
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=device_only) as prof:
        start = time.time_ns()
        for _ in range(steps):
            program.step()
        end = time.time_ns()
    busy = trace.busy_s(prof.profiler.kineto_results.events(), start, end)

    trainer = program.trainer
    reg_fn = trainer.reg_fn
    if reg_fn is not None:
        def spanned(*args, **kwargs):
            with record_function(trace.REGULARIZER):
                return reg_fn(*args, **kwargs)
        trainer.reg_fn = spanned
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                for _ in range(steps):
                    program.step()
    finally:
        trainer.reg_fn = reg_fn
    events = prof.profiler.kineto_results.events()
    summary = trace.reduce(events, spans=(trace.REGULARIZER,) if reg_fn is not None else ())
    if summary is not None:
        summary.update(steps=steps, busy_s=busy, window_s=(end - start) / 1e9,
                       spans=spans.reduce(events))
    return summary


def run_cell(cell, seed: int, seconds: float, traced: bool, device, process_age) -> dict:
    """The result line of one run (``process_age()``: seconds since the
    process started)."""
    device = torch.device(device)
    recipe, traffic = cell.traffic["recipe"], cell.traffic
    parts = {"start": process_age()}
    work = step_work(cell.config, recipe)
    program = Program(cell, seed, device)
    sync(device)
    parts["built"] = process_age()
    ours = compare.program_readings(program, int(traffic["check_steps"]))
    sync(device)
    setup_s = parts["checked"] = process_age()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timed = window(program, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = traced_steps(program, int(traffic["trace_steps"])) if traced else None

    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    images, labels = inputs.images_and_labels(cell.config, seed, device)
    weights = inputs.weights(cell.config, seed, device)
    ref = compare.reference_readings(cell, images, labels, weights, seed,
                                     int(traffic["check_steps"]))
    numbers = compare.gaps(ours, ref)
    correct, checks = compare.judge(numbers, cell.limits)

    if traced:
        ctx = {"cell": cell, "work": work, "window": timed, "trace": summary}
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"images_per_s": work["images"] * timed["steps"] / timed["seconds"],
                  "peak_memory_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and timed["failed"] == 0), "attempted": timed["steps"],
              "failed": timed["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_parts"] = parts
    result["step_s"] = timed["step_s"]
    result["readings"] = {k: {"value": v, "where": w} for k, (v, w) in numbers.items()}
    result["checks"] = checks
    return result
