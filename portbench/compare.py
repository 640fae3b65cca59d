"""The comparison that decides ``correct``: the program's first steps against
the plain reference's, from the same inputs.

Readings of a run: each step's loss; the first step's gradient norm of
each chunk, before the penalty; each parameter's first gradient, as the
optimizer took it, by its norm; each running statistic after the first
step, by the norm of its change; each parameter's change after the checked
steps, by its norm. The numbers:

* ``loss_gap``: the largest relative gap of a step's loss;
  ``loss0_gap`` the first step's alone (its forward, before any update);
* ``chunk_gap``: the largest relative gap of a chunk's gradient norm (a
  chunk missing on one side: infinite);
* ``grad_gap``, ``stats_gap``, ``change_gap``: the worst leaf's gap between
  the program's norm and the reference's, over the larger of that leaf's
  reference norm and the median leaf's (some gradients are all but zero).
  A parameter whose reference gradient is under a thousandth of the median
  leaf's moves by round-off alone and is left out of the change;
* ``grad_median_gap``, ``change_median_gap``: the median leaf's gap, steady
  where the worst leaf's is the round-off of a small leaf.

A cell's limits file names the numbers compared for it.
"""

from __future__ import annotations

import math
import statistics

import torch

from .reference.train import ReferenceTraining

NUMBERS = ("loss_gap", "loss0_gap", "chunk_gap", "grad_gap", "stats_gap", "change_gap",
           "grad_median_gap", "change_median_gap")
QUIET = 1e-3     # a leaf's gradient under this share of the median leaf's: not compared


def program_readings(program, steps: int) -> dict:
    """Drive ``program`` through its first ``steps`` steps (the window's own
    call) and read them."""
    losses = []
    for k in range(steps):
        metrics = program.step()
        losses.append(metrics["train_loss"])
        if k == 0:
            chunks = metrics["grad_norms_per_chunk"]
            grad, stats = program.first_gradient_norms(), program.stats_norms()
    return {"loss": losses, "chunks": chunks, "grad": grad, "stats": stats,
            "change": program.change_norms()}


def reference_readings(cell, images, labels, weights, seed, steps, precision="float32",
                       fault=None) -> dict:
    """The reference's readings of its first ``steps`` steps from the same
    inputs (``precision`` and ``fault`` for the controls), in float32, or in
    float64 where the cell's parameters are."""
    float64 = cell.traffic["recipe"].get("impl.dtype") == "float64"
    ref = ReferenceTraining(cell.config, cell.traffic["recipe"], images, labels, weights, seed,
                            precision, fault, torch.float64 if float64 else torch.float32)
    losses = []
    for k in range(steps):
        loss, g, norms = ref.step(k)
        losses.append(loss)
        if k == 0:
            chunks = norms
            grad = {n: float(t.double().norm()) for n, t in g.items()}
            stats = {n: float((s.double() - (1.0 if n.endswith("running_var") else 0.0)).norm())
                     for n, s in ref.stats.items()}
    with torch.no_grad():
        change = {n: float((p.double() - weights[n].double()).norm())
                  for n, p in ref.params.items()}
    return {"loss": losses, "chunks": chunks, "grad": grad, "stats": stats, "change": change}


def relative(ours: float, ref: float) -> float:
    return abs(ours - ref) / abs(ref) if math.isfinite(ours) else math.inf


def worst(values) -> tuple[float, str]:
    """The largest ``(gap, where)``; NaN counts as infinite."""
    return max(((math.inf if math.isnan(v) else v, w) for v, w in values),
               key=lambda vw: vw[0])


def leaf_gaps(ours: dict, ref: dict, names) -> list[tuple[float, str]]:
    """Each leaf's ``(gap of norms, leaf)``."""
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    return [(abs(ours.get(n, 0.0) - ref[n]) / max(ref[n], floor)
             if math.isfinite(ours.get(n, 0.0)) else math.inf, n) for n in names]


def leaf_gap(ours: dict, ref: dict, names) -> tuple[float, str]:
    """The worst leaf's gap of norms, and that leaf."""
    return worst(leaf_gaps(ours, ref, names))


def median_gap(ours: dict, ref: dict, names) -> tuple[float, str]:
    """The median leaf's gap of norms (of an even count the upper of the two
    middle ones), and that leaf; NaN counts as infinite."""
    values = sorted((math.inf if math.isnan(v) else v, w) for v, w in leaf_gaps(ours, ref, names))
    return values[len(values) // 2]


def gaps(ours: dict, ref: dict) -> dict:
    """``{number: (value, where)}`` of every number of :data:`NUMBERS`."""
    steps = [(relative(a, b), f"step {i}")
             for i, (a, b) in enumerate(zip(ours["loss"], ref["loss"]))]
    if len(ours["chunks"]) != len(ref["chunks"]):
        chunks = (math.inf, f"{len(ours['chunks'])} chunks, not {len(ref['chunks'])}")
    else:
        chunks = worst((relative(a, b), f"chunk {i}")
                       for i, (a, b) in enumerate(zip(ours["chunks"], ref["chunks"])))
    median_grad = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= QUIET * median_grad]
    return {"loss_gap": worst(steps), "loss0_gap": steps[0], "chunk_gap": chunks,
            "grad_gap": leaf_gap(ours["grad"], ref["grad"], ref["grad"]),
            "stats_gap": leaf_gap(ours["stats"], ref["stats"], ref["stats"]),
            "change_gap": leaf_gap(ours["change"], ref["change"], moving),
            "grad_median_gap": median_gap(ours["grad"], ref["grad"], ref["grad"]),
            "change_median_gap": median_gap(ours["change"], ref["change"], moving)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})`` over the numbers that
    ``limits`` holds."""
    checks = {k: {"value": numbers[k][0], "limit": limits[k]} for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
