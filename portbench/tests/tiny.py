"""Cells of the benchmark cut to a size the CPU runs in seconds: the model
family's own cut (its ``tiny``), ``images`` images in two blocks of two
chunks, float64 where asked (the reference then runs in float64 too)."""

from __future__ import annotations

import copy

from portbench import cells

SEED = 2**31 + 17          # a seed past 32 signed bits, as a run may be given
WORKLOADS = [w["name"] for w in cells.benchmark()["workloads"]]


def cut(cell: cells.Cell, float64: bool = False, images: int = 64, **recipe) -> cells.Cell:
    """``cell`` at its family's cut and ``images`` images, in chunks of a
    quarter of them; ``recipe`` overrides its traffic's recipe."""
    cell.config = dict(cells.family(cell.config).tiny(cell.config), **{"data.size": images})
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["recipe"].update({"data.batch_size": images // 2, "hyp.sub_batch": images // 4,
                                   **recipe})
    if float64:
        cell.traffic["recipe"].update({"impl.mixed_precision": False, "impl.dtype": "float64",
                                       "impl.accumulation_dtype": "float64"})
    return cell


def tiny(workload: str, float64: bool = False, **recipe) -> cells.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` at its cut (:func:`cut`)."""
    return cut(cells.find(workload), float64, **recipe)
