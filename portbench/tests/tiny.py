"""Cells of the benchmark cut to a size the CPU runs in seconds: width 4,
64 images in blocks of 32 and chunks of 16, float64 where asked (the
reference then runs in float64 too). The bottleneck cell runs at depth 50,
which has every kind of block that depth 152 has."""

from __future__ import annotations

import copy

from portbench import cells

SEED = 2**31 + 17          # a seed past 32 signed bits, as a run may be given


def tiny(workload: str, float64: bool = False, **recipe) -> cells.Cell:
    cell = cells.find(workload)
    config = dict(cell.config, **{"model.width": 4, "data.size": 64})
    if config["model.depth"] > 50:
        config["model.depth"] = 50
    cell.config = config
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["recipe"].update({"data.batch_size": 32, "hyp.sub_batch": 16, **recipe})
    if float64:
        cell.traffic["recipe"].update({"impl.mixed_precision": False, "impl.dtype": "float64",
                                       "impl.accumulation_dtype": "float64"})
    return cell
