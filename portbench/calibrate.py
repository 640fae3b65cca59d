"""Readings for the limits of a cell's comparison, all in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,... \
        [--controls 3] [--variants control,half] [--out build/portbench/calibrate.jsonl]

For every seed the program's first steps against the reference (the lower
readings). For the first ``--controls`` seeds also each of ``--variants``
against the reference (the upper readings): ``control``, the reference in
the precision below the cell's (``control`` of its traffic); a fault
planted in the reference (``half``: half of each chunk left out, the mean
taken over the rest; ``no_penalty``: the gradient penalty left out); or
any precision of :mod:`.reference.precision`, to look at what it does.
One JSON line a seed, with every reading, every number and the seconds
each part took.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--variants", default="control,half")
    parser.add_argument("--out", default="build/portbench/calibrate.jsonl")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells, compare, inputs
    from portbench.harness import sync
    from portbench.program import Program
    from portbench.reference.train import FAULTS

    cell = cells.find(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    steps = int(cell.traffic["check_steps"])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    variants = [(v, {"precision": cell.traffic["control"]} if v == "control" else
                 {"fault": v} if v in FAULTS else {"precision": v})
                for v in args.variants.split(",") if v]

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        program = Program(cell, seed, device)
        seconds = {"build": time.perf_counter() - start}
        start = time.perf_counter()
        readings = {"program": compare.program_readings(program, steps)}
        sync(device)
        seconds["program"] = time.perf_counter() - start
        del program
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        images, labels = inputs.images_and_labels(cell.config, seed, device)
        weights = inputs.weights(cell.config, seed, device)
        for kind, kwargs in [("reference", {})] + (variants if i < args.controls else []):
            start = time.perf_counter()
            readings[kind] = compare.reference_readings(cell, images, labels, weights, seed,
                                                        steps, **kwargs)
            sync(device)
            seconds[kind] = time.perf_counter() - start
        ref = readings["reference"]
        record = {"workload": cell.name, "seed": seed, "seconds": seconds,
                  "gaps": {kind: {k: v for k, (v, _) in compare.gaps(r, ref).items()}
                           for kind, r in readings.items() if kind != "reference"},
                  "where": {kind: {k: w for k, (_, w) in compare.gaps(r, ref).items()}
                            for kind, r in readings.items() if kind != "reference"},
                  "readings": readings}
        with open(out, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(json.dumps({k: record[k] for k in ("seed", "seconds", "gaps")}), flush=True)
        del images, labels, weights, readings
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
