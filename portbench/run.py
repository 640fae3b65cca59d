"""Run one cell of the benchmark of the PyTorch port once, from the root of a
checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints one JSON line last on standard output: ``correct``, ``attempted``
and ``failed`` steps, the metrics (with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones), the device, with
``--trace 1`` a breakdown of the traced steps, and last the numbers of the
comparison beside their limits, which also end standard error. It exits
with another code than 0, and prints no result, where there is no CUDA
card or fewer than the cell asks for, or where JAX or the JAX package was
loaded in the process. Builds and caches go under ``build/`` of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fullbatchtraining_tpu")


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - started


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from portbench import cells, harness

    cell = cells.find(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"), process_age)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
