#!/usr/bin/env python3
"""Time the port's BatchNorm wrappers from two or more source trees on one card.

    python3 bn_ab.py build/parent . [--dtype float16] [--out ab.json]

Each argument is a checkout of the repo (for example a ``git archive`` of an
earlier commit unpacked into an ignored directory). The trees run in turns,
first to last and back (A, B, B, A), each in a process of its own, so that
all of them are measured on one card and a drift over the call shows. A
process imports ``fullbatchtraining_tpu_torch`` from its tree, builds that
tree's kernels, and times, at ResNet-18's four BN shapes for a chunk of 2048
images in bfloat16 (or ``--dtype float16``):

* ``stats``, ``apply``, ``bwd_reduce`` and ``bwd_apply``: CUDA events over 30
  calls after 3 warm-up, warm L2 (the method of ``chip_smoke.py`` phase 2);
* ``bwd_apply_split``: ``bwd_apply(..., split=True)``, the model's BatchNorm's
  rounding, in a tree that has it;
* ``bn_train``: ``BNTrain`` forward and backward, the same way over 10 calls;
* beside each (``<name>_host``): the host's time to issue one call, as many
  calls with no sync between them. Where it reaches the CUDA-event time, the
  call is bound by the host.

Each time is taken REPEATS times in a row: the device time is their median;
the host time their least, since the host's clock also counts the other work
of a CPU that a one-card machine shares.

Prints one line per run and, last, a JSON object: per run and function, the
per-stage ms and their sum over the 20 BN layers of a chunk (5 per stage).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHUNK = 2048
STAGES = [(1024, 64), (256, 128), (64, 256), (16, 512)]  # (H*W, C) per ResNet-18 stage
LAYERS_PER_STAGE = 5
NAMES = ("stats", "apply", "bwd_reduce", "bwd_apply", "bwd_apply_split", "bn_train")
REPEATS = 7


def device_ms(torch, fn, iters, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / iters


def time_tree(root: Path, dtype_name: str) -> dict:
    """Per-function per-stage ms of the wrappers in ``root``."""
    import inspect

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bn_ab: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(root))
    from fullbatchtraining_tpu_torch.ops import bn

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    split = "split" in inspect.signature(bn.bwd_apply).parameters
    out = {key: [] for name in NAMES for key in (name, f"{name}_host")}
    for hw, c in STAGES:
        m = CHUNK * hw
        g = torch.Generator(device=dev).manual_seed(hw + c)
        x = (torch.randn((m, c), generator=g, device=dev) * 1.5 + 0.3).to(dtype)
        dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
        ab = torch.randn((2, c), generator=g, device=dev)
        coef = torch.randn((3, c), generator=g, device=dev)
        scale = (torch.randn(c, generator=g, device=dev) * 0.5 + 1).requires_grad_()
        bias = torch.randn(c, generator=g, device=dev).requires_grad_()
        xg = x.detach().requires_grad_()

        def bn_train():
            y, _, _ = bn.bn_train(xg, scale, bias)
            return torch.autograd.grad(y, (xg, scale, bias), dy)

        calls = {"stats": lambda: bn.stats(x), "apply": lambda: bn.apply(x, ab),
                 "bwd_reduce": lambda: bn.bwd_reduce(dy, x),
                 "bwd_apply": lambda: bn.bwd_apply(dy, x, coef), "bn_train": bn_train}
        if split:
            calls["bwd_apply_split"] = lambda: bn.bwd_apply(dy, x, coef, split=True)
        for name, call in calls.items():
            iters = 10 if name == "bn_train" else 30
            out[name].append(statistics.median(
                device_ms(torch, call, iters) for _ in range(REPEATS)))
            out[f"{name}_host"].append(min(host_ms(torch, call, iters) for _ in range(REPEATS)))
        del x, dy, xg, calls
        torch.cuda.empty_cache()
    return {key: {"per_stage_ms": v, "chunk_ms": LAYERS_PER_STAGE * sum(v)}
            for key, v in out.items() if v}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", type=Path,
                        help="source trees, in the order to run them")
    parser.add_argument("--out", type=Path, help="also write the JSON object to this file")
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16"))
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)  # a child
    args = parser.parse_args()
    roots = [r.resolve() for r in args.roots]
    if args.one:
        print(json.dumps(time_tree(roots[0], args.dtype)))
        return 0

    runs = []
    for root in roots + roots[::-1]:
        child = subprocess.run([sys.executable, __file__, "--one", "--dtype", args.dtype,
                                str(root)], capture_output=True, text=True, cwd=root)
        if child.returncode != 0:
            print(child.stdout, child.stderr, file=sys.stderr)
            return child.returncode
        times = json.loads(child.stdout.strip().splitlines()[-1])
        runs.append({"root": str(root), "times": times})
        print(f"{root}: " + ", ".join(
            f"{n} {times[n]['chunk_ms']:.4f} ms (host {times[n + '_host']['chunk_ms']:.4f})"
            for n in NAMES if n in times), flush=True)
    result = {"dtype": args.dtype, "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
