#!/usr/bin/env python3
"""float16 products on one card with cuBLAS's reduced-precision reduction on
and off.

    python3 f16_matmul.py [--out f16_matmul.json]

``torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction`` lets
cuBLAS sum a float16 product in float16. The JAX dot sums float16 in
float32, and ``training.configure_backends`` turns the flag off to match it.
This script measures what that choice costs and saves: at the linear
layer's three products in a float16 ResNet-18 step at chunks of 2048 images
(forward, input gradient, weight gradient) and one deep sum (K = 65,536), it
prints for each setting the largest error against float64, relative to the
largest ``|A| @ |B|`` entry, and the time of one product (CUDA events over 30
calls after 3 warm-up).

Prints the card's name and power limit, one line per product and, last, a
JSON object of the rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (M, K, N) of A [M, K] @ B [K, N]
PRODUCTS = [(2048, 512, 10), (2048, 10, 512), (10, 2048, 512), (512, 65536, 512)]


def device_ms(torch, fn, iters=30, warmup=3) -> float:
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


def measure(torch) -> list[dict]:
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_fp16_reduced_precision_reduction
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    try:
        for m, k, n in PRODUCTS:
            a = torch.randn((m, k), generator=g, device="cuda").half()
            b = torch.randn((k, n), generator=g, device="cuda").half()
            exact = a.double() @ b.double()
            size = (a.double().abs() @ b.double().abs()).max().item()
            row = {"m": m, "k": k, "n": n}
            for reduced in (True, False):
                matmul.allow_fp16_reduced_precision_reduction = reduced
                row[f"rel_err_{reduced}"] = ((a @ b).double() - exact).abs().max().item() / size
                row[f"ms_{reduced}"] = device_ms(torch, lambda: a @ b)
            rows.append(row)
            print(f"M={m} K={k} N={n}: reduced-precision reduction on: rel err "
                  f"{row['rel_err_True']:.3e}, {row['ms_True']:.5f} ms; off: "
                  f"{row['rel_err_False']:.3e}, {row['ms_False']:.5f} ms", flush=True)
    finally:
        matmul.allow_fp16_reduced_precision_reduction = flag
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, help="also write the JSON object to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("f16_matmul: torch.cuda.is_available() is False; this needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    result = {"device": torch.cuda.get_device_name(0), "rows": measure(torch)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
