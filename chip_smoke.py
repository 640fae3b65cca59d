#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero before the result lines:

1. The card (``nvidia-smi`` name and power limit), versions, and the build of
   the port's CUDA kernels from ``fullbatchtraining_tpu_torch/ops/csrc``
   (``nvcc -Xptxas -v``: registers and spills per kernel; every kernel of
   ``BN_KERNEL_NAMES`` must be in the report, and none may spill).
2. Every kernel against its plain PyTorch version at ResNet-18/CIFAR's BN
   shapes for a chunk of 2048 images (the bench shape), in float32 and
   bfloat16, plus BNTrain forward+backward; times of kernel, plain version,
   the one-call PyTorch equivalent (the CUDA batch-norm functions that
   SyncBatchNorm calls; ``F.batch_norm`` for ``apply`` and BNTrain), and the
   bound (bytes each function must move over 3.35 TB/s). Each launch logs
   the bytes a thread moved per access; every kernel must take 16 bytes
   there, and runs once more on a copy of ``x`` one element off 16-byte
   alignment, which takes its one-element width (checked and timed as
   ``narrow_ms``). Beside each kernel's time, ``host_ms``: the host's
   time to enqueue one call of its wrapper.
3. One float32 full-batch step of the main path (ResNet-18, 8192 images in
   chunks of 512) with the kernels, and the same step under
   ``ops.bn.plain_versions()``: loss, gradient norm, parameters and running
   stats must agree.
4. The main path at full width through ``training.train``, the function
   ``python -m fullbatchtraining_tpu_torch`` calls: ``model=resnet18
   data=CIFAR10 hyp=fb1``, 3 steps over 50,000 synthetic images in chunks of
   2048 under bf16 autocast. Launch counts must show every kernel on the path,
   and every launch at 16 bytes a thread.
5. One more full-width step under ``torch.profiler``, after a warm-up step:
   device time by kernel class, and the device's busy share: that step's
   device time over the wall time of the next step, run without the
   profiler (the profiler's own host work stretches the traced step).
6. Phase 3 for ``hyp=gradreg`` (the gradient regularizer), with its
   ``forward-differences`` and ``autograd`` variants: kernels against plain
   versions, and the launch counts of each (twice phase 3's for the forward
   difference; double backwards for ``autograd``). Then BNTrain's double
   backward on the kernel route against ``bn_train_reference``'s at the BN
   shapes of phase 2, in float32.
7. ``hyp=gradreg`` at full width through ``training.train`` (3 bf16 steps,
   forward differences): exactly twice phase 4's launches of ``stats``,
   ``bwd_reduce`` and ``bwd_apply``, all at 16 bytes a thread; its profile as
   in phase 5; one ``autograd`` step through ``training.train`` and its
   profile, both cut to 4 chunks (8,192 images); and ``||reg_fn(g) - g|| /
   ||g||`` of one chunk under bf16 and in float32, beside the exact float32
   value.
8. The SGD baseline, shuffled epochs, SAM and checkpoints. (a) Phase 2's
   check at the BN shapes of a block of 128 and a chunk of 32 images, where
   the host's time to issue a call can exceed the kernel's. (b)
   ``hyp=base_sgd`` epochs of 16 shuffled updates, without and with SAM,
   kernels against plain versions: in float32 the first update within phase
   3's tolerance and the later ones beside a control run from weights off
   by a few ulps; in float64 all 16 within 1e-10. (c) ``hyp=base_sgd`` as its yaml has it
   through ``training.train``: 2 steps of 390 updates, exact launch counts,
   the profile of an epoch cut to 50 updates. (d) The paper's "FB in practice" step,
   ``hyp=gradreg data.batch_size=32 hyp.shuffle=True`` in bf16, cut to 195
   of its 1562 chunks, exact launch counts, the profile of a step cut to 32
   chunks; one shuffled
   ``hyp=fb1`` step with phase 4's launches and its epoch gather time. (e) A
   run resumed from an async checkpoint, bitwise equal to the straight run.
9. The baked 10x CIFAR store (``data/db=baked data.augmentations_train=
   data.db.rounds=10``, a temporary store under ``build/``). (a) The bake of
   50,000 images: its time and rate, shape and meta, each round's labels in
   its recomputed order, 512 sampled images a round each one of its
   source's 162 crop/flip windows, the augmentation on the card. (b)
   ``fb_10_1``: one ``hyp=fb1`` step over the 500,000 images as phase 4
   runs it, phase 4's launches a chunk, the store's upload time, peak
   memory. (c) ``SGD_10_CIFAR``: ``hyp=base_sgd
   hyp.train_semi_stochastic=True``, 2 steps (rounds 0 and 1) with phase
   8c's launches, each step's staged rows bitwise the host gather of its
   round in its order, the gather's time. (d) Phase 3 on a float32
   semi-stochastic ``hyp=fb1`` step over a 2-round store of 8,192 images a
   round. (e) The host path (the store above
   ``impl.device_shuffle_max_bytes``) stages bitwise the rows of (c).
10. Data parallelism (``impl/setup=distributed``). (a) NCCL in a group of
   one: phase 4's step (1 step) through the distributed path, bitwise equal
   to the same step without it, phase 4's launches a step, one
   ``all_reduce`` for the step and one an evaluation; the bucket's bytes and
   its all-reduce's CUDA-event time, first (communicator set-up included)
   and warm. (b) Two gloo ranks that share the card
   (this script with ``--rank``, in two processes): phase 3's float32 step
   at 8 chunks a rank against one process's 16: loss, params, chunk norms
   slot by slot and ``grad_norm * sqrt(2)``; half the launches a rank, and
   the ranks' params bitwise equal. (c) ``train_distributed_multinode.sh:8``,
   ``hyp=gradreg model=resnet152`` in a group of one, cut to 20 chunks of
   128: 2 passes x its BN layers x 20 launches of each backward kernel.
11. Other datasets and streamed epochs, bf16. Phase 2's check at the BN
   shape of ResNet-18's first stage at 224 px (128 images, C = 64). (a)
   ``data=TinyImageNet hyp=fb1`` at full width (100,000 synthetic images of
   64x64, chunks of 2048, resident): the synthetic set's first-use time, 2
   steps, exact launches, peak memory, a profile of the warm step. (b) The
   same with the epoch streamed from the host (``impl.hbm_epoch_max_bytes``
   512 MiB): bitwise (a)'s params, BN stats and stats, the epoch's bytes
   host to device a step, the copy stream's time in a profile; one
   shuffled step streamed (host gather) against the resident device
   gather, bitwise. (c) ``data=ImageNet`` as its yaml has it, cut to 4,096
   images: ``resize`` and ``resized_crop`` on the card against the CPU; one
   step and one evaluation with the epoch and the validation set streamed
   and 4 sub-chunks a block, the evaluation against a resident one in
   whole blocks. (d) A PIL-written JPEG tree loaded twice through ``python
   -m fullbatchtraining_tpu_torch data=ImageNet dryrun=True``: the second
   run reads the first one's cache.
12. The optimizer zoo, at phase 4's width, data and chunks (bf16,
   ``hyp.warmup=0``). (a) ``hyp/optim=lbfgs`` (Wolfe, history 10), 2
   steps: the closure evaluations of each step, ``lbfgs_t``, step time,
   peak memory, the driver's flat-vector bytes and host syncs; each
   kernel's launches exactly the evaluations times a full-batch pass (phase
   4's launches a step less its validation's) plus the validations'. (b)
   L-BFGS at phase 8e's size in float32: 2 steps straight through against
   1 step, an async checkpoint and a fresh model resumed, bitwise in
   params, running stats, ``s_hist``/``y_hist`` and the rest of the driver
   state. (c) One step each of ``hyp.optim.line_search=wolfe``,
   ``hyp/optim=adam hyp/optim_modification=LARC``, ``hyp/optim=gd_agc`` and
   ``hyp/optim=gd_clip``: evaluations, step time, loss, exact launches.
13. The other model families and norms at full width, data cut. (a)
   ``train_distributed_multinode.sh:15-16``, ``hyp=gradreg
   model=densenet121`` in an NCCL group of one, as 10c: float32, 20 chunks
   of 128, one step; launches exactly 2 passes x 120 BatchNorms x 20, no
   channels-last copy, step time and peak memory. (b) The same over 4
   chunks with ``model.memory_efficient=True`` against the plain model:
   loss, gradient, params and running stats equal (bitwise expected, else
   within 1e-6 relative), peak memory lower. (c) Phase 3's check on VGG11,
   PyramidNet-110 (mostly one-element launches), DenseNet-121 at 4 chunks
   of 128 and ResNet-18 under ``SequentialGhostNorm``, where a tensor that
   rounding alone moves (a conv bias under a BatchNorm, a cancelling sum,
   the zero batch mean of a BatchNorm fed by another) is held to 10x a
   plain run's from weights off by 2^-20. (d) Two bf16
   ``hyp=fb1`` steps each of ``vgg16``,
   ``pyramidnet110``, ``pyramidnet272``, ``nfn`` and ResNet-18 under
   ``SequentialGhostNorm``, ``GroupNorm`` and ``SkipInit``, 16 chunks of
   128: step times, launches exactly the model's (none for NFNet, GroupNorm
   and SkipInit), at 16 bytes and at one element, no channels-last copy,
   peak memory. (e) Phase 2's check at PyramidNet-110's odd first-stage
   widths (C = 19, 21; 128 and 2048 images) and DenseNet-121's widest norm
   (C = 1024, 4x4, 128 images). (f) One warm bf16 ``hyp=fb1`` chunk of
   128 of PyramidNet-110 under ``torch.profiler``: device time by kernel
   class against the wall time.
14. Analysis (``analysis=full``), whose per-chunk sweep runs eval-mode
   forwards and backwards in float32 through ``BNEval`` (``apply`` forward;
   ``apply`` and ``bwd_reduce`` backward). (a) ``BNEval`` against its plain
   versions at ResNet-18's stage shapes for a chunk of 128, float32 and
   bf16, with exact launches. (b) ``analyze`` at full width over 4,096
   images (32 chunks of 128) on the kernels against ``plain_versions()``:
   per-batch norms, SNR, noise scale, gradient norm and momentum measures
   within 1e-4; the sweep streamed from the host bitwise the resident one.
   (c) The sweep over all 50,000 images (390 chunks of 128): exactly 15,600
   ``apply`` and 7,800 ``bwd_reduce`` launches, its time, peak memory, ratio
   to phase 4's step and the busy share of 8 traced chunks. (d) ``hyp=fb1
   analysis=full`` through ``training.train``, one full-width bf16 step:
   params and running stats bitwise those of the step without analysis,
   every entry recorded, exact launches, the step and the analysis timed
   apart. (e) The flatness walk at (b)'s cut: its steps and the seconds an
   evaluation.
15. The loss landscape and the tools. (a) A surface at full width
   (``crunch``, ``hyp=gradreg`` with ``block_strength`` 0.5, bf16, all
   50,000 images in 24 blocks of 2048, ``viz=1d`` cut to 5 positions, one
   group), counts set to 0 just before it: exactly positions x blocks x 20
   BatchNorms x 2 ``apply`` and x 1 ``bwd_reduce``, no ``stats`` or
   ``bwd_apply``; 5 finite rows with ``full_loss >= train_loss``; seconds a
   position, their ratio to phase 4's warm step, peak memory. (b) The same
   in float32 over 4,096 images, ``viz=2d`` at 3x3 in groups of 4: on the
   kernels against ``plain_versions()`` (loss and full loss within 1e-5
   relative, accuracy within one image), streamed from the host bitwise the
   resident surface, and a second call that computes nothing and leaves the
   results file byte for byte. (c) One phase-4 bf16 ``hyp=fb1`` step with
   ``analysis.save_model_every_nth_step=1``: every tensor bitwise the same
   step's without a snapshot, the stored gradients bitwise a
   ``pre_step_gradient`` from the same initial state; the file's bytes and
   write seconds. (d) ``verify_model_checkpoint`` on (c)'s checkpoint
   reproduces (c)'s ``valid_acc`` exactly; ``measure_floating_point_accuracy``
   at phase 4's configuration under ``impl.deterministic=True`` and
   ``False``: six finite deviations each. (e) (c)'s trained state to the
   upstream ``.pth`` 5-tuple and back into a fresh model: every tensor and
   the model's evaluation on the card bitwise the first.

The last lines are the card line, a JSON object of per-kernel numbers (their
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` sum the 20 BN layers of
one bf16 chunk of 2048 images, ``stem_224`` times the 224 px first-stage
layer alone; ``launches`` counts phase 4, ``launches_gradreg`` phase 7,
``launches_sgd`` phase 8c, ``launches_fb_shuffle`` phase 8d,
``launches_baked`` phase 9b, ``launches_dist`` phase 10a,
``launches_tinyimagenet`` 11a, ``launches_streamed`` 11b,
``launches_imagenet`` 11c, ``launches_zoo`` 12a, ``launches_families``
13a-13d, ``launches_analysis`` 14c and ``launches_landscape`` 15a;
``family_shapes`` holds 13e's rows),
and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import socket
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
DEVICE = "cuda"
CHUNK = 2048                       # images per chunk at the bench shape
STAGES = [(1024, 64), (256, 128), (64, 256), (16, 512)]  # (H*W, C) per ResNet-18 stage
LAYERS_PER_STAGE = 5
BN_LAYERS = LAYERS_PER_STAGE * len(STAGES)   # 20 BatchNorms in ResNet-18
SOURCE = "fullbatchtraining_tpu_torch/ops/csrc/bn_kernels.cu"
REPLACES = {"stats": "fullbatchtraining_tpu/ops/pallas_bn.py:88",
            "apply": "fullbatchtraining_tpu/ops/pallas_bn.py:97",
            "bwd_reduce": "fullbatchtraining_tpu/ops/pallas_bn.py:102",
            "bwd_apply": "fullbatchtraining_tpu/ops/pallas_bn.py:112"}
# bytes each kernel must move per element of x ([M, C]): inputs read once,
# outputs written once ([C]-sized operands are negligible). All of them are
# memory-bound: a few operations per element stay far below the card's rate.
BYTES_PER_ELEMENT = {"stats": 1, "apply": 2, "bwd_reduce": 2, "bwd_apply": 3, "bn_train": 4}
SUM_TOL = 1e-5        # reductions: error / sum of |terms| (float32 sums, any order)
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
BN_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # error / max |plain output|


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=30, warmup=3) -> float:
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


def host_ms(torch, fn, iters=30) -> float:
    """The host's time to enqueue one call: ``iters`` calls with no sync in
    between (far fewer than fill the launch queue). Where it reaches
    :func:`cuda_ms` of the same call, that time is the host's, not the
    kernel's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / iters


def bound_ms(name, m, c, itemsize) -> float:
    return 1e3 * BYTES_PER_ELEMENT[name] * m * c * itemsize / HBM_BYTES_PER_S


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def spills(compiler: str) -> dict:
    """``{kernel: (spill store bytes, spill load bytes)}`` from ``-Xptxas -v``."""
    out, name = {}, None
    for line in compiler.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name] = (nums[1], nums[2])  # stack frame, spill stores, spill loads
    return out


def access_bytes(bn, name, before, itemsize) -> int:
    """Bytes a thread moved per access in the launch just made: 16 where
    the wrapper counted a 16-byte launch, else one element."""
    return 16 if bn.vector_launches[name] > before[name] else itemsize


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, bn, chunk=CHUNK, stages=STAGES):
    """Every kernel against its plain version at the BN shapes ``stages``
    (``(H*W, C)``) of a chunk of ``chunk`` images, with its times; 16 bytes
    a thread where ``C`` allows it, else one element."""
    import torch.nn.functional as F

    rows = []
    dev = torch.device(DEVICE)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for hw, c in stages:
            m = chunk * hw
            g = torch.Generator(device=dev).manual_seed(hw + c)
            x = (torch.randn((m, c), generator=g, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
            ab = torch.randn((2, c), generator=g, device=dev)
            coef = torch.randn((3, c), generator=g, device=dev)
            with bn.plain_versions():
                plain = {"stats": bn.stats(x), "bwd_reduce": bn.bwd_reduce(dy, x),
                         "apply": bn.apply(x, ab), "bwd_apply": bn.bwd_apply(dy, x, coef)}
                scale = {"stats": bn.stats(x.abs()),
                         "bwd_reduce": bn.bwd_reduce(dy.abs(), x.abs()),
                         "apply": (x.float() * ab[0]).abs() + ab[1].abs(),
                         "bwd_apply": ((dy.float() * coef[0]).abs() + coef[1].abs()
                                       + (x.float() * coef[2]).abs())}
            calls = {"stats": lambda: bn.stats(x), "bwd_reduce": lambda: bn.bwd_reduce(dy, x),
                     "apply": lambda: bn.apply(x, ab),
                     "bwd_apply": lambda: bn.bwd_apply(dy, x, coef)}
            # x one element off 16-byte alignment: every kernel takes its
            # one-element width on it
            x_off = torch.empty(m * c + 1, dtype=dtype, device=dev)[1:].view(m, c)
            x_off.copy_(x)
            narrow = {"stats": lambda: bn.stats(x_off),
                      "bwd_reduce": lambda: bn.bwd_reduce(dy, x_off),
                      "apply": lambda: bn.apply(x_off, ab),
                      "bwd_apply": lambda: bn.bwd_apply(dy, x_off, coef)}
            library = library_calls(torch, F, x, dy, ab, hw, c, chunk)
            for name, call in calls.items():
                before = dict(bn.vector_launches)
                out = call()
                torch.cuda.synchronize()
                width = access_bytes(bn, name, before, x.element_size())
                err, rel, tol = against_plain(name, out, plain[name], scale[name], dtype_name)
                with bn.plain_versions():
                    plain_ms = cuda_ms(torch, call)
                row = {"kernel": name, "dtype": dtype_name, "images": chunk, "m": m, "c": c,
                       "access_bytes": width,
                       "max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
                       "ms": cuda_ms(torch, call), "host_ms": host_ms(torch, call),
                       "plain_ms": plain_ms, "library_ms": cuda_ms(torch, library[name]),
                       "bound_ms": bound_ms(name, m, c, x.element_size())}
                rows.append(row)
                log(f"  {name:10s} {dtype_name:8s} M={m:8d} C={c:3d} {width:2d} B/access "
                    f"max_abs_err={err:.3e} rel={rel:.2e} (tol {tol:g} of the terms) "
                    f"kernel {row['ms']:.4f} ms (host {row['host_ms']:.4f})  "
                    f"plain {plain_ms:.4f} ms  "
                    f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms")
                check(rel <= tol,
                      f"{name} {dtype_name} M={m} C={c} disagrees with its plain version")
                # 16 bytes a thread where C is a multiple of 16 bytes' elements
                expect = 16 if c % (16 // x.element_size()) == 0 else x.element_size()
                check(width == expect, f"{name} {dtype_name} C={c} took {width}-byte accesses")
                row.update(narrow_run(torch, bn, name, narrow[name], plain[name], scale[name],
                                      dtype_name, x.element_size()))
            rows.append(phase_bn_train(torch, bn, F, x, dy, dtype_name, hw, c, chunk))
            del x, dy, x_off, plain, scale, calls, narrow, library
            torch.cuda.empty_cache()
    return rows


def narrow_run(torch, bn, name, call, plain, scale, dtype_name, itemsize):
    """``call`` runs kernel ``name`` on an input one element off 16-byte
    alignment: it must take the one-element width and agree with the plain
    version as closely as the 16-byte launch must."""
    before = dict(bn.vector_launches)
    out = call()
    torch.cuda.synchronize()
    _, rel, tol = against_plain(name, out, plain, scale, dtype_name)
    result = {"narrow_max_rel_err": rel, "narrow_ms": cuda_ms(torch, call)}
    log(f"  {name:10s} {dtype_name:8s} offset x, {itemsize} B/access: rel={rel:.2e} "
        f"kernel {result['narrow_ms']:.4f} ms")
    check(bn.vector_launches[name] == before[name],
          f"{name} on an offset input still took 16-byte accesses")
    check(rel <= tol,
          f"{name} {dtype_name} at one element a thread disagrees with its plain version")
    return result


def against_plain(name, out, plain, scale, dtype_name):
    """(max abs error, max error relative to the size of the terms, tolerance):
    sums within SUM_TOL of sum |terms|, elementwise outputs within 2 ulp of
    their dtype of |terms| + |plain output|."""
    err = (out.double() - plain.double()).abs()
    if name in ("stats", "bwd_reduce"):
        size, tol = scale.double(), SUM_TOL
    else:
        size, tol = scale.double() + plain.double().abs(), 2 * ULP[dtype_name]
    return err.max().item(), (err / size.clamp_min(1e-30)).max().item(), tol


def library_calls(torch, F, x, dy, ab, hw, c, chunk=CHUNK):
    """One PyTorch call per kernel computing the same function on the same
    [N, C, H, W] channels_last views: the CUDA batch-norm functions that
    SyncBatchNorm calls, and eval-mode ``F.batch_norm`` for ``apply``. They
    are yardsticks, timed here only; the port never calls them."""
    side = math.isqrt(hw)
    xl = x.view(chunk, side, side, c).permute(0, 3, 1, 2)
    dyl = dy.view(chunk, side, side, c).permute(0, 3, 1, 2)
    # per-channel mean and invstd: the statistics of (sum x, sum x^2)
    mean, invstd = torch.batch_norm_stats(xl, 1e-5)
    # sum dy and sum dy*(x - mean): bwd_reduce's s1 and s2 - mean*s1
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
        dyl, xl, mean, invstd, ab[0], True, False, False)
    count = torch.full((1,), x.shape[0], dtype=torch.int32, device=x.device)
    # eval-mode batch_norm with mean 0 and var 1 - eps is y = ab[0]*x + ab[1]
    zero = torch.zeros(c, device=x.device)
    one = torch.full((c,), 1 - 1e-5, device=x.device)
    return {
        "stats": lambda: torch.batch_norm_stats(xl, 1e-5),
        "apply": lambda: F.batch_norm(xl, zero, one, ab[0], ab[1], training=False, eps=1e-5),
        "bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            dyl, xl, mean, invstd, ab[0], True, False, False),
        # the per-channel affine dx of the full BN backward, as bwd_apply
        "bwd_apply": lambda: torch.batch_norm_backward_elemt(
            dyl, xl, mean, invstd, ab[0], sum_dy, sum_dy_xmu, count),
    }


def phase_bn_train(torch, bn, F, x, dy, dtype_name, hw, c, chunk=CHUNK):
    """BNTrain forward+backward on the kernels against the same Function on
    the plain versions; F.batch_norm(training=True) forward+backward timed
    beside it."""
    side = int(math.isqrt(hw))
    g = torch.Generator(device=x.device).manual_seed(7)
    scale = (torch.randn(c, generator=g, device=x.device) * 0.5 + 1).requires_grad_()
    bias = torch.randn(c, generator=g, device=x.device).requires_grad_()
    xg = x.detach().requires_grad_()

    def step():
        y, mean, var = bn.bn_train(xg, scale, bias)
        return (y, mean, var, *torch.autograd.grad(y, (xg, scale, bias), dy))

    outs = step()
    with bn.plain_versions():
        refs = step()
        plain_ms = cuda_ms(torch, step, iters=10)
    errs = [((o.double() - r.double()).abs().max() / r.double().abs().max().clamp_min(1e-30)).item()
            for o, r in zip(outs, refs)]
    xl = x.detach().view(chunk, side, side, c).permute(0, 3, 1, 2).requires_grad_()
    dyl = dy.view(chunk, side, side, c).permute(0, 3, 1, 2)

    def library():
        y = F.batch_norm(xl, None, None, scale, bias, training=True)
        return torch.autograd.grad(y, (xl, scale, bias), dyl)

    row = {"kernel": "bn_train", "dtype": dtype_name, "images": chunk, "m": x.shape[0], "c": c,
           "max_abs_err": max((o.double() - r.double()).abs().max().item()
                              for o, r in zip(outs, refs)),
           "max_rel_err": max(errs), "tolerance": f"{BN_TRAIN_TOL[dtype_name]:g} of max|plain|",
           "ms": cuda_ms(torch, step, iters=10), "plain_ms": plain_ms,
           "library_ms": cuda_ms(torch, library, iters=10),
           "bound_ms": bound_ms("bn_train", x.shape[0], c, x.element_size())}
    log(f"  bn_train   {dtype_name:8s} M={row['m']:8d} C={c:3d} rel errs "
        f"(y, mean, var, dx, dscale, dbias) {[f'{e:.1e}' for e in errs]} "
        f"(tol {row['tolerance']}) kernels {row['ms']:.4f} ms  plain {plain_ms:.4f} ms  "
        f"F.batch_norm {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms")
    check(max(errs) <= BN_TRAIN_TOL[dtype_name],
          f"BNTrain {dtype_name} M={row['m']} C={c} disagrees with its plain version")
    return row


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def main_path_config(extra, hyp="fb1"):
    from fullbatchtraining_tpu_torch.config import load_config

    return load_config(ROOT / "config", overrides=[
        "model=resnet18", "data=CIFAR10", f"hyp={hyp}", "seed=0",
        f"data.path={ROOT / 'build' / 'no_cifar_here'}", "name=chip_smoke"] + list(extra))


def run_main_path(torch, extra, hyp="fb1", bundle=None, perturb=0.0):
    """``training.train`` of ``main_path_config(extra, hyp)`` from its seeded
    weights (each multiplied by ``1 +- perturb``), on ``bundle`` where given
    (a bundle depends on ``data.*`` only)."""
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    cfg = main_path_config(extra, hyp)
    if bundle is None:
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=cfg.dryrun,
                                      seed=cfg.seed, device=DEVICE)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                            pixels=bundle.pixels)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g).sign())
    initial = copy.deepcopy(model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    state, stats = train(model, bundle, cfg, device=DEVICE)
    torch.cuda.synchronize()
    return cfg, bundle, initial, state, stats


STAT_TOL = 1e-4   # running stats, kernels against plain, relative L2
FP32_STEP = ["hyp.warmup=0", "hyp.steps=1", "data.size=8192", "data.batch_size=512",
             "hyp.sub_batch=512", "impl.mixed_precision=False"]
FULL_WIDTH = ["hyp.warmup=0", "hyp.steps=3", "data.size=50_000", "data.batch_size=2048",
              "hyp.sub_batch=2048", "impl.mixed_precision=True"]


STEP_TOLS = {"fb1": (("train_loss", 1e-5), ("grad_norm", 1e-4), ("full_loss", 1e-5),
                     ("valid_loss", 1e-4)),
             # full_loss adds lr/4 * block_strength * the mean squared chunk
             # norm, which carries grad_norm's error
             "gradreg": (("train_loss", 1e-5), ("grad_norm", 1e-4), ("full_loss", 1e-4),
                         ("valid_loss", 1e-4))}


def kernels_against_plain_step(torch, bn, hyp="fb1", extra=(), control=False):
    """One float32 step (``FP32_STEP``) on the kernels and under
    ``plain_versions()``: the stats of ``STEP_TOLS[hyp]``, the updated
    params (within 1e-3 of the update, times the amplification of a finite
    difference where the regularizer takes one; with ``control``, a tensor
    beyond that may instead stay within :func:`against_control`'s bound)
    and the running stats (1e-4) must agree.
    Returns the kernel run's launch counts, its double backwards and the
    chunks of the step."""
    from fullbatchtraining_tpu_torch.data import epoch_layout

    bn.reset_counts()
    cfg, bundle, initial, kstate, kstats = run_main_path(torch, FP32_STEP + list(extra), hyp)
    counts, doubles = dict(bn.launches), bn.double_backward_calls
    with bn.plain_versions():
        _, _, _, pstate, pstats = run_main_path(torch, FP32_STEP + list(extra), hyp)
    check(bn.launches == counts, "plain_versions() still launched kernels")
    size = (bundle.baked.meta["size"] if cfg.hyp.train_semi_stochastic and bundle.baked
            else bundle.size)  # a semi-stochastic step reads one round
    blocks, chunks, _ = epoch_layout(size, bundle.batch_size, cfg.hyp.sub_batch)
    log(f"  launches (kernel run): {counts}; double backwards {doubles}")
    for key, tol in STEP_TOLS[hyp]:
        a, b = kstats[key][-1], pstats[key][-1]
        log(f"  {key}: kernels {a!r} plain {b!r} rel diff {abs(a - b) / abs(b):.2e} (tol {tol:g})")
        check(abs(a - b) <= tol * abs(b), f"{key} differs between kernels and plain versions")
    ks, ps = kstate.model.state_dict(), pstate.model.state_dict()
    worst_param, worst_stat = 0.0, 0.0
    for name, p0 in initial.items():
        k, p = ks[name].double().cpu(), ps[name].double().cpu()
        if name.endswith(("running_mean", "running_var")):
            worst_stat = max(worst_stat, ((k - p).norm() / p.norm().clamp_min(1e-30)).item())
        else:
            step = (p - p0.double()).norm().clamp_min(1e-30)
            worst_param = max(worst_param, ((k - p).norm() / step).item())
    param_tol = 1e-3
    reg = cfg.hyp.grad_reg
    if float(reg.block_strength) and reg.implementation.endswith("differences"):
        # a difference quotient divides the kernel-vs-plain differences of two
        # gradients by eps_n = eps / ||v||, ||v|| = block_strength * ||g||: the
        # regularized gradient carries them 2 * (lr/4) * ||v|| / eps times
        param_tol *= 1 + (2 * kstats["lr"][0] / 4 * float(reg.block_strength)
                          * kstats["grad_norm"][0] / float(reg.eps))
    log(f"  params: max over tensors of |kernels - plain| / |update| = {worst_param:.2e} "
        f"(tol {param_tol:.2e}); running stats: max relative L2 diff = {worst_stat:.2e} "
        f"(tol {STAT_TOL:g})")
    if control and (worst_param > param_tol or worst_stat > STAT_TOL):
        worst_param, worst_stat = against_control(torch, bn, hyp, extra, initial, ks, ps,
                                                  param_tol)
    check(worst_param <= param_tol, "updated params differ between kernels and plain versions")
    check(worst_stat <= STAT_TOL, "running stats differ between kernels and plain versions")
    return counts, doubles, blocks * chunks


def against_control(torch, bn, hyp, extra, initial, ks, ps, param_tol):
    """A plain run from weights off by ``CONTROL_EPS`` (relative) shows how
    far rounding alone moves each tensor: a conv bias that a BatchNorm
    follows has no gradient, a sum that cancels loses its leading digits,
    and a BatchNorm fed by another one (PyramidNet's stem, then its first
    block) has a batch mean of zero. A tensor's kernels-vs-plain difference
    may exceed its tolerance (a param's over its update, ``param_tol``; a
    running stat's over itself, ``STAT_TOL``) only up to ``CONTROL_FACTOR``
    times the control's difference of the same. Returns the largest ratio
    of a tensor's difference to its bound, times its tolerance, for the
    params and the running stats."""
    with bn.plain_versions():
        _, _, c0, cstate, _ = run_main_path(torch, FP32_STEP + list(extra), hyp,
                                            perturb=CONTROL_EPS)
    cs = cstate.model.state_dict()
    worst = {"params": (-1.0, None), "running stats": (-1.0, None)}
    for name, p0 in initial.items():
        p, k, c = (t[name].double().cpu() for t in (ps, ks, cs))
        if name.endswith(("running_mean", "running_var")):
            kind, tol, own, control = ("running stats", STAT_TOL, p.norm().item(),
                                       (c - p).norm().item())
        else:
            update = p - p0.double()
            kind, tol, own = "params", param_tol, update.norm().item()
            control = ((c - c0[name].double().cpu()) - update).norm().item()
        gap = (k - p).norm().item()
        ratio = gap / max(tol * own, CONTROL_FACTOR * control, 1e-30)
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, (name, gap, own, control, tol))
    for kind, (ratio, (name, gap, own, control, tol)) in worst.items():
        measure = "update" if kind == "params" else "norm"
        log(f"  control (plain from weights off by {CONTROL_EPS:.1e}), the tightest of the "
            f"{kind}: {name}: |kernels - plain| {gap:.2e}, its {measure} {own:.2e}, the "
            f"control moved it {control:.2e}: {ratio:.2f} of max({tol:g} x its {measure}, "
            f"{CONTROL_FACTOR} x control)")
    return worst["params"][0] * param_tol, worst["running stats"][0] * STAT_TOL


def phase_fp32_step(torch, bn, extra=()):
    counts, _, chunks = kernels_against_plain_step(torch, bn, extra=extra)
    check(all(counts[k] == BN_LAYERS * chunks for k in ("stats", "bwd_reduce", "bwd_apply")),
          f"fp32 step launches {counts}, expected {BN_LAYERS * chunks} per kernel")


def phase_full_width(torch, bn, hyp="fb1", passes=1):
    """``FULL_WIDTH`` through ``training.train``. ``passes``: forward and
    backward passes per chunk (2 for ``hyp=gradreg``'s forward difference),
    so ``stats``, ``bwd_reduce`` and ``bwd_apply`` launch ``passes`` times a
    BN layer a chunk."""
    from fullbatchtraining_tpu_torch.data import epoch_layout

    bn.reset_counts()
    t0 = time.time()
    cfg, bundle, _, _, stats = run_main_path(torch, FULL_WIDTH, hyp)
    wall = time.time() - t0
    counts, wide, copies = dict(bn.launches), dict(bn.vector_launches), bn.layout_copies
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    images = blocks * chunks * sub
    evals = len(stats["valid_loss"])
    eval_blocks = -(-len(bundle.valid) // bundle.batch_size)
    per_step = passes * BN_LAYERS * blocks * chunks
    steps = len(stats["train_loss"])
    result = {
        "step_s": stats["train_time"], "images_per_step": images,
        "images_per_s": [images / t for t in stats["train_time"]],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "train_loss": stats["train_loss"], "train_acc": stats["train_acc"],
        "valid_loss": stats["valid_loss"], "valid_acc": stats["valid_acc"],
        "launches": counts, "vector_launches": wide, "layout_copies": copies, "evals": evals,
        "chunks_per_step": blocks * chunks, "wall_s": wall,
    }
    for i, t in enumerate(stats["train_time"]):
        log(f"  step {i + 1}: {t:.3f} s, {images / t:.0f} images/s, "
            f"train loss {stats['train_loss'][i]:.4f} acc {stats['train_acc'][i]:.4f}")
    log(f"  valid loss {stats['valid_loss']}, valid acc {stats['valid_acc']}")
    log(f"  peak memory {result['peak_memory_gib']:.2f} GiB; launches {counts}; "
        f"of them at 16 bytes a thread {wide}; layout_copies {copies}; evaluations {evals}")
    check(steps == 3 and evals == 2, f"{steps} steps and {evals} evaluations, expected 3 and 2")
    for name in ("stats", "bwd_reduce", "bwd_apply"):
        check(counts[name] == per_step * steps,
              f"{name}: {counts[name]} launches, expected {per_step} per step")
    check(counts["apply"] == per_step * steps + BN_LAYERS * eval_blocks * evals,
          f"apply: {counts['apply']} launches, expected {per_step} per step + "
          f"{BN_LAYERS * eval_blocks} per evaluation")
    for name, n in wide.items():
        check(n == counts[name], f"{name}: {n} of {counts[name]} launches at 16 bytes a thread")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])),
          "non-finite loss")
    return result


BN_KERNEL_NAMES = ("stats_partial", "bwd_reduce_partial", "finalize_partials", "apply_kernel",
                   "bwd_apply_kernel")
CONV_NAMES = ("conv", "gemm", "sm90", "cutlass", "xmma", "cudnn", "implicit", "winograd")


def device_time(prof):
    """``(kernels, h2d_ms, total_ms, by_class_ms)`` of a ``torch.profiler``
    run: ``(name, device ms, count)`` of each device kernel, the pinned
    host-to-device copies (a side stream's), the device time less those, and
    that time split into the BN kernels, the convolutions and the rest."""
    from torch.autograd import DeviceType

    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    h2d_ms = sum(t for name, t, _ in kernels if name.startswith("Memcpy HtoD (Pinned"))
    total = sum(t for _, t, _ in kernels) - h2d_ms
    classes = {"bn kernels": 0.0, "convolutions": 0.0, "other": 0.0}
    for name, t, _ in kernels:
        low = name.lower()
        if name.startswith("Memcpy HtoD (Pinned"):
            continue
        if any(k in name for k in BN_KERNEL_NAMES):
            classes["bn kernels"] += t
        elif any(k in low for k in CONV_NAMES):
            classes["convolutions"] += t
        else:
            classes["other"] += t
    return kernels, h2d_ms, total, classes


def phase_profile(torch, hyp="fb1", extra=(), base=FULL_WIDTH, wall_ms=None, warm_up=True,
                  bundle=None):
    """One step of ``base`` (full width) under torch.profiler, after a
    warm-up step outside it (none with ``warm_up=False``, where the process
    already ran the same shapes): device time by kernel class, and the
    device's busy share (that step's kernel time over the wall time of the
    next step, run without the profiler, or ``wall_ms`` where given; kernels
    run on one stream and do not overlap, the copies of a streamed epoch run
    on a side stream and are left out of the share and timed apart,
    ``h2d_ms``); peak memory over the steps. A stochastic recipe's step is
    its epoch of SGD updates."""
    from torch.profiler import ProfilerActivity, profile

    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    cfg = main_path_config(list(base) + list(extra), hyp)
    if bundle is None:
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=cfg.dryrun,
                                      seed=cfg.seed)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    training.configure_backends(cfg)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    state = training.TrainState(step=0, model=model,
                                optimizer=training.make_optimizer(model, cfg.hyp))
    step_fn = trainer.stochastic_step if cfg.hyp.train_stochastic else trainer.full_step

    def step():
        step_fn(state, *trainer.stage(state.step))

    torch.cuda.reset_peak_memory_stats()
    if warm_up:
        step()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.time() - t0)
    if wall_ms is None:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    kernels, h2d_ms, total, classes = device_time(prof)
    if not total:
        log("  the profiler recorded no device time")
        return None
    result = {"wall_ms": wall_ms, "traced_wall_ms": traced_ms, "device_ms": total,
              "busy_share": total / wall_ms, "by_class_ms": classes, "h2d_ms": h2d_ms,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "top": sorted(kernels, key=lambda k: -k[1])[:12]}
    log(f"  device {total:.1f} ms in the traced step (wall {traced_ms:.1f} ms under the "
        f"profiler); untraced step wall {wall_ms:.1f} ms; busy share {total / wall_ms:.3f}; "
        f"peak memory {result['peak_memory_gib']:.2f} GiB; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items())
        + (f"; pinned host-to-device copies {h2d_ms:.1f} ms" if h2d_ms else ""))
    for name, t, n in result["top"]:
        log(f"    {t:9.2f} ms  {n:6d}x  {name[:110]}")
    return result


# ---------------------------------------------------------------------------
# phases 6 and 7: hyp=gradreg, the gradient regularizer
# ---------------------------------------------------------------------------

GRADREG_VARIANT = "hyp.grad_reg.implementation={}"
# the autograd step and its trace over 4 of the epoch's 25 chunks: the trace
# of a whole epoch holds some 100,000 kernels, whose processing took most of
# phase 7's time
AUTOGRAD_CUT = ["data.size=8192"]


def phase_gradreg_fp32(torch, bn):
    """Phase 3's comparison for ``hyp=gradreg`` with ``forward-differences``
    (two gradients a chunk: exactly twice the launches) and ``autograd`` (an
    exact Hessian-vector product through BNTrain's double backward), then
    the double backward itself at the bench BN shapes."""
    for implementation in ("forward-differences", "autograd"):
        log(f"  {implementation}:")
        counts, doubles, chunks = kernels_against_plain_step(
            torch, bn, "gradreg", [GRADREG_VARIANT.format(implementation)])
        base = BN_LAYERS * chunks
        kernels = ("stats", "bwd_reduce", "bwd_apply")
        if implementation == "forward-differences":
            check(all(counts[k] == 2 * base for k in kernels),
                  f"launches {counts}, expected {2 * base} of each of {kernels}")
        else:
            check(all(counts[k] >= base for k in kernels) and doubles > 0,
                  f"launches {counts} and {doubles} double backwards, expected at least "
                  f"{base} of each of {kernels} and some double backwards")
    return phase_double_backward(torch, bn)


def phase_double_backward(torch, bn):
    """BNTrain differentiated twice (first order on the kernels, second order
    by BNTrainBackward's plain double backward) against
    ``bn_train_reference`` differentiated twice, float32, at ResNet-18's BN
    shapes for a chunk of 2048: every first- and second-order value within
    ``BN_TRAIN_TOL`` of its output's largest entry. Times: both routes'
    ``grad(create_graph=True)`` then ``grad`` of it, per layer."""
    dev = torch.device(DEVICE)
    rows = []
    for hw, c in STAGES:
        m = CHUNK * hw
        g = torch.Generator(device=dev).manual_seed(100 + c)

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev)

        x = (rand(m, c) * 1.5 + 0.3).requires_grad_()
        scale = (rand(c) * 0.5 + 1).requires_grad_()
        bias = rand(c).requires_grad_()
        cots = [rand(m, c).requires_grad_(), rand(c).requires_grad_(), rand(c).requires_grad_()]
        vs = [rand(m, c), rand(c)]

        def derivatives(fn):
            first = torch.autograd.grad(fn(x, scale, bias), (x, scale, bias), cots,
                                        create_graph=True)
            second = torch.autograd.grad(first[:2], (x, scale, *cots), vs)
            return [t.detach() for t in (*first, *second)]

        before, doubles = dict(bn.launches), bn.double_backward_calls
        ours = derivatives(bn.bn_train)
        torch.cuda.synchronize()
        launched = {k: bn.launches[k] - before[k] for k in before}
        check(launched == dict.fromkeys(before, 1) and bn.double_backward_calls == doubles + 1,
              f"double backward at C={c} launched {launched}")
        refs = derivatives(bn.bn_train_reference)
        errs = [((o.double() - r.double()).abs().max()
                 / r.double().abs().max().clamp_min(1e-30)).item() for o, r in zip(ours, refs)]
        row = {"m": m, "c": c, "max_rel_err": max(errs),
               "ms": cuda_ms(torch, lambda: derivatives(bn.bn_train), iters=3, warmup=1),
               "reference_ms": cuda_ms(torch, lambda: derivatives(bn.bn_train_reference),
                                       iters=3, warmup=1)}
        rows.append(row)
        log(f"  double backward M={m:8d} C={c:3d}: rel errs (dx, dscale, dbias, d2x, d2scale, "
            f"d2dy, d2dmean, d2dvar) {[f'{e:.1e}' for e in errs]} "
            f"(tol {BN_TRAIN_TOL['float32']:g} of max|reference|); "
            f"kernel route {row['ms']:.3f} ms, reference {row['reference_ms']:.3f} ms")
        check(max(errs) <= BN_TRAIN_TOL["float32"],
              f"BNTrain's double backward at M={m} C={c} disagrees with the reference's")
        del x, scale, bias, cots, vs, ours, refs
        torch.cuda.empty_cache()
    return rows


def phase_gradreg_full_width(torch, bn, fb1):
    """``hyp=gradreg`` (forward differences) at full width through
    ``training.train``: twice phase 4's launches of the kernels of the
    backward and of ``stats``; then its profile, one ``autograd`` step
    through ``training.train`` and that variant's profile, and the size of
    the regularizer under bf16 and in float32."""
    result = {"forward-differences": phase_full_width(torch, bn, "gradreg", passes=2)}
    for name in ("stats", "bwd_reduce", "bwd_apply"):
        ours, base = result["forward-differences"]["launches"][name], fb1["launches"][name]
        check(ours == 2 * base, f"{name}: {ours} launches, twice phase 4's is {2 * base}")
    result["forward-differences profile"] = phase_profile(torch, "gradreg")

    log("  one autograd step through training.train:")
    bn.reset_counts()
    _, _, _, _, stats = run_main_path(
        torch, FULL_WIDTH + AUTOGRAD_CUT + ["hyp.steps=1", GRADREG_VARIANT.format("autograd")],
        "gradreg")
    auto = {"step_s": stats["train_time"][0], "train_loss": stats["train_loss"][0],
            "valid_loss": stats["valid_loss"][0],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": dict(bn.launches), "vector_launches": dict(bn.vector_launches),
            "double_backward_calls": bn.double_backward_calls}
    log(f"  autograd step {auto['step_s']:.3f} s, train loss {auto['train_loss']:.4f}, "
        f"valid loss {auto['valid_loss']:.4f}, peak memory {auto['peak_memory_gib']:.2f} GiB, "
        f"launches {auto['launches']}, double backwards {auto['double_backward_calls']}")
    check(math.isfinite(auto["train_loss"]) and math.isfinite(auto["valid_loss"]),
          "non-finite autograd loss")
    check(auto["double_backward_calls"] > 0, "the autograd step ran no double backward")
    check(auto["vector_launches"] == auto["launches"],
          "an autograd-step launch did not take 16 bytes a thread")
    result["autograd"] = auto
    # the train() step above warmed the process for these shapes and timed
    # an untraced step: one traced step is enough
    result["autograd profile"] = phase_profile(torch, "gradreg",
                                               AUTOGRAD_CUT + [GRADREG_VARIANT.format("autograd")],
                                               wall_ms=1e3 * auto["step_s"], warm_up=False)
    result["regularizer size"] = regularizer_sizes(torch)
    return result


def regularizer_sizes(torch):
    """``||reg_fn(g) - g|| / ||g||`` for chunk 0 of the full-width epoch
    (2048 images, lr 0.8), on one set of weights: forward differences under
    bf16 autocast and in float32, and float32 ``autograd`` (exact); with
    each increment's cosine against the exact one."""
    from fullbatchtraining_tpu_torch.config import from_dict
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training
    from fullbatchtraining_tpu_torch.training.grad_reg import make_grad_regularizer, tree_sqnorm

    cases = [("bf16", "forward-differences", []),
             ("float32", "forward-differences", ["impl.mixed_precision=False"]),
             ("float32", "autograd", ["impl.mixed_precision=False"])]
    model, bundle, out, increments = None, None, {}, {}
    for compute, implementation, extra in cases:
        cfg = main_path_config(FULL_WIDTH + extra, "gradreg")
        if model is None:
            bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed)
            model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
        trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
        model.train()
        reg_fn = make_grad_regularizer(
            from_dict({**cfg.hyp.grad_reg, "implementation": implementation}), trainer.regrad)
        x, labels = trainer._normalize(trainer.images[0]), trainer.labels[0]
        grads = trainer.regrad(trainer.params, x, labels)
        regularized = reg_fn(grads, trainer.params, x, labels, None, trainer.schedule(0))
        increment = [r - g for r, g in zip(regularized, grads)]
        key = f"{compute} {implementation}"
        increments[key] = increment
        out[key] = {"ratio": (tree_sqnorm(increment) / tree_sqnorm(grads)).sqrt().item()}
        del trainer, grads, regularized, x
        torch.cuda.empty_cache()
    exact = increments["float32 autograd"]
    for key, increment in increments.items():
        dot = sum((a * b).sum() for a, b in zip(increment, exact))
        out[key]["cosine_with_exact"] = (dot / (tree_sqnorm(increment)
                                                * tree_sqnorm(exact)).sqrt()).item()
        log(f"  ||reg_fn(g) - g|| / ||g||, {key}: {out[key]['ratio']:.4e}; "
            f"increment's cosine with float32 autograd's {out[key]['cosine_with_exact']:.4f}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the SGD baseline, shuffled epochs, SAM and checkpoints
# ---------------------------------------------------------------------------

SGD_BATCHES = (128, 32)   # hyp=base_sgd's blocks; the paper's "FB in practice" chunks
SGD_EPOCH = ["hyp.warmup=0", "hyp.steps=1", "data.size=2048"]     # 16 updates, float32
SGD_FULL = ["hyp.steps=2"]                                         # the yaml as it stands
# Cuts of data size, not width, that keep the whole run within its time
# limit: the "FB in practice" step is host-bound at a fixed cost a chunk
# (about 0.1 s), so 195 of its 1562 chunks; a whole traced epoch costs
# minutes of the profiler's own work, so the profiled steps are shorter still
FB_PRACTICE = ["data.batch_size=32", "hyp.shuffle=True", "hyp.steps=1", "hyp.warmup=0",
               "impl.mixed_precision=True", "data.size=6_240"]   # hyp=gradreg, bf16
SGD_PROFILED = ["data.size=6400"]           # 50 updates, not 390
FB_PRACTICE_PROFILED = ["data.size=1024"]   # 32 chunks
SGD_UPDATES, FB_PRACTICE_CHUNKS = 390, 195  # 50,000 images in blocks of 128; 6,240 in 32s
KERNELS = ("stats", "bwd_reduce", "bwd_apply")


def phase_kernels_small(torch, bn):
    """8a: phase 2's check at the BN shapes of a block of 128 and a chunk of
    32 images, float32 and bfloat16, same tolerances; the host's time to
    issue a call (``host_ms``) beside each kernel's."""
    rows = []
    for images in SGD_BATCHES:
        log(f"  chunk of {images} images:")
        rows += phase_kernels(torch, bn, images)
    host_bound = [r for r in rows if "host_ms" in r and r["host_ms"] >= r["ms"]]
    log(f"  {len(host_bound)} of {sum('host_ms' in r for r in rows)} kernel calls take longer "
        f"to issue than to run (host_ms >= ms)")
    return rows


SAM = "hyp/optim_modification=SAM"
FLOAT64 = ["impl.dtype=float64", "impl.accumulation_dtype=float64"]
F64_TOL = 1e-10        # float64: kernels and plain versions differ in summation order only
CONTROL_EPS = 2.0 ** -20   # the control run's relative perturbation of the initial weights
CONTROL_FACTOR = 10


def sgd_epoch_run(torch, bn, extra, plain=False, perturb=0.0):
    """One ``SGD_EPOCH`` through ``training.train``, on the kernels or the
    plain versions, from the seed's weights, each multiplied by ``1 +-
    perturb``. Returns (initial state dict, final state, stats)."""
    import contextlib

    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    cfg = main_path_config(SGD_EPOCH + list(extra), "base_sgd")
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g).sign())
    initial = copy.deepcopy(model.state_dict())
    with bn.plain_versions() if plain else contextlib.nullcontext():
        state, stats = train(model, bundle, cfg, device=DEVICE)
    torch.cuda.synchronize()
    return initial, state, stats


def block_gaps(stats, ref):
    """Relative difference of each block's gradient norm, in update order."""
    keys = sorted((k for k in ref if k.startswith("grad_norm_train_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    return [abs(stats[k][0] - ref[k][0]) / abs(ref[k][0]) for k in keys]


def phase_sgd_epoch(torch, bn):
    """8b: ``hyp=base_sgd`` epochs of 16 shuffled updates (2048 images in
    blocks of 128), without and with SAM, on the kernels against
    ``plain_versions()``; each block launches ``stats``, ``bwd_reduce`` and
    ``bwd_apply`` once a BN layer, twice under SAM.

    float32: the first update's gradient norm within phase 3's 1e-4. Later
    updates start from params that differ, and a float32 trajectory is that
    sensitive of itself: a plain-version run from weights off by
    ``CONTROL_EPS`` diverges from the plain run as far. So each later
    block's gap is logged beside that control's, and the largest must stay
    within ``CONTROL_FACTOR`` times the control's largest.
    float64: every block's gradient norm, the losses, the running stats and
    the params (relative to the whole update) within ``F64_TOL``."""
    result = {}
    for name, extra in (("sgd", []), ("sam", [SAM])):
        passes = 2 if name == "sam" else 1
        bn.reset_counts()
        _, _, kstats = sgd_epoch_run(torch, bn, extra)
        counts = dict(bn.launches)
        _, _, pstats = sgd_epoch_run(torch, bn, extra, plain=True)
        _, _, cstats = sgd_epoch_run(torch, bn, extra, plain=True, perturb=CONTROL_EPS)
        check(bn.launches == counts, "plain_versions() still launched kernels")
        gaps, control = block_gaps(kstats, pstats), block_gaps(cstats, pstats)
        blocks = len(gaps)
        log(f"  {name} float32: launches {counts}")
        log(f"    gradient norm of each update's block, kernels vs plain: "
            + " ".join(f"{g:.1e}" for g in gaps))
        log(f"    plain from weights off by {CONTROL_EPS:.1e}, vs plain:        "
            + " ".join(f"{g:.1e}" for g in control))
        check(all(counts[k] == passes * BN_LAYERS * blocks for k in KERNELS),
              f"{name} epoch launches {counts}, expected {passes * BN_LAYERS * blocks} of "
              f"each of {KERNELS}")
        check(gaps[0] <= 1e-4, f"{name}: the first update's gradients differ by {gaps[0]:.2e}")
        check(max(gaps) <= CONTROL_FACTOR * max(control),
              f"{name}: kernels vs plain diverge by {max(gaps):.2e}, more than "
              f"{CONTROL_FACTOR} x the control's {max(control):.2e}")

        initial, kstate, kstats64 = sgd_epoch_run(torch, bn, extra + FLOAT64)
        _, pstate, pstats64 = sgd_epoch_run(torch, bn, extra + FLOAT64, plain=True)
        gaps64 = block_gaps(kstats64, pstats64)
        losses = max(abs(kstats64[k][0] - pstats64[k][0]) / abs(pstats64[k][0])
                     for k in ("train_loss", "full_loss", "valid_loss"))
        ks, ps = ({k: v.double().cpu() for k, v in st.model.state_dict().items()}
                  for st in (kstate, pstate))
        params = max(((ks[k] - ps[k]).norm() / (ps[k] - initial[k]).norm().clamp_min(1e-300)
                      ).item() for k in ps if "running" not in k)
        running = max(((ks[k] - ps[k]).norm() / ps[k].norm().clamp_min(1e-300)).item()
                      for k in ps if "running" in k)
        log(f"  {name} float64: worst block gradient norm {max(gaps64):.1e}, losses {losses:.1e}, "
            f"params {params:.1e} of the update, running stats {running:.1e} (tol {F64_TOL:g})")
        check(max(max(gaps64), losses, params, running) <= F64_TOL,
              f"{name}: float64 kernels and plain versions differ")
        result[name] = {"launches": counts, "float32_gaps": gaps, "control_gaps": control,
                        "float64": {"gaps": gaps64, "losses": losses, "params": params,
                                    "running_stats": running}}
    return result


def phase_sgd_full_width(torch, bn):
    """8c: ``hyp=base_sgd`` as its yaml has it through ``training.train``
    (float32, shuffled, 50,000 images in blocks of 128), 2 steps of 390
    updates: ``stats``, ``bwd_reduce`` and ``bwd_apply`` 20 x 390 a step,
    ``apply`` that plus 20 x 79 an evaluation, all at 16 bytes a thread;
    then the profile of an epoch cut to ``SGD_PROFILED``."""
    from fullbatchtraining_tpu_torch.data import epoch_layout

    bn.reset_counts()
    cfg, bundle, _, _, stats = run_main_path(torch, SGD_FULL, "base_sgd")
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    blocks, _, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    evals, steps = len(stats["valid_loss"]), len(stats["train_loss"])
    eval_blocks = -(-len(bundle.valid) // bundle.batch_size)
    per_step = BN_LAYERS * blocks
    result = {"step_s": stats["train_time"], "updates_per_step": blocks,
              "images_per_s": [blocks * sub / t for t in stats["train_time"]],
              "ms_per_update": [1e3 * t / blocks for t in stats["train_time"]],
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "valid_acc": stats["valid_acc"], "launches": counts, "vector_launches": wide,
              "evals": evals}
    for i, t in enumerate(stats["train_time"]):
        log(f"  step {i + 1}: {t:.3f} s, {blocks} updates, {1e3 * t / blocks:.2f} ms an update, "
            f"train loss {stats['train_loss'][i]:.4f}")
    log(f"  valid loss {stats['valid_loss']}; peak memory {result['peak_memory_gib']:.2f} GiB; "
        f"launches {counts}; at 16 bytes a thread {wide}")
    check(steps == 2 and evals == 2 and blocks == SGD_UPDATES,
          f"{steps} steps of {blocks} updates and {evals} evaluations, expected 2, "
          f"{SGD_UPDATES} and 2")
    for name in KERNELS:
        check(counts[name] == per_step * steps,
              f"{name}: {counts[name]} launches, expected {per_step} per step")
    check(counts["apply"] == per_step * steps + BN_LAYERS * eval_blocks * evals,
          f"apply: {counts['apply']} launches, expected {per_step} per step + "
          f"{BN_LAYERS * eval_blocks} per evaluation")
    check(wide == counts, f"launches {counts}, of them at 16 bytes a thread {wide}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    log(f"  profile of an epoch cut to {SGD_PROFILED}:")
    result["profile"] = phase_profile(torch, "base_sgd", SGD_PROFILED, base=SGD_FULL)
    return result


def phase_fb_practice(torch, bn, fb1):
    """8d: the paper's "FB in practice" step, ``hyp=gradreg
    data.batch_size=32 hyp.shuffle=True`` at full width, one bf16 step through
    ``training.train`` on ``FB_PRACTICE``'s cut of the data: exactly 2 x 20
    launches of ``stats``, ``bwd_reduce`` and ``bwd_apply`` a chunk, all at
    16 bytes a thread; its busy share on a profiled step cut to
    ``FB_PRACTICE_PROFILED``. Then
    one shuffled ``hyp=fb1`` full-width step, whose launches equal phase
    4's per step, and the time of its epoch gather."""
    from fullbatchtraining_tpu_torch.data import construct_databundle, epoch_layout
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    bn.reset_counts()
    cfg, bundle, _, _, stats = run_main_path(torch, FB_PRACTICE, "gradreg")
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    result = {"step_s": stats["train_time"][0], "chunks": blocks * chunks,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "launches": counts, "vector_launches": wide}
    log(f"  step {result['step_s']:.3f} s over {blocks * chunks} chunks of {sub} "
        f"({1e3 * result['step_s'] / (blocks * chunks):.2f} ms a chunk); train loss "
        f"{stats['train_loss'][0]:.4f}, valid loss {stats['valid_loss'][0]:.4f}; peak memory "
        f"{result['peak_memory_gib']:.2f} GiB; launches {counts}")
    check(blocks * chunks == FB_PRACTICE_CHUNKS and sub == 32,
          f"{blocks * chunks} chunks of {sub}")
    for name in KERNELS:
        check(counts[name] == 2 * BN_LAYERS * FB_PRACTICE_CHUNKS,
              f"{name}: {counts[name]} launches, expected {2 * BN_LAYERS * FB_PRACTICE_CHUNKS}")
    check(wide == counts, f"launches {counts}, of them at 16 bytes a thread {wide}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    log(f"  profile of the step cut to {FB_PRACTICE_PROFILED}:")
    result["profile"] = phase_profile(torch, "gradreg", FB_PRACTICE_PROFILED, base=FB_PRACTICE)

    log("  one shuffled hyp=fb1 full-width step:")
    bn.reset_counts()
    cfg, bundle, _, _, stats = run_main_path(torch, FULL_WIDTH + ["hyp.steps=1",
                                                                  "hyp.shuffle=True"])
    counts = dict(bn.launches)
    expected = fb1_step_launches(fb1)
    check(counts == expected, f"shuffled fb1 step launches {counts}, phase 4's a step {expected}")
    check(dict(bn.vector_launches) == counts, "a shuffled fb1 launch took narrow accesses")
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    gather = {"ms": cuda_ms(torch, lambda: trainer.stage(1), iters=10),
              "host_ms": host_ms(torch, lambda: trainer.stage(1), iters=10),
              "bytes": 2 * trainer.images.numel()}
    result["fb1_shuffled"] = {"step_s": stats["train_time"][0], "launches": counts,
                              "gather": gather}
    log(f"  shuffled fb1 step {stats['train_time'][0]:.3f} s, launches {counts} (phase 4's a "
        f"step); epoch gather {gather['ms']:.3f} ms (host {gather['host_ms']:.3f} ms) for "
        f"{gather['bytes'] / 1e6:.1f} MB read and written")
    del trainer, model
    torch.cuda.empty_cache()
    return result


def phase_resume(torch):
    """8e: ``FP32_STEP`` with 2 steps and Nesterov momentum
    (``hyp.scheduler=none``: the cut run has fewer ``hyp.steps``), straight
    through and as 1 step saved by the async writer, then a fresh model
    resumed to step 2: params, momentum buffers, running stats and stats
    must be bitwise equal."""
    import shutil

    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    folder = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    file = folder / "checkpoints" / "resume.ckpt"

    def run(steps, extra=()):
        cfg = main_path_config(FP32_STEP + ["hyp.scheduler=none", f"hyp.steps={steps}",
                                            *extra])
        cfg.original_cwd = str(folder)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed)
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
        state, stats = train(model, bundle, cfg, device=DEVICE)
        torch.cuda.synchronize()
        return state, stats

    straight, straight_stats = run(2)
    run(1, ["impl.checkpoint.name=resume.ckpt", "impl.checkpoint.async_save=True"])
    saved = torch.load(file, map_location="cpu", weights_only=True)
    check(saved["step"] == 1, f"the async checkpoint holds step {saved['step']}")
    resumed, resumed_stats = run(2, ["impl.checkpoint.name=resume.ckpt"])
    tensors = {**{f"model/{k}": v for k, v in straight.model.state_dict().items()},
               **{f"momentum/{i}": s["momentum_buffer"]
                  for i, s in enumerate(straight.optimizer.state.values())}}
    theirs = {**{f"model/{k}": v for k, v in resumed.model.state_dict().items()},
              **{f"momentum/{i}": s["momentum_buffer"]
                 for i, s in enumerate(resumed.optimizer.state.values())}}
    check(tensors.keys() == theirs.keys() and any(k.startswith("momentum") for k in tensors),
          "the resumed run has other tensors or no momentum buffers")
    differ = [k for k in tensors if not torch.equal(tensors[k], theirs[k])]
    stats_differ = [k for k, v in resumed_stats.items()
                    if k != "train_time" and v != straight_stats[k][1:]]
    size_mb = file.stat().st_size / 1e6
    shutil.rmtree(folder, ignore_errors=True)
    log(f"  {len(tensors)} tensors (params, running stats, momentum buffers): "
        f"{len(differ)} differ; stats of step 2 that differ: {stats_differ}; async checkpoint "
        f"of {size_mb:.1f} MB loads at step {saved['step']}")
    check(not differ, f"resumed tensors differ from the straight run's: {differ[:5]}")
    check(not stats_differ, f"resumed stats differ: {stats_differ}")
    return {"tensors": len(tensors), "differ": differ, "stats_differ": stats_differ,
            "checkpoint_mb": size_mb}


# ---------------------------------------------------------------------------
# phase 9: the baked 10x CIFAR store, semi-stochastic rounds
# ---------------------------------------------------------------------------

BAKED_DIR = ROOT / "build" / "chip_smoke_baked"
BAKE_ROUNDS = 10
# the train.sh lines' store, temporary: the run removes it
BAKED = ["data/db=baked", "data.augmentations_train=", f"data.db.rounds={BAKE_ROUNDS}",
         f"data.db.path={BAKED_DIR}", "data.db.temporary_database=True"]
SEMI = ["hyp.train_semi_stochastic=True"]
BAKED_FP32 = BAKED + ["data.db.rounds=2"] + SEMI   # with FP32_STEP: 2 rounds of 8192
BAKE_SAMPLES = 512    # images a round checked against their crop/flip windows
BAKE_PAD, BAKE_SIZE = 4, 32   # config/data/db/baked.yaml: RandomCrop [32, 4], flip 0.5


def is_window(torch, images, sources, pad=BAKE_PAD):
    """Per image: is it one of its source's ``(2 pad + 1)^2`` crop windows
    of the zero-padded source, or their mirror images (162 at pad 4)?"""
    padded = torch.nn.functional.pad(sources, (0, 0, pad, pad, pad, pad))
    size = sources.shape[1]
    found = torch.zeros(len(images), dtype=torch.bool, device=images.device)
    for y in range(2 * pad + 1):
        for x in range(2 * pad + 1):
            crop = padded[:, y:y + size, x:x + size]
            for window in (crop, crop.flip(2)):
                found |= (window == images).flatten(1).all(1)
    return found


def phase_bake(torch):
    """9a: bake ``BAKED``'s store from the synthetic CIFAR-10 training set
    through ``bake_dataset`` (which ``construct_databundle`` calls) and check
    it."""
    import atexit
    import shutil

    import numpy as np

    from fullbatchtraining_tpu_torch.data import augmentations, baked, construct_datasets

    atexit.register(shutil.rmtree, BAKED_DIR, True)
    cfg = main_path_config(FULL_WIDTH + BAKED)
    train, _ = construct_datasets(cfg.data)
    devices = set()
    crop_flip = augmentations.crop_flip

    def recording(images, *args):
        devices.add(images.device.type)
        return crop_flip(images, *args)

    augmentations.crop_flip = recording
    try:
        t0 = time.time()
        folder = baked.bake_dataset(train, cfg.data, cfg.data.db, seed=cfg.seed, device=DEVICE)
        seconds = time.time() - t0
    finally:
        augmentations.crop_flip = crop_flip
    store = baked.BakedDataset(folder)
    n = len(train)
    written = store.images.nbytes + store.labels.nbytes
    result = {"seconds": seconds, "gb_written": written / 1e9,
              "gb_per_s": written / 1e9 / seconds, "shape": list(store.images.shape),
              "augmentation_devices": sorted(devices), "folder": folder.name}
    log(f"  baked {folder.name}: {store.images.shape} in {seconds:.2f} s, "
        f"{written / 1e9:.3f} GB written, {written / 1e9 / seconds:.3f} GB/s; "
        f"augmentation ran on {sorted(devices)}")
    check(store.images.shape == (BAKE_ROUNDS, n, BAKE_SIZE, BAKE_SIZE, 3),
          f"store shape {store.images.shape}")
    check(store.meta == {"name": "CIFAR10", "rounds": BAKE_ROUNDS, "size": n,
                         "shape": [BAKE_SIZE, BAKE_SIZE, 3], "classes": 10,
                         "first_round_clean": False, "shuffle_while_writing": True},
          f"store meta {store.meta}")
    check(devices == {torch.device(DEVICE).type}, f"the bake augmented on {devices}")
    rng, pick = np.random.default_rng(cfg.seed), np.random.default_rng(1)
    bad = []
    for r in range(BAKE_ROUNDS):
        order = rng.permutation(n)    # the bake's order of round r
        check(np.array_equal(store.labels[r], train.labels[order]),
              f"round {r}'s labels are not the source's in the round's order")
        rows = np.sort(pick.choice(n, BAKE_SAMPLES, replace=False))
        images = torch.from_numpy(np.asarray(store.images[r][rows])).to(DEVICE)
        sources = torch.from_numpy(train.images[order[rows]]).to(DEVICE)
        bad.append(int((~is_window(torch, images, sources)).sum()))
    result["images_not_a_window"] = bad
    log(f"  labels of every round in its order; of {BAKE_SAMPLES} sampled images a round, "
        f"not one of their source's 162 crop/flip windows: {bad}")
    check(not any(bad), f"baked images that are no crop/flip window of their source: {bad}")
    return result


def upload_timer(torch):
    """Wrap ``training.upload_rows``: every call's seconds, synchronised."""
    from fullbatchtraining_tpu_torch.training import training

    original, seconds = training.upload_rows, []

    def timed(*args, **kwargs):
        t0 = time.time()
        out = original(*args, **kwargs)
        if out.is_cuda:
            torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        return out

    training.upload_rows = timed
    return seconds, lambda: setattr(training, "upload_rows", original)


def phase_baked_fb1(torch, bn, fb1):
    """9b, ``fb_10_1``: one ``hyp=fb1`` step over the flat store as phase 4
    runs it (bf16, blocks and chunks of 2048): phase 4's launches a chunk
    and an evaluation, all at 16 bytes a thread."""
    from fullbatchtraining_tpu_torch.data import epoch_layout

    bn.reset_counts()
    uploads, restore = upload_timer(torch)
    try:
        cfg, bundle, _, _, stats = run_main_path(torch, FULL_WIDTH + BAKED + ["hyp.steps=1"])
    finally:
        restore()
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    fb1_chunks = fb1["chunks_per_step"]
    per_chunk = {k: fb1["launches"][k] // (3 * fb1_chunks) for k in KERNELS}
    eval_apply = (fb1["launches"]["apply"] - fb1["launches"]["stats"]) // fb1["evals"]
    expected = {**{k: per_chunk[k] * blocks * chunks for k in KERNELS},
                "apply": per_chunk["stats"] * blocks * chunks + eval_apply}
    store_bytes = blocks * chunks * sub * 3 * BAKE_SIZE ** 2
    result = {"step_s": stats["train_time"][0], "images": blocks * chunks * sub,
              "upload_s": uploads, "store_device_bytes": store_bytes,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "launches": counts, "vector_launches": wide,
              "chunks_vs_phase_4": blocks * chunks / fb1_chunks}
    log(f"  step {result['step_s']:.3f} s over {blocks * chunks} chunks of {sub} "
        f"({result['images']} images, {result['chunks_vs_phase_4']:.3f}x phase 4's chunks); "
        f"store upload {uploads} s for {store_bytes / 1e9:.3f} GB on the card; peak memory "
        f"{result['peak_memory_gib']:.2f} GiB; train loss {stats['train_loss'][0]:.4f}, "
        f"valid loss {stats['valid_loss'][0]:.4f}; launches {counts}")
    check(counts == expected, f"fb_10_1 launches {counts}, phase 4's a chunk gives {expected}")
    check(wide == counts, f"launches {counts}, of them at 16 bytes a thread {wide}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    return result


def phase_baked_sgd(torch, bn, sgd):
    """9c, ``SGD_10_CIFAR``: ``hyp=base_sgd hyp.train_semi_stochastic=True``
    as its yaml has it, 2 steps: phase 8c's launches exactly, and each
    step's staged rows bitwise the host gather of round ``step % rounds``
    from the memmap in the step's order. Returns the result and the staged
    rows of step 1 for 9e."""
    from fullbatchtraining_tpu_torch.data import epoch_order
    from fullbatchtraining_tpu_torch.training import training

    staged, stage = {}, training.Trainer.stage

    def recording(self, step):
        out = stage(self, step)
        staged[step] = (self, out)
        return out

    bn.reset_counts()
    training.Trainer.stage = recording
    try:
        cfg, bundle, _, _, stats = run_main_path(torch, SGD_FULL + BAKED + SEMI, "base_sgd")
    finally:
        training.Trainer.stage = stage
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    trainer = staged[0][0]
    n, rows = bundle.baked.meta["size"], trainer.num_blocks * trainer.chunks
    check(trainer.semi and trainer.images is not None and sorted(staged) == [0, 1],
          "9c did not stage steps 0 and 1 from the resident store")
    equal = []
    for step, (_, (images, labels)) in sorted(staged.items()):
        order = epoch_order(cfg.seed, step, n)[:rows * trainer.sub]
        host = bundle.baked.round(step)
        equal.append(torch.equal(images.flatten(0, 1),
                                 torch.from_numpy(host.images[order]).to(images.device))
                     and torch.equal(labels.flatten(0, 1).cpu(),
                                     torch.from_numpy(host.labels[order]).long()))
    gather = {"ms": cuda_ms(torch, lambda: trainer.stage(1), iters=10),
              "host_ms": host_ms(torch, lambda: trainer.stage(1), iters=10),
              "bytes": 2 * rows * trainer.sub * trainer.images[0].numel()}
    result = {"step_s": stats["train_time"], "updates_per_step": trainer.num_blocks,
              "ms_per_update": [1e3 * t / trainer.num_blocks for t in stats["train_time"]],
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "store_device_bytes": trainer.images.numel(), "staged_equal_host": equal,
              "gather": gather, "train_loss": stats["train_loss"],
              "valid_loss": stats["valid_loss"], "launches": counts}
    for i, t in enumerate(stats["train_time"]):
        log(f"  step {i + 1} (round {i}): {t:.3f} s, {1e3 * t / trainer.num_blocks:.2f} ms an "
            f"update, train loss {stats['train_loss'][i]:.4f}")
    log(f"  staged rows bitwise the host gather of each step's round: {equal}; gather "
        f"{gather['ms']:.3f} ms (host {gather['host_ms']:.3f} ms) for "
        f"{gather['bytes'] / 1e6:.1f} MB read and written; store {trainer.images.numel() / 1e9:.3f} "
        f"GB on the card; peak memory {result['peak_memory_gib']:.2f} GiB; launches {counts}")
    check(all(equal), f"staged rows differ from the host gather: {equal}")
    check(counts == sgd["launches"], f"SGD_10_CIFAR launches {counts}, phase 8c's {sgd['launches']}")
    check(wide == counts, f"launches {counts}, of them at 16 bytes a thread {wide}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    resident = staged[1][1]
    del staged, trainer
    torch.cuda.empty_cache()
    return result, resident


def phase_baked_host_path(torch, resident):
    """9e: ``impl.device_shuffle_max_bytes`` below the store's size keeps it
    on the host; step 1 stages bitwise the rows of 9c's resident step 1."""
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    cfg = main_path_config(SGD_FULL + BAKED + SEMI, "base_sgd")
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed, device=DEVICE)
    cfg.impl.device_shuffle_max_bytes = bundle.train.images.nbytes - 1
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    check(trainer.semi and trainer.images is None, "9e's store went to the card")
    images, labels = trainer.stage(1)
    same = torch.equal(images, resident[0]) and torch.equal(labels, resident[1])
    result = {"equal_to_resident": same,
              "stage_ms": cuda_ms(torch, lambda: trainer.stage(1), iters=3, warmup=1)}
    log(f"  host path, step 1: staged rows bitwise the resident path's: {same}; staging "
        f"{result['stage_ms']:.1f} ms (the round gathered on the host and uploaded)")
    check(same, "the host path stages other rows than the resident path")
    return result


# ---------------------------------------------------------------------------
# phase 10: data parallelism
# ---------------------------------------------------------------------------

DIST_DIR = ROOT / "build" / "chip_smoke_dist"
RANK_TIMEOUT = 300     # seconds for 10b's two rank processes
MULTINODE = ["model=resnet152", "hyp.steps=1", "data.size=2560"]   # 20 chunks of 128
# unaugmented: two ranks draw other crops than one process does
DIST_STEP = FP32_STEP + ["data.augmentations_train="]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_config(size=1, rank=0, port=None):
    return ["impl/setup=distributed", f"impl.setup.url=127.0.0.1:{port or free_port()}",
            f"impl.setup.world_size={size}", f"impl.setup.rank={rank}"]


def all_reduce_timer(torch):
    """Wrap ``torch.distributed.all_reduce``: each call's bytes, CUDA-event
    ms (synchronised after the call) and an empty tensor of its shape and
    dtype."""
    import torch.distributed as dist

    original, seen = dist.all_reduce, []

    def timed(tensor, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(tensor, *args, **kwargs)
        end.record()
        end.synchronize()
        seen.append((tensor.numel() * tensor.element_size(), start.elapsed_time(end),
                     torch.empty_like(tensor)))
        return out

    dist.all_reduce = timed
    return seen, lambda: setattr(dist, "all_reduce", original)


def fb1_step_launches(fb1):
    """Phase 4's launches of one step and one evaluation."""
    per_step = {k: fb1["launches"][k] // 3 for k in KERNELS}
    eval_apply = (fb1["launches"]["apply"] - fb1["launches"]["stats"]) // fb1["evals"]
    return {**per_step, "apply": per_step["stats"] + eval_apply}


def phase_dist_one(torch, bn, fb1):
    """10a: phase 4's step (1 step, bf16) in an NCCL group of one, set up by
    ``parallel.setup_distributed`` as the CLI sets it up, then the same step
    without the group: params, running stats and stats bitwise equal."""
    import torch.distributed as dist

    from fullbatchtraining_tpu_torch import parallel

    step = FULL_WIDTH + ["hyp.steps=1"]
    extra = step + dist_config()
    world = parallel.setup_distributed(main_path_config(extra).impl.setup, DEVICE)
    try:
        check(world.size == 1 and dist.get_backend() == "nccl",
              f"a group of {world.size} on {dist.get_backend()}")
        bn.reset_counts()
        parallel.reset_counts()
        seen, restore = all_reduce_timer(torch)
        try:
            _, _, _, dstate, dstats = run_main_path(torch, extra)
        finally:
            restore()
        counts, calls = dict(bn.launches), dict(parallel.calls)
        # the step's all_reduce, the group's first, includes NCCL's set-up of
        # its communicator: time the same bucket warm
        bucket = seen[0][2].zero_()
        warm_ms = cuda_ms(torch, lambda: dist.all_reduce(bucket, group=world.group), iters=20)
    finally:
        parallel.shutdown(world)
    _, _, _, state, stats = run_main_path(torch, step)
    ours, ref = dstate.model.state_dict(), state.model.state_dict()
    differ = [k for k in ref if not torch.equal(ours[k], ref[k])]
    stats_differ = [k for k in stats if k != "train_time" and stats[k] != dstats[k]]
    evals = len(dstats["valid_loss"])
    result = {"step_s": dstats["train_time"][0], "step_s_without_group": stats["train_time"][0],
              "phase_4_step_s": fb1["step_s"], "launches": counts, "collectives": calls,
              "bucket_bytes": seen[0][0], "all_reduce_ms": seen[0][1],
              "warm_all_reduce_ms": warm_ms,
              "eval_all_reduce_ms": [ms for _, ms, _ in seen[1:]],
              "tensors_differ": differ, "stats_differ": stats_differ}
    log(f"  step {result['step_s']:.3f} s in the group, {result['step_s_without_group']:.3f} s "
        f"without (phase 4: {', '.join(f'{t:.3f}' for t in fb1['step_s'])} s); bucket "
        f"{seen[0][0] / 1e6:.1f} MB, all_reduce {seen[0][1]:.3f} ms (warm {warm_ms:.4f} ms; "
        f"evaluation {[f'{ms:.3f}' for ms in result['eval_all_reduce_ms']]} ms); "
        f"collectives {calls}; "
        f"launches {counts}; {len(differ)} of {len(ref)} tensors and stats {stats_differ} differ")
    check(not differ and not stats_differ,
          f"the step in a group of one differs: tensors {differ[:5]}, stats {stats_differ}")
    check(calls == {"all_reduce": 1 + evals, "all_gather": 0, "broadcast": 0, "barrier": 0},
          f"collectives {calls}, expected 1 all_reduce for the step and 1 an evaluation")
    check(counts == fb1_step_launches(fb1),
          f"launches {counts}, phase 4's a step {fb1_step_launches(fb1)}")
    return result


def rank_command(rank, port, out):
    return [sys.executable, str(Path(__file__).resolve()), "--rank", str(rank),
            "--port", str(port), "--out", str(out)]


def rank_main(torch, rank, port, out) -> int:
    """One of 10b's two gloo ranks on this card: ``DIST_STEP``; writes its
    launches, collectives, stats and a digest of its params to ``out``
    (rank 0 also its state dict, beside it)."""
    import hashlib

    from fullbatchtraining_tpu_torch import parallel
    from fullbatchtraining_tpu_torch.ops import bn

    extra = DIST_STEP + dist_config(2, rank, port)
    world = parallel.setup_distributed(main_path_config(extra).impl.setup, "cuda:0", "gloo")
    try:
        bn.reset_counts()
        parallel.reset_counts()
        _, _, _, state, stats = run_main_path(torch, extra)
        launches, calls = dict(bn.launches), dict(parallel.calls)
    finally:
        parallel.shutdown(world)
    digest = hashlib.sha256()
    for p in state.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    if rank == 0:
        torch.save(state.model.state_dict(), Path(out).with_suffix(".pt"))
    Path(out).write_text(json.dumps({"rank": rank, "launches": launches, "collectives": calls,
                                     "stats": stats, "params_sha256": digest.hexdigest()}))
    return 0


def spawn_ranks(commands, logs, timeout):
    """Run ``commands`` together; kill every one once one fails or ``timeout``
    s pass. Returns their exit codes."""
    procs = []
    try:
        for command, log_file in zip(commands, logs):
            with open(log_file, "w") as out:
                procs.append(subprocess.Popen(command, cwd=ROOT, stdout=out,
                                              stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def phase_dist_two(torch, bn):
    """10b: ``DIST_STEP`` (phase 3's float32 step, unaugmented) as two gloo
    ranks sharing the card (8 chunks of 512 a rank) against one process (16
    chunks)."""
    import shutil

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    port, outs = free_port(), [DIST_DIR / f"rank{r}.json" for r in range(2)]
    logs = [DIST_DIR / f"rank{r}.log" for r in range(2)]
    t0 = time.time()
    codes = spawn_ranks([rank_command(r, port, outs[r]) for r in range(2)], logs, RANK_TIMEOUT)
    wall = time.time() - t0
    for r, code in enumerate(codes):
        if code != 0:
            log(f"  rank {r} exited {code}:\n" + logs[r].read_text()[-4000:])
    check(codes == [0, 0], f"the two ranks exited {codes}")
    ranks = [json.loads(out.read_text()) for out in outs]
    rank0 = torch.load(outs[0].with_suffix(".pt"), map_location="cpu", weights_only=True)
    bn.reset_counts()
    _, _, initial, state, stats = run_main_path(torch, DIST_STEP)
    one = dict(bn.launches)
    two = ranks[0]["stats"]
    loss_gap = abs(two["train_loss"][0] - stats["train_loss"][0]) / abs(stats["train_loss"][0])
    norm_gap = (abs(two["grad_norm"][0] * math.sqrt(2) - stats["grad_norm"][0])
                / stats["grad_norm"][0])
    chunks = sum(k.startswith("grad_norm_train_") for k in stats)
    # rank r's chunk b is chunk 2b + r of the one process's epoch
    slot_gap = max(abs(two[f"grad_norm_train_{r * (chunks // 2) + b}"][0]
                       - stats[f"grad_norm_train_{2 * b + r}"][0])
                   / stats[f"grad_norm_train_{2 * b + r}"][0]
                   for r in range(2) for b in range(chunks // 2))
    ref = {k: v.double().cpu() for k, v in state.model.state_dict().items()}
    worst = max(((rank0[k].double() - ref[k]).norm()
                 / (ref[k] - initial[k].double()).norm().clamp_min(1e-30)).item()
                for k in ref if "running" not in k)
    result = {"wall_s": wall, "step_s": [r["stats"]["train_time"][0] for r in ranks],
              "step_s_one_process": stats["train_time"][0], "train_loss_gap": loss_gap,
              "grad_norm_gap": norm_gap, "chunk_norm_gap": slot_gap, "params_of_update": worst,
              "launches": [r["launches"] for r in ranks], "launches_one_process": one,
              "collectives": [r["collectives"] for r in ranks],
              "params_equal": ranks[0]["params_sha256"] == ranks[1]["params_sha256"]}
    log(f"  2 ranks in {wall:.1f} s (steps {result['step_s']} s; one process "
        f"{result['step_s_one_process']:.3f} s); train_loss {loss_gap:.2e} (tol 1e-5), "
        f"grad_norm * sqrt(2) {norm_gap:.2e} (tol 1e-4), {chunks} chunk norms by slot "
        f"{slot_gap:.2e} (tol 1e-4), params {worst:.2e} of the update (tol 1e-3); launches "
        f"{result['launches']} against {one}; collectives {result['collectives']}; ranks' "
        f"params bitwise equal: {result['params_equal']}")
    check(loss_gap <= 1e-5 and norm_gap <= 1e-4 and slot_gap <= 1e-4 and worst <= 1e-3,
          "two ranks disagree with one process")
    check(all(2 * r["launches"][k] == one[k] for r in ranks for k in KERNELS),
          f"launches a rank {result['launches']}, not half of {one}")
    check(result["params_equal"], "the two ranks end with different params")
    check(all(c == {"all_reduce": 2, "all_gather": 0, "broadcast": 0, "barrier": 0}
              for c in result["collectives"]),
          f"collectives {result['collectives']}, expected 1 all_reduce a step and 1 an evaluation")
    return result


def phase_dist_resnet152(torch, bn):
    """10c: ``train_distributed_multinode.sh:8`` (``hyp=gradreg model=resnet152
    impl/setup=distributed``, float32, chunks of 128, forward differences) in
    an NCCL group of one, cut in data to 20 chunks, 1 step: 2 passes x the
    model's BN layers x 20 launches of ``stats``, ``bwd_reduce`` and
    ``bwd_apply``."""
    from fullbatchtraining_tpu_torch import parallel
    from fullbatchtraining_tpu_torch.data import epoch_layout
    from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d

    extra = MULTINODE + dist_config()
    world = parallel.setup_distributed(main_path_config(extra, "gradreg").impl.setup, DEVICE)
    try:
        bn.reset_counts()
        cfg, bundle, _, state, stats = run_main_path(torch, extra, "gradreg")
        counts = dict(bn.launches)
    finally:
        parallel.shutdown(world)
    layers = sum(isinstance(m, BatchNorm2d) for m in state.model.modules())
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    result = {"step_s": stats["train_time"][0], "chunks": blocks * chunks, "sub": sub,
              "ms_per_chunk": 1e3 * stats["train_time"][0] / (blocks * chunks),
              "bn_layers": layers, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "launches": counts}
    log(f"  ResNet-152, {layers} BN layers: step {result['step_s']:.3f} s over "
        f"{blocks * chunks} chunks of {sub} ({result['ms_per_chunk']:.1f} ms a chunk); peak "
        f"memory {result['peak_memory_gib']:.2f} GiB; train loss {stats['train_loss'][0]:.4f}, "
        f"valid loss {stats['valid_loss'][0]:.4f}; launches {counts}")
    check(blocks * chunks == 20 and sub == 128, f"{blocks * chunks} chunks of {sub}")
    for name in KERNELS:
        check(counts[name] == 2 * layers * 20,
              f"{name}: {counts[name]} launches, expected 2 x {layers} x 20")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    return result


# ---------------------------------------------------------------------------
# phase 11: TinyImageNet, ImageNet's transforms, streamed epochs
# ---------------------------------------------------------------------------

# data=TinyImageNet hyp=fb1 at FULL_WIDTH's chunks: 100,000 synthetic images
# of 64x64, 48 chunks of 2048, resident (1.208 GB laid out)
TINY = ["data=TinyImageNet", "hyp.warmup=0", "hyp.steps=2", "data.batch_size=2048",
        "hyp.sub_batch=2048", "impl.mixed_precision=True"]
TINY_STREAMED = ["impl.hbm_epoch_max_bytes=536870912"]     # 5 blocks a segment
SHUFFLED = ["hyp.shuffle=True", "hyp.steps=1"]
# data=ImageNet as its yaml has it (batch 128, RandomResizedCrop 224, Resize
# 256 + CenterCrop 224), cut in size to 4,096 images and their 1,000
# validation images; epoch (617 MB) and validation set (154 MB) streamed
IMAGENET = ["data=ImageNet", "data.size=4096", "hyp.warmup=0", "hyp.steps=1",
            "impl.mixed_precision=True"]
IMAGENET_STREAMED = ["impl.hbm_epoch_max_bytes=134217728", "impl.eval_block_chunks=4"]
STEM_224 = [(224 * 224, 64)]   # ResNet-18's first-stage BN at 224 px (CIFAR stem)
EVAL_TOL = 1e-5                 # streamed, chunked evaluation against resident, whole blocks
RESAMPLE_TOL = 1e-3             # card against CPU on the 0-255 scale
JPEG_CLASSES, JPEG_PER_CLASS = 4, 16
CLI = ["data=ImageNet", "dryrun=True", "seed=0", "model.width=16"]   # data, not the model


def step_launches(torch, bundle, cfg, steps, evals):
    """Launches of each kernel: 20 BN layers a chunk a step, ``apply`` also
    20 a forward of each evaluation, ``eval_chunks`` forwards a block (the
    trainer's: ``impl.eval_block_chunks``, or for ``auto`` the activation
    estimate against ``impl.activation_budget_bytes``)."""
    from fullbatchtraining_tpu_torch.data import epoch_layout
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.models.models import estimate_activation_bytes
    from fullbatchtraining_tpu_torch.training.training import _resolve_eval_chunking

    spec = cfg.impl.eval_block_chunks
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    dtype = torch.bfloat16 if cfg.impl.mixed_precision else torch.float32
    act = (estimate_activation_bytes(model, bundle.pixels, bundle.channels, dtype)
           if spec in ("auto", True) else None)
    eval_chunks = _resolve_eval_chunking(spec, bundle.batch_size, act,
                                         cfg.impl.get("activation_budget_bytes"))
    blocks, chunks, _ = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    train = BN_LAYERS * blocks * chunks * steps
    eval_blocks = -(-len(bundle.valid) // bundle.batch_size)
    return {**{k: train for k in KERNELS},
            "apply": train + BN_LAYERS * eval_blocks * eval_chunks * evals}


def streamed_totals(torch, bundle, cfg, passes, evals):
    """``(segments, bytes host to device)`` of a run that makes ``passes``
    passes over the epoch and ``evals`` evaluations, each streamed where
    ``stream_plan`` says so; bytes are copied on the card only."""
    from fullbatchtraining_tpu_torch.data import epoch_layout
    from fullbatchtraining_tpu_torch.data.pipeline import stream_plan

    item = bundle.train.images[0].nbytes
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    val_blocks = -(-len(bundle.valid) // bundle.batch_size)
    segments = nbytes = 0
    for count, layout in ((passes, (blocks, chunks, sub)),
                          (evals, (val_blocks, 1, bundle.batch_size))):
        streamed, seg_blocks, total = stream_plan(*layout, 1, item, cfg.impl)
        if streamed:
            segments += count * -(-layout[0] // seg_blocks)
            nbytes += count * total
    return segments, nbytes * (torch.device(DEVICE).type == "cuda")


def differing(torch, ours, ref, stats, ref_stats):
    """Tensors of two state dicts and stats (train_time aside) that differ."""
    return ([k for k in ref if not torch.equal(ours[k], ref[k])]
            + [k for k in ref_stats if k != "train_time" and stats[k] != ref_stats[k]])


def tiny_run(torch, bn, extra, bundle=None):
    """``TINY + extra`` through ``training.train`` (on ``bundle`` where
    given): the run's launches, streaming counts, state and stats."""
    from fullbatchtraining_tpu_torch.parallel import streaming

    bn.reset_counts()
    streaming.reset_counts()
    cfg, bundle, _, state, stats = run_main_path(torch, TINY + list(extra), bundle=bundle)
    return {"cfg": cfg, "bundle": bundle, "state": state.model.state_dict(), "stats": stats,
            "launches": dict(bn.launches), "wide": dict(bn.vector_launches),
            "streaming": dict(streaming.counts),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_tiny_resident(torch, bn):
    """11a: ``data=TinyImageNet model=resnet18 hyp=fb1`` at full width, the
    epoch resident: 2 steps (the second warm), their launches exactly, peak
    memory, the synthetic set's time to generate on first use."""
    import tempfile

    from fullbatchtraining_tpu_torch.data import construct_datasets

    cfg = main_path_config(TINY)
    cache = Path(tempfile.gettempdir()) / "fbt_synthetic"
    fresh = not any(cache.glob(f"TinyImageNet_{cfg.data.size}_*"))
    t0 = time.time()
    train, valid = construct_datasets(cfg.data)
    synthetic_s = time.time() - t0
    check(train.images.shape == (cfg.data.size, 64, 64, 3)
          and len(valid) == max(cfg.data.classes, min(cfg.data.size // 5, 10_000)),
          f"TinyImageNet synthetic {train.images.shape}, {len(valid)} validation images")
    del train, valid
    run = tiny_run(torch, bn, [])
    stats, bundle = run["stats"], run["bundle"]
    expected = step_launches(torch, bundle, run["cfg"], 2, len(stats["valid_loss"]))
    result = {"synthetic_s": synthetic_s, "synthetic_generated": fresh,
              "epoch_bytes": bundle.train.images.nbytes, "step_s": stats["train_time"],
              "peak_memory_gib": run["peak_memory_gib"], "launches": run["launches"],
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "valid_acc": stats["valid_acc"]}
    log(f"  synthetic TinyImageNet {'generated' if fresh else 'read'} in {synthetic_s:.1f} s; "
        f"steps {[f'{t:.3f}' for t in stats['train_time']]} s; peak memory "
        f"{run['peak_memory_gib']:.2f} GiB; train loss {stats['train_loss']}, valid loss "
        f"{stats['valid_loss']}; launches {run['launches']}")
    check(run["launches"] == expected, f"launches {run['launches']}, expected {expected}")
    check(run["wide"] == run["launches"], f"16-byte launches {run['wide']}")
    check(run["streaming"]["segments"] == 0, "the resident epoch streamed")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    return result, run


def phase_tiny_streamed(torch, bn, resident):
    """11b: 11a's run with the epoch streamed (``TINY_STREAMED``): bitwise
    11a's params, BN stats and stats, its launches, the H2D bytes (the
    epoch's, a step), the segments, a profile of one warm streamed step
    (the copy stream's busy time; the compute stream's time is the resident
    step's too, the same kernels on the same data, so its share of 11a's
    warm step is the resident busy share); then one shuffled step streamed
    (the host gathers each segment's rows) against the resident device
    gather, bitwise."""
    from fullbatchtraining_tpu_torch.data import epoch_layout
    from fullbatchtraining_tpu_torch.data.pipeline import stream_plan

    run = tiny_run(torch, bn, TINY_STREAMED, resident["bundle"])
    stats, cfg, bundle = run["stats"], run["cfg"], run["bundle"]
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    streamed, seg_blocks, epoch_bytes = stream_plan(blocks, chunks, sub, 1,
                                                    bundle.train.images[0].nbytes, cfg.impl)
    segments = -(-blocks // seg_blocks)
    totals = streamed_totals(torch, bundle, cfg, 2, len(stats["valid_loss"]))
    differ = differing(torch, run["state"], resident["state"], stats, resident["stats"])
    result = {"step_s": stats["train_time"], "resident_step_s": resident["stats"]["train_time"],
              "overhead": stats["train_time"][-1] / resident["stats"]["train_time"][-1] - 1,
              "segments": run["streaming"]["segments"], "segments_a_pass": segments,
              "seg_blocks": seg_blocks, "h2d_bytes": run["streaming"]["h2d_bytes"],
              "epoch_bytes": epoch_bytes, "peak_memory_gib": run["peak_memory_gib"],
              "launches": run["launches"], "differ": differ}
    log(f"  streamed: steps {[f'{t:.3f}' for t in stats['train_time']]} s against resident "
        f"{[f'{t:.3f}' for t in resident['stats']['train_time']]} s (warm step "
        f"{100 * result['overhead']:+.1f}%); {run['streaming']['segments']} segments of "
        f"{seg_blocks} blocks, {run['streaming']['h2d_bytes'] / 1e9:.3f} GB host to device "
        f"(epoch {epoch_bytes / 1e9:.3f} GB a step); peak memory "
        f"{run['peak_memory_gib']:.2f} GiB; {len(differ)} tensors or stats differ")
    check(streamed and segments > 1, f"{segments} segments")
    check(not differ, f"streamed run differs from the resident one: {differ[:5]}")
    check(run["launches"] == resident["launches"], f"launches {run['launches']}")
    check((run["streaming"]["segments"], run["streaming"]["h2d_bytes"]) == totals,
          f"{run['streaming']}, expected (segments, bytes) {totals}")
    profile = phase_profile(torch, "fb1", TINY + TINY_STREAMED, base=[],
                            wall_ms=1e3 * stats["train_time"][-1], warm_up=False, bundle=bundle)
    result["profile"] = profile
    if profile:
        result["resident_busy_share"] = profile["device_ms"] / (
            1e3 * resident["stats"]["train_time"][-1])
        log(f"  resident busy share {result['resident_busy_share']:.3f} (the streamed step's "
            "compute time over 11a's warm step)")
    del run
    shuffled = {}
    for name, extra in (("resident", SHUFFLED), ("streamed", SHUFFLED + TINY_STREAMED)):
        shuffled[name] = tiny_run(torch, bn, extra, bundle)
    ours, ref = shuffled["streamed"], shuffled["resident"]
    totals = streamed_totals(torch, bundle, ours["cfg"], 1, len(ours["stats"]["valid_loss"]))
    differ = differing(torch, ours["state"], ref["state"], ours["stats"], ref["stats"])
    result["shuffled"] = {"step_s": ours["stats"]["train_time"][0],
                          "resident_step_s": ref["stats"]["train_time"][0],
                          "segments": ours["streaming"]["segments"],
                          "h2d_bytes": ours["streaming"]["h2d_bytes"], "differ": differ}
    log(f"  shuffled: streamed step {ours['stats']['train_time'][0]:.3f} s, resident "
        f"{ref['stats']['train_time'][0]:.3f} s; {ours['streaming']['segments']} segments, "
        f"{ours['streaming']['h2d_bytes'] / 1e9:.3f} GB; {len(differ)} tensors or stats differ")
    check(not differ, f"streamed shuffled step differs from the resident one: {differ[:5]}")
    check((ours["streaming"]["segments"], ours["streaming"]["h2d_bytes"]) == totals,
          f"{ours['streaming']}, expected (segments, bytes) {totals}")
    check(ours["launches"] == ref["launches"], f"launches {ours['launches']}")
    return result


def phase_resample(torch):
    """11c, first part: ``resize`` (224 up to 256, 257 down to 256) and
    ``resized_crop`` (boxes drawn on the CPU) of 128 images on the card
    against the same calls on the CPU; their times on the card."""
    from fullbatchtraining_tpu_torch.data import augmentations as aug

    g = torch.Generator().manual_seed(0)
    result = {}
    for side in (224, 257):
        x = torch.randint(0, 256, (128, side, side, 3), generator=g, dtype=torch.uint8)
        boxes = aug.draw_resized_crop(128, g, height=side, width=side)
        xd = x.to(DEVICE)
        calls = {f"resize_{side}_to_256": (lambda t: aug.resize(t, 256)),
                 f"resized_crop_{side}_to_224": (lambda t: aug.resized_crop(
                     t, 224, *(b.to(t.device) for b in boxes)))}
        for name, call in calls.items():
            err = (call(xd).cpu() - call(x)).abs().max().item()
            result[name] = {"max_abs_err": err, "ms": cuda_ms(torch, lambda: call(xd), iters=10)}
            log(f"  {name}: card against CPU max abs err {err:.2e} (tol {RESAMPLE_TOL:g} on "
                f"0-255), {result[name]['ms']:.3f} ms on the card")
            check(err <= RESAMPLE_TOL, f"{name} on the card disagrees with the CPU: {err}")
    return result


def phase_imagenet(torch, bn):
    """11c: ``data=ImageNet model=resnet18 hyp=fb1`` (``IMAGENET``) with
    the epoch and the validation set streamed and evaluation in 4
    sub-chunks a block: one step and one evaluation through
    ``training.train``, their launches exactly; the evaluation against a
    resident one in whole blocks of the trained model, to ``EVAL_TOL``."""
    from fullbatchtraining_tpu_torch.parallel import streaming
    from fullbatchtraining_tpu_torch.training import training

    result = {"resample": phase_resample(torch)}
    bn.reset_counts()
    streaming.reset_counts()
    cfg, bundle, _, state, stats = run_main_path(torch, IMAGENET + IMAGENET_STREAMED)
    counts, wide, streamed = dict(bn.launches), dict(bn.vector_launches), dict(streaming.counts)
    expected = step_launches(torch, bundle, cfg, 1, len(stats["valid_loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    whole = main_path_config(IMAGENET + ["impl.eval_block_chunks=1"])
    trainer = training.Trainer(state.model, bundle, whole, torch.device(DEVICE))
    val = training.stage_validation(bundle, bundle.batch_size, DEVICE, cfg_impl=whole.impl)
    check(trainer.eval_chunks == 1 and isinstance(val[0], torch.Tensor),
          "the reference evaluation is chunked or streamed")
    ref = {k: v.item() for k, v in trainer.eval_step(state.model, *val).items()}
    gaps = {k: abs(stats[k][-1] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    result.update({"step_s": stats["train_time"][0], "peak_memory_gib": peak,
                   "launches": counts, "streaming": streamed,
                   "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
                   "valid_acc": stats["valid_acc"], "resident_whole_blocks": ref,
                   "eval_rel_gap": gaps})
    log(f"  step {stats['train_time'][0]:.3f} s over {bundle.size} images; peak memory "
        f"{peak:.2f} GiB; {streamed['segments']} segments, {streamed['h2d_bytes'] / 1e9:.3f} GB "
        f"host to device; valid loss {stats['valid_loss'][-1]:.6f} acc "
        f"{stats['valid_acc'][-1]:.4f} (streamed, 4 sub-chunks) against {ref['valid_loss']:.6f} "
        f"/ {ref['valid_acc']:.4f} (resident, whole blocks): relative gaps {gaps}; "
        f"launches {counts}")
    check(counts == expected, f"launches {counts}, expected {expected}")
    check(wide == counts, f"16-byte launches {wide}")
    totals = streamed_totals(torch, bundle, cfg, 1, len(stats["valid_loss"]))
    check(totals[0] > 2 and (streamed["segments"], streamed["h2d_bytes"]) == totals,
          f"{streamed}, expected (segments, bytes) {totals}: the epoch's and the padded "
          "validation set's")
    check(all(g <= EVAL_TOL for g in gaps.values()), f"evaluation gaps {gaps}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])), "non-finite loss")
    return result


def phase_jpeg_tree(torch):
    """11d: a JPEG tree written with PIL (``JPEG_CLASSES`` classes of
    ``JPEG_PER_CLASS`` train and 4 validation images of odd sizes) under a
    temporary directory, loaded twice by ``python -m
    fullbatchtraining_tpu_torch data=ImageNet dryrun=True``: the first run
    decodes it into the dryrun cache, the second reads that cache."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    (ROOT / "build").mkdir(exist_ok=True)
    tree = Path(tempfile.mkdtemp(prefix="chip_smoke_jpeg_", dir=ROOT / "build"))
    try:
        rng = np.random.default_rng(0)
        for split, count in (("train", JPEG_PER_CLASS), ("val", 4)):
            for c in range(JPEG_CLASSES):
                folder = tree / split / f"n{c:08d}"
                folder.mkdir(parents=True)
                for i in range(count):
                    h, w = 181 + 17 * i + c, 263 + 11 * i
                    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                        folder / f"{i}.JPEG", quality=90)
        runs, stamps = [], []
        for _ in range(2):
            t0 = time.time()
            run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *CLI,
                                  f"data.path={tree}", f"base_dir={tree / 'out'}"],
                                 cwd=ROOT, capture_output=True, text=True, timeout=300)
            runs.append({"rc": run.returncode, "s": time.time() - t0,
                         "decoded": "Decoded 0/" in run.stdout,
                         "finished": "Final validation accuracy" in run.stdout})
            stamps.append({f.name: f.stat().st_mtime_ns
                           for f in (tree / "_fbt_cache_ImageNet_224_dryrun").glob("*.npy")})
            if run.returncode:
                log(run.stdout[-3000:] + run.stderr[-3000:])
        cache = tree / "_fbt_cache_ImageNet_224_dryrun"
        shape = list(np.load(cache / "train_images.npy", mmap_mode="r").shape)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    result = {"runs": runs, "train_cache_shape": shape, "cache_files": sorted(stamps[0])}
    log(f"  {JPEG_CLASSES * JPEG_PER_CLASS} train images into {shape}: first run "
        f"{runs[0]['s']:.1f} s (decoded {runs[0]['decoded']}), second {runs[1]['s']:.1f} s "
        f"(decoded {runs[1]['decoded']}); cache files {sorted(stamps[0])} unchanged: "
        f"{stamps[0] == stamps[1]}")
    check(all(r["rc"] == 0 and r["finished"] for r in runs), f"CLI runs {runs}")
    check(shape == [JPEG_CLASSES * JPEG_PER_CLASS, 257, 257, 3], f"cache shape {shape}")
    check(runs[0]["decoded"] and not runs[1]["decoded"] and len(stamps[0]) == 4
          and stamps[0] == stamps[1], "the second load did not read the first one's cache")
    return result


# ---------------------------------------------------------------------------
# phase 12: the optimizer zoo
# ---------------------------------------------------------------------------

LBFGS = ["hyp/optim=lbfgs"]          # Wolfe, history 10, as its yaml has it
ZOO_STEP = ["hyp.steps=1"]
ZOO_ONE_STEP = {"wolfe-gd": ["hyp.optim.line_search=wolfe"],
                "adamw-larc": ["hyp/optim=adam", "hyp/optim_modification=LARC"],
                "gd-agc": ["hyp/optim=gd_agc"], "gd-clip": ["hyp/optim=gd_clip"]}


def zoo_run(torch, bn, extra, bundle=None):
    """``training.train`` of ``FULL_WIDTH + extra`` with the launch counts set to 0
    just before it. Returns the config, bundle, final state, stats, the
    run's closure driver (None for a per-step optimizer), the closure
    evaluations of each step and the launches."""
    from fullbatchtraining_tpu_torch.training import training

    drivers, evaluations = [], []
    make, evaluate = training.make_closure_step, training.ClosureEvals.gradient_eval

    def capture(*args):
        drivers.append(make(*args))
        return drivers[-1]

    def counted(self, state, images, labels):
        evaluations.append(state.step)
        return evaluate(self, state, images, labels)

    training.make_closure_step, training.ClosureEvals.gradient_eval = capture, counted
    try:
        bn.reset_counts()
        cfg, bundle, _, state, stats = run_main_path(torch, FULL_WIDTH + list(extra),
                                                     bundle=bundle)
        counts, wide = dict(bn.launches), dict(bn.vector_launches)
    finally:
        training.make_closure_step, training.ClosureEvals.gradient_eval = make, evaluate
    steps = len(stats["train_loss"])
    per_step = [evaluations.count(s) for s in range(steps)]
    return cfg, bundle, state, stats, (drivers or [None])[0], per_step, counts, wide


def check_zoo_launches(torch, name, bundle, cfg, stats, passes, counts, wide):
    """Each kernel's launches are exactly ``passes`` full-batch passes (a
    pass: phase 4's launches a step less its validation's) plus the
    validations', all at 16 bytes a thread."""
    expected = step_launches(torch, bundle, cfg, passes, len(stats["valid_loss"]))
    check(counts == expected, f"{name}: launches {counts}, {passes} passes and "
          f"{len(stats['valid_loss'])} validations give {expected}")
    check(wide == counts, f"{name}: 16-byte launches {wide} of {counts}")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])),
          f"{name}: non-finite loss")


def phase_zoo_lbfgs(torch, bn, fb1):
    """12a: ``hyp/optim=lbfgs`` (Wolfe, history 10) at phase 4's width and
    chunks, 2 steps: each step's closure evaluations, ``lbfgs_t``, step
    time, peak memory, the driver's vector bytes and host syncs; launches
    exactly the evaluations times a pass plus the validations'."""
    cfg, bundle, _, stats, driver, per_step, counts, wide = zoo_run(
        torch, bn, LBFGS + ["hyp.steps=2"])
    passes = sum(per_step)
    check(fb1["launches"]["stats"] % 3 == 0 and step_launches(torch, bundle, cfg, 1, 0)["stats"]
          == fb1["launches"]["stats"] // 3, "a pass's launches are not phase 4's a step")
    check_zoo_launches(torch, "L-BFGS", bundle, cfg, stats, passes, counts, wide)
    check(driver is not None and driver.n_iter == 2 and len(stats["lbfgs_t"]) == 2,
          "the L-BFGS driver did not take 2 steps")
    result = {"evaluations_per_step": per_step, "lbfgs_t": stats["lbfgs_t"],
              "step_s": stats["train_time"], "s_per_evaluation": [
                  t / n for t, n in zip(stats["train_time"], per_step)],
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "vector_bytes": driver.vector_bytes(), "history_pairs": len(driver.s_hist),
              "host_syncs_per_step": driver.syncs / 2, "train_loss": stats["train_loss"],
              "valid_loss": stats["valid_loss"], "launches": counts, "bundle": bundle}
    log(f"  evaluations a step {per_step}; lbfgs_t {stats['lbfgs_t']}; step "
        f"{', '.join(f'{t:.3f}' for t in stats['train_time'])} s "
        f"({', '.join(f'{t:.3f}' for t in result['s_per_evaluation'])} s an evaluation; phase "
        f"4: {', '.join(f'{t:.3f}' for t in fb1['step_s'])} s a step); peak "
        f"{result['peak_memory_gib']:.2f} GiB; driver vectors "
        f"{result['vector_bytes'] / 1e9:.3f} GB ({len(driver.s_hist)} pairs); host syncs "
        f"{result['host_syncs_per_step']:.1f} a step; train loss {stats['train_loss']}; "
        f"launches {counts}")
    return result


def phase_zoo_resume(torch):
    """12b: L-BFGS at phase 8e's size in float32, 2 steps straight through
    and as 1 step saved by the async writer, then a fresh model resumed to
    step 2: params, running stats, ``s_hist``/``y_hist`` (and the rest of
    the driver state) and the stats bitwise equal."""
    import shutil

    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    folder = ROOT / "build" / "chip_smoke_zoo_resume"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)

    def run(steps, extra=()):
        cfg = main_path_config(FP32_STEP + LBFGS + ["hyp.scheduler=none", f"hyp.steps={steps}",
                                                    *extra])
        cfg.original_cwd = str(folder)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed)
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
        _, stats = train(model, bundle, cfg, device=DEVICE)
        torch.cuda.synchronize()
        return stats

    straight_stats = run(2, ["impl.checkpoint.name=straight.ckpt"])
    run(1, ["impl.checkpoint.name=resume.ckpt", "impl.checkpoint.async_save=True"])
    resumed_stats = run(2, ["impl.checkpoint.name=resume.ckpt"])
    straight, resumed = (torch.load(folder / "checkpoints" / name, map_location="cpu",
                                    weights_only=True) for name in ("straight.ckpt", "resume.ckpt"))
    shutil.rmtree(folder, ignore_errors=True)

    def tensors(payload):
        out = {f"model/{k}": v for k, v in payload["model"].items()}
        for key, value in payload["driver"].items():
            for i, v in enumerate(value if isinstance(value, list) else [value]):
                out[f"driver/{key}/{i}"] = v if isinstance(v, torch.Tensor) else torch.tensor(v)
        return out

    ours, theirs = tensors(straight), tensors(resumed)
    differ = [k for k in ours if k not in theirs or not torch.equal(ours[k], theirs[k])]
    stats_differ = [k for k, v in resumed_stats.items()
                    if k != "train_time" and v != straight_stats[k][1:]]
    pairs = len(straight["driver"]["s_hist"])
    log(f"  {len(ours)} tensors and scalars (params, running stats, driver state with {pairs} "
        f"curvature pair): {len(differ)} differ; stats of step 2 that differ: {stats_differ}; "
        f"lbfgs_t {straight_stats['lbfgs_t']}")
    check(straight["step"] == resumed["step"] == 2 and pairs == 1, "no curvature pair to compare")
    check(ours.keys() == theirs.keys() and not differ, f"resumed state differs: {differ[:5]}")
    check(not stats_differ, f"resumed stats differ: {stats_differ}")
    return {"tensors": len(ours), "differ": differ, "stats_differ": stats_differ,
            "lbfgs_t": straight_stats["lbfgs_t"]}


def phase_zoo_one_step(torch, bn, bundle):
    """12c: one full-width step of each of ``ZOO_ONE_STEP``: its closure
    evaluations (one pass for a per-step optimizer), step time, loss and
    launches, exactly that many passes plus the validation's."""
    result = {}
    for name, extra in ZOO_ONE_STEP.items():
        cfg, _, _, stats, driver, per_step, counts, wide = zoo_run(
            torch, bn, extra + ZOO_STEP, bundle=bundle)
        passes = sum(per_step) if driver is not None else 1
        check_zoo_launches(torch, name, bundle, cfg, stats, passes, counts, wide)
        result[name] = {"evaluations": passes, "step_s": stats["train_time"][0],
                        "train_loss": stats["train_loss"][0],
                        "valid_loss": stats["valid_loss"][0], "launches": counts}
        log(f"  {name}: {passes} evaluations, step {stats['train_time'][0]:.3f} s, train loss "
            f"{stats['train_loss'][0]:.4f}, valid loss {stats['valid_loss'][0]:.4f}, launches "
            f"{counts}")
    return result


# ---------------------------------------------------------------------------
# phase 13: the other model families and norms
# ---------------------------------------------------------------------------

# train_distributed_multinode.sh:15-16 as 10c runs :8: float32, chunks of
# 128, one step, cut to 20 chunks
DENSENET_MULTINODE = ["model=densenet121", "hyp.steps=1", "data.size=2560"]
DENSENET_BNS, DENSENET_CHUNKS = 120, 20
MEMORY_EFFICIENT_CUT = ["data.size=512"]               # 4 chunks of 128
MEMORY_EFFICIENT_TOL = 1e-6
# 13c: phase 3's float32 step for each; DenseNet-121 at 4 chunks of 128
FAMILY_FP32 = {"vgg11": ["model=vgg11"],
               "pyramidnet110": ["model=pyramidnet110"],
               "densenet121": ["model=densenet121", "data.size=512", "data.batch_size=128",
                               "hyp.sub_batch=128"],
               "resnet18-ghostnorm": ["model.normalization=SequentialGhostNorm"]}
# 13d: two bf16 hyp=fb1 steps each (the first pays each conv shape's first
# use) at the configured chunks of 128, cut to 16 chunks (at 64, PyramidNet-110
# and -272 took 19 and 38-50 s a step on an H100 at 700 W: the host issues
# their many narrow layers)
FAMILY_BF16_STEP = ["hyp.warmup=0", "hyp.steps=2", "data.size=2048",
                    "impl.mixed_precision=True"]
FAMILY_BF16 = {"vgg16": ["model=vgg16"], "pyramidnet110": ["model=pyramidnet110"],
               "pyramidnet272": ["model=pyramidnet272"], "nfn": ["model=nfn"],
               "resnet18-ghostnorm": ["model.normalization=SequentialGhostNorm"],
               "resnet18-groupnorm": ["model.normalization=GroupNorm"],
               "resnet18-skipinit": ["model.normalization=SkipInit"]}
# 13e: PyramidNet-110's first-stage odd widths (its first blocks are 17, 19
# and 21 wide) at 128 images of 32x32 (and at 2048, where the card and not
# the host sets the time), and DenseNet-121's widest norm
ODD_WIDTHS = [(32 * 32, 19), (32 * 32, 21)]
DENSENET_WIDEST = [(4 * 4, 1024)]
# 13f: one bf16 chunk of 128 of PyramidNet-110 under the profiler
PYRAMID_PROFILE = ["model=pyramidnet110", "data.size=128"]


def norm_calls(model, batch: int):
    """``(calls, layers, recomputed)``: launches of each of ``stats``,
    ``bwd_reduce`` and ``bwd_apply`` in one forward and backward of ``batch``
    images (one a ``BatchNorm2d``, one a virtual batch of each
    ``GhostBatchNorm``); the norms' count (an evaluation forward launches
    ``apply`` once each); and the calls inside memory-efficient dense
    layers, whose backward recomputes their forward (``stats`` and ``apply``
    once more each)."""
    from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d
    from fullbatchtraining_tpu_torch.models.modules import GhostBatchNorm

    calls = layers = recomputed = 0
    for parent in model.modules():
        checkpointed = getattr(parent, "remat", False)
        for module in parent.children():
            if isinstance(module, BatchNorm2d):
                n = 1
            elif isinstance(module, GhostBatchNorm):
                n = -(-batch // module.chunk_size(batch))
            else:
                continue
            calls, layers, recomputed = calls + n, layers + 1, recomputed + n * checkpointed
    top = [model] if isinstance(model, (BatchNorm2d, GhostBatchNorm)) else []
    return calls + len(top), layers + len(top), recomputed


def family_launches(torch, cfg, bundle, model, steps, evals, passes=1):
    """Each kernel's launches in a run of ``steps`` steps of ``passes``
    passes over the epoch and ``evals`` evaluations (``eval_chunks``
    forwards a block, as the trainer resolves them)."""
    from fullbatchtraining_tpu_torch.data import epoch_layout
    from fullbatchtraining_tpu_torch.models.models import estimate_activation_bytes
    from fullbatchtraining_tpu_torch.training.training import _resolve_eval_chunking

    spec = cfg.impl.eval_block_chunks
    dtype = torch.bfloat16 if cfg.impl.mixed_precision else torch.float32
    act = (estimate_activation_bytes(model, bundle.pixels, bundle.channels, dtype)
           if spec in ("auto", True) else None)
    eval_chunks = _resolve_eval_chunking(spec, bundle.batch_size, act,
                                         cfg.impl.get("activation_budget_bytes"))
    blocks, chunks, sub = epoch_layout(bundle.size, bundle.batch_size, cfg.hyp.sub_batch)
    calls, layers, recomputed = norm_calls(model, sub)
    train = passes * calls * blocks * chunks * steps
    forward = train + passes * recomputed * blocks * chunks * steps
    eval_blocks = -(-len(bundle.valid) // bundle.batch_size)
    return {**{k: train for k in KERNELS}, "stats": forward,
            "apply": forward + layers * eval_blocks * eval_chunks * evals}


def family_run(torch, bn, extra, hyp="fb1", passes=1):
    """``training.train`` of ``extra`` with the counts set to 0 just before
    it: step time, peak memory, launches (exactly :func:`family_launches`),
    those at 16 bytes and at one element, channels-last copies (none)."""
    bn.reset_counts()
    cfg, bundle, _, state, stats = run_main_path(torch, extra, hyp)
    counts, wide, copies = dict(bn.launches), dict(bn.vector_launches), bn.layout_copies
    expected = family_launches(torch, cfg, bundle, state.model, len(stats["train_loss"]),
                               len(stats["valid_loss"]), passes)
    result = {"model": cfg.model.name, "step_s": stats["train_time"],
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "train_loss": stats["train_loss"], "valid_loss": stats["valid_loss"],
              "grad_norm": stats.get("grad_norm"), "launches": counts,
              "expected_launches": expected, "wide_launches": wide,
              "narrow_launches": {k: counts[k] - wide[k] for k in counts},
              "layout_copies": copies, "norm_layers": norm_calls(state.model, 1)[1],
              "state": state, "stats": stats}
    log(f"  {cfg.model.name} ({', '.join(extra)}): step "
        f"{', '.join(f'{t:.3f}' for t in stats['train_time'])} s, peak "
        f"{result['peak_memory_gib']:.2f} GiB, train loss {stats['train_loss'][0]:.4f}, "
        f"valid loss {stats['valid_loss'][0]:.4f}; {result['norm_layers']} norm layers; "
        f"launches {counts} (16 B {wide}, 1 element {result['narrow_launches']}); "
        f"layout_copies {copies}")
    check(counts == expected, f"{cfg.model.name}: launches {counts}, expected {expected}")
    check(copies == 0, f"{cfg.model.name}: {copies} channels-last copies")
    check(all(map(math.isfinite, stats["train_loss"] + stats["valid_loss"])),
          f"{cfg.model.name}: non-finite loss")
    return result


def strip(result):
    return {k: v for k, v in result.items() if k not in ("state", "stats")}


def phase_family_multinode(torch, bn):
    """13a: ``train_distributed_multinode.sh:15-16`` (``hyp=gradreg
    model=densenet121 impl/setup=distributed``) in an NCCL group of one, as
    10c: float32, chunks of 128, one step cut to 20 chunks; launches exactly
    2 passes x its 120 BatchNorms x 20 chunks (plus the evaluation's
    ``apply``), no channels-last copy."""
    from fullbatchtraining_tpu_torch import parallel

    extra = DENSENET_MULTINODE + dist_config()
    world = parallel.setup_distributed(main_path_config(extra, "gradreg").impl.setup, DEVICE)
    try:
        result = family_run(torch, bn, extra, "gradreg", passes=2)
    finally:
        parallel.shutdown(world)
    bns, chunks = DENSENET_BNS, DENSENET_CHUNKS
    check(result["norm_layers"] == bns, f"{result['norm_layers']} BatchNorms, not {bns}")
    check(result["launches"]["stats"] == 2 * bns * chunks,
          f"stats: {result['launches']['stats']} launches, not 2 x {bns} x {chunks}")
    result["ms_per_chunk"] = 1e3 * result["step_s"][0] / chunks
    log(f"  {result['ms_per_chunk']:.1f} ms a chunk of 128")
    return strip(result)


def phase_family_memory_efficient(torch, bn):
    """13b: 13a's model and recipe over 4 chunks with ``memory_efficient``
    (checkpointed dense layers) against the same 4 chunks without: loss,
    gradient norm, params and running stats equal (bitwise expected, else
    within ``MEMORY_EFFICIENT_TOL`` relative), peak memory lower."""
    runs = {}
    for efficient in (False, True):
        runs[efficient] = family_run(
            torch, bn, DENSENET_MULTINODE + MEMORY_EFFICIENT_CUT
            + [f"model.memory_efficient={efficient}"], "gradreg", passes=2)
    plain, eff = runs[False], runs[True]
    ours, ref = eff["state"].model.state_dict(), plain["state"].model.state_dict()
    worst = max(((ours[k].double() - ref[k].double()).norm()
                 / ref[k].double().norm().clamp_min(1e-30)).item() for k in ref)
    differ = [k for k in ref if not torch.equal(ours[k], ref[k])]
    stat_gaps = {key: abs(eff["stats"][key][0] - plain["stats"][key][0])
                 / abs(plain["stats"][key][0])
                 for key in ("train_loss", "grad_norm", "full_loss", "valid_loss")}
    result = {"plain": strip(plain), "memory_efficient": strip(eff),
              "tensors_differ": len(differ), "max_rel_diff": worst, "stat_gaps": stat_gaps,
              "bitwise": not differ and not any(stat_gaps.values())}
    log(f"  memory_efficient: {len(differ)} of {len(ref)} tensors differ (largest relative "
        f"L2 difference {worst:.2e}); stats' relative gaps {stat_gaps}; peak memory "
        f"{eff['peak_memory_gib']:.2f} GiB against {plain['peak_memory_gib']:.2f} GiB")
    check(worst <= MEMORY_EFFICIENT_TOL and max(stat_gaps.values()) <= MEMORY_EFFICIENT_TOL,
          "the memory-efficient step differs from the plain one")
    check(eff["peak_memory_gib"] < plain["peak_memory_gib"],
          "the memory-efficient step did not lower peak memory")
    return result


def phase_family_fp32(torch, bn):
    """13c: phase 3's check (a float32 step on the kernels against one under
    ``plain_versions()``) on VGG11, PyramidNet-110 (the one-element path on
    the main path), DenseNet-121 at 4 chunks of 128 and ResNet-18 under
    ``SequentialGhostNorm``; each kernel run's launches exactly its model's."""
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model

    result = {}
    for name, extra in FAMILY_FP32.items():
        log(f"  {name}:")
        bn.reset_counts()
        counts, _, chunks = kernels_against_plain_step(torch, bn, extra=extra, control=True)
        cfg = main_path_config(FP32_STEP + extra)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed)
        model = construct_model(cfg.model, bundle.channels, bundle.classes)
        calls = norm_calls(model, cfg.hyp.sub_batch)[0]
        check(all(counts[k] == calls * chunks for k in KERNELS),
              f"{name}: launches {counts}, expected {calls * chunks} of each of {KERNELS}")
        result[name] = {"launches": counts, "chunks": chunks, "norm_calls_per_chunk": calls}
    return result


def phase_family_profile(torch):
    """13f: one warm bf16 ``hyp=fb1`` step of PyramidNet-110 over one chunk
    of 128 images under ``torch.profiler`` (phase 5's split): how much of a
    13d chunk the card spends in the BN kernels, most of them at one element
    a thread, in the convolutions and elsewhere, against the wall time."""
    return phase_profile(torch, "fb1", PYRAMID_PROFILE, base=FAMILY_BF16_STEP)


def phase_family_bf16(torch, bn):
    """13d: two bf16 ``hyp=fb1`` steps each of ``FAMILY_BF16`` at the
    configured chunks of 128, cut to 64 chunks."""
    return {name: strip(family_run(torch, bn, FAMILY_BF16_STEP + extra))
            for name, extra in FAMILY_BF16.items()}


# ---------------------------------------------------------------------------
# phase 14: analysis
# ---------------------------------------------------------------------------

# the sweep's configuration: float32 (as the sweep always runs), chunks of
# 128 (data.batch_size=128, internal_batch_size_chunks=1), the sweep alone
ANALYSIS = ["hyp.warmup=0", "hyp.steps=1", "data.batch_size=128", "hyp.sub_batch=128",
            "impl.mixed_precision=False", "analysis=full", "analysis.compute_gradient_SNR=True",
            "analysis.compute_gradient_noise_scale=True", "analysis.measure_grad_norm=False",
            "analysis.check_momentum=False"]
ANALYSIS_CUT = ["data.size=4096"]                  # 14b, 14e: 32 chunks of 128
ANALYSIS_GRADS = ["analysis.measure_grad_norm=True", "analysis.check_momentum=True"]
ANALYSIS_STREAMED = ["impl.hbm_epoch_max_bytes=4194304"]   # 2 blocks a segment, 16 segments
ANALYSIS_FULL = ["data.size=50_000"]               # 14c: 390 chunks of 128
ANALYSIS_PROFILED = ["data.size=1024"]             # 14c's profile: 8 chunks
ANALYSIS_CHUNKS = 390
FLATNESS = ["analysis.compute_flatness=True", "analysis.flatness_threshold=3.0",
            "analysis.flatness_step_size=0.5"]
# 14b holds these, kernels against plain versions, at phase 3's gradient-norm
# tolerance (relative; the cosine analysis_momentum_sim absolute)
ANALYSIS_TOL = 1e-4
ANALYSIS_HELD = ("analysis_grad_norm", "analysis_momentum_dist", "analysis_momentum_sim",
                 "analysis_grad_SNR", "analysis_grad_noise_scale", "analysis_grad_mean_norm",
                 "analysis_grad_std_norm")


def phase_bn_eval(torch, bn, chunk=128, stages=STAGES):
    """14a: ``BNEval`` (eval-mode BatchNorm from running stats) forward and
    backward on the kernels against the same Function on the plain versions,
    at ResNet-18's stage shapes for a chunk of ``chunk`` images, float32 and
    bfloat16, with phase 2's tolerances per output (``y``, ``dx``: 2 ulp of
    their terms; ``dscale``, ``dbias``: ``SUM_TOL`` of their sums' terms).
    Launches: exactly one ``apply`` for a forward without grad; one more
    ``apply`` and one ``bwd_reduce`` for the backward. Times: the kernels'
    forward and backward, the plain versions', the bound (6 bytes an element
    of x: x, y, dy, dx once, x and dy once more for ``bwd_reduce``) and
    eval-mode ``F.batch_norm`` forward and backward."""
    import torch.nn.functional as F

    rows = []
    dev = torch.device(DEVICE)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for hw, c in stages:
            m = chunk * hw
            g = torch.Generator(device=dev).manual_seed(hw + c)
            x = (torch.randn((m, c), generator=g, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
            scale = torch.randn(c, generator=g, device=dev) * 0.5 + 1
            bias = torch.randn(c, generator=g, device=dev)
            mean = torch.randn(c, generator=g, device=dev) * 0.3
            var = torch.rand(c, generator=g, device=dev) * 1.5 + 0.5
            leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]

            def run(leaves=leaves, mean=mean, var=var, dy=dy):
                y = bn.bn_eval(*leaves, mean, var)
                return (y, *torch.autograd.grad(y, leaves, dy))

            bn.reset_counts()
            with torch.no_grad():
                bn.bn_eval(x, scale, bias, mean, var)
            forward = dict(bn.launches)
            bn.reset_counts()
            outs = run()
            torch.cuda.synchronize()
            both, wide = dict(bn.launches), dict(bn.vector_launches)
            with bn.plain_versions():
                refs = run()
                plain_ms = cuda_ms(torch, run, iters=10)
            check(bn.launches == both, "plain_versions() launched kernels")
            invstd = torch.rsqrt(var + 1e-5)
            a, b = scale * invstd, bias - mean * scale * invstd
            xf, dyf = x.float(), dy.float()
            sizes = [(xf * a).abs() + b.abs() + refs[0].float().abs(),
                     (dyf * a).abs() + refs[1].float().abs(),
                     invstd * ((dyf * xf).abs().sum(0) + mean.abs() * dyf.abs().sum(0)),
                     dyf.abs().sum(0)]
            tols = [2 * ULP[dtype_name]] * 2 + [SUM_TOL] * 2
            rel = [((o.double() - r.double()).abs() / size.double().clamp_min(1e-30))
                   .max().item() for o, r, size in zip(outs, refs, sizes)]
            xl = x.view(chunk, math.isqrt(hw), math.isqrt(hw), c).permute(0, 3, 1, 2)
            dyl = dy.view(xl.shape[0], *xl.shape[2:], c).permute(0, 3, 1, 2)
            lib_leaves = [xl.detach().requires_grad_(), leaves[1], leaves[2]]

            def library(lib_leaves=lib_leaves, mean=mean, var=var, dyl=dyl):
                y = F.batch_norm(lib_leaves[0], mean, var, lib_leaves[1], lib_leaves[2],
                                 training=False, eps=1e-5)
                return torch.autograd.grad(y, lib_leaves, dyl)

            row = {"dtype": dtype_name, "images": chunk, "m": m, "c": c,
                   "forward_launches": forward, "launches": both, "wide_launches": wide,
                   "max_abs_err": max((o.double() - r.double()).abs().max().item()
                                      for o, r in zip(outs, refs)),
                   "max_rel_err": dict(zip(("y", "dx", "dscale", "dbias"), rel)),
                   "ms": cuda_ms(torch, run, iters=10), "plain_ms": plain_ms,
                   "library_ms": cuda_ms(torch, library, iters=10),
                   "bound_ms": 1e3 * 6 * m * c * x.element_size() / HBM_BYTES_PER_S}
            rows.append(row)
            log(f"  bn_eval {dtype_name:8s} M={m:8d} C={c:3d} rel errs (y, dx, dscale, dbias) "
                f"{[f'{e:.1e}' for e in rel]} (tol {tols}); forward launches {forward}, "
                f"forward+backward {both} (16 B {wide}); kernels {row['ms']:.4f} ms  plain "
                f"{plain_ms:.4f} ms  F.batch_norm {row['library_ms']:.4f} ms  bound "
                f"{row['bound_ms']:.4f} ms")
            check(all(e <= t for e, t in zip(rel, tols)),
                  f"BNEval {dtype_name} M={m} C={c} disagrees with its plain version")
            check(forward == {"stats": 0, "apply": 1, "bwd_reduce": 0, "bwd_apply": 0},
                  f"BNEval forward launched {forward}")
            check(both == {"stats": 0, "apply": 2, "bwd_reduce": 1, "bwd_apply": 0},
                  f"BNEval forward and backward launched {both}")
            check(wide == both, f"BNEval launches {both}, of them at 16 bytes {wide}")
            del x, dy, leaves, outs, refs, sizes, lib_leaves
            torch.cuda.empty_cache()
    return rows


def analysis_setup(torch, extra, bundle=None):
    """``(trainer, state, bundle)`` of ``ANALYSIS + extra`` at its seeded
    full-width weights, as ``training.train`` builds them, the running stats
    calibrated by train-mode forwards (no grad) over the first 32 chunks of
    the epoch, and SGD momentum buffers drawn from a seeded generator."""
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    cfg = main_path_config(ANALYSIS + list(extra))
    if bundle is None:
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed, device=DEVICE)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    training.configure_backends(cfg)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    with torch.no_grad():
        for start, images, _ in trainer.segments(*trainer.stage(0)):
            for chunk in images[:max(32 - start, 0)]:
                model(trainer._normalize(chunk))
    optimizer = training.make_optimizer(model, cfg.hyp)
    g = torch.Generator().manual_seed(3)
    for p in model.parameters():
        optimizer.state[p]["momentum_buffer"] = (0.01 * torch.randn(p.shape, generator=g)).to(p)
    return trainer, training.TrainState(step=0, model=model, optimizer=optimizer), bundle


def timed_analyze(torch, trainer, state):
    """``analyze`` of ``state`` into fresh stats, and its seconds."""
    from fullbatchtraining_tpu_torch.analysis import analyze

    torch.cuda.synchronize()
    t0 = time.time()
    stats = analyze(trainer, state, defaultdict(list))
    torch.cuda.synchronize()
    return stats, time.time() - t0


def sweep_launches(chunks):
    """Each kernel's launches in a sweep of ``chunks`` chunks: an ``apply``
    each BatchNorm forward and backward, a ``bwd_reduce`` backward."""
    return {"stats": 0, "apply": 2 * BN_LAYERS * chunks, "bwd_reduce": BN_LAYERS * chunks,
            "bwd_apply": 0}


def phase_analysis_plain(torch, bn):
    """14b: ``analyze`` at full width on ``ANALYSIS_CUT`` (32 chunks of 128,
    float32), with the pre-step gradient and momentum measures, on the
    kernels and under ``plain_versions()``: the ``ANALYSIS_HELD`` entries
    and every per-batch norm within ``ANALYSIS_TOL``; launches exactly one
    full-batch pass's and the sweep's. The same with the epoch streamed
    from the host (``ANALYSIS_STREAMED``): every entry bitwise the resident
    one. Returns the result and the bundle."""
    runs, bundle = {}, None
    for name, extra in (("kernels", []), ("plain", []), ("streamed", ANALYSIS_STREAMED)):
        trainer, state, bundle = analysis_setup(torch, ANALYSIS_CUT + ANALYSIS_GRADS + extra,
                                                bundle)
        bn.reset_counts()
        if name == "plain":
            with bn.plain_versions():
                stats, seconds = timed_analyze(torch, trainer, state)
        else:
            stats, seconds = timed_analyze(torch, trainer, state)
        runs[name] = {"stats": dict(stats), "launches": dict(bn.launches), "s": seconds}
        log(f"  {name}: {seconds:.3f} s, launches {runs[name]['launches']}")
        del trainer, state
    ours, plain, streamed = (runs[k]["stats"] for k in ("kernels", "plain", "streamed"))
    chunks = len(bundle.train) // bundle.batch_size
    expected = {k: v + BN_LAYERS * chunks for k, v in sweep_launches(chunks).items()}
    gaps = {}
    for key in sorted(plain):
        a, b = ours[key][0], plain[key][0]
        gaps[key] = abs(a - b) / (1 if key == "analysis_momentum_sim" else abs(b))
    held = {k: g for k, g in gaps.items() if k in ANALYSIS_HELD or "grad_norm_" in k}
    worst = max(held, key=held.get)
    log(f"  kernels against plain: {len(gaps)} entries, the held ones within "
        f"{held[worst]:.2e} (worst {worst}; tol {ANALYSIS_TOL:g}); all gaps "
        + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items() if "grad_norm_" not in k))
    log("  values (kernels): " + ", ".join(f"{k} {v[0]:.6g}" for k, v in sorted(ours.items())
                                           if "grad_norm_" not in k))
    differ = [k for k in ours if ours[k] != streamed.get(k)]
    log(f"  streamed against resident: {len(differ)} of {len(ours)} entries differ")
    check(ours.keys() == plain.keys() == streamed.keys(), "the runs recorded other entries")
    check(sum("grad_norm_" in k for k in ours) == chunks, "not one per-batch norm a chunk")
    check(held[worst] <= ANALYSIS_TOL, f"{worst} differs between kernels and plain versions")
    check(runs["kernels"]["launches"] == expected,
          f"launches {runs['kernels']['launches']}, expected {expected}")
    check(runs["plain"]["launches"] == dict.fromkeys(expected, 0),
          "plain_versions() launched kernels")
    check(not differ, f"the streamed sweep differs from the resident one: {differ[:5]}")
    check(all(map(math.isfinite, (v[0] for v in ours.values()))), "non-finite analysis entry")
    return {"kernels_s": runs["kernels"]["s"], "plain_s": runs["plain"]["s"],
            "streamed_s": runs["streamed"]["s"], "gaps": gaps, "launches": expected,
            "values": {k: v[0] for k, v in ours.items()}}, bundle


def phase_analysis_sweep(torch, bn, fb1):
    """14c: the sweep over all 50,000 images (390 chunks of 128, float32)
    through ``analyze``, counts set to 0 just before it: exactly 15,600
    ``apply`` and 7,800 ``bwd_reduce`` launches, all at 16 bytes; its
    seconds, ms a chunk, peak memory and ratio to phase 4's warm step; then
    the busy share of a sweep of 8 chunks under ``torch.profiler`` (its
    device time over the wall time of the same sweep untraced)."""
    from torch.profiler import ProfilerActivity, profile

    from fullbatchtraining_tpu_torch.analysis.analysis import gradient_sweep

    trainer, state, _ = analysis_setup(torch, ANALYSIS_FULL)
    torch.cuda.reset_peak_memory_stats()
    bn.reset_counts()
    stats, seconds = timed_analyze(torch, trainer, state)
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    expected = sweep_launches(ANALYSIS_CHUNKS)
    norms = [v[0] for k, v in stats.items() if "grad_norm_" in k]
    result = {"s": seconds, "ms_per_chunk": 1e3 * seconds / ANALYSIS_CHUNKS,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": counts, "wide_launches": wide,
              "ratio_to_fb1_step": seconds / fb1["step_s"][-1],
              "snr": stats["analysis_grad_SNR"][0],
              "noise_scale": stats["analysis_grad_noise_scale"][0]}
    log(f"  sweep {seconds:.3f} s, {result['ms_per_chunk']:.2f} ms a chunk of 128, "
        f"{result['ratio_to_fb1_step']:.2f}x phase 4's warm step ({fb1['step_s'][-1]:.3f} s); "
        f"peak {result['peak_memory_gib']:.2f} GiB; launches {counts} (16 B {wide}); SNR "
        f"{result['snr']:.4g}, noise scale {result['noise_scale']:.4g}")
    check(counts == expected, f"sweep launches {counts}, expected {expected}")
    check(wide == counts, "a sweep launch took narrow accesses")
    check(len(norms) == ANALYSIS_CHUNKS and all(map(math.isfinite, norms)),
          f"{len(norms)} per-batch norms, or not all finite")
    del trainer, state, stats

    trainer, state, _ = analysis_setup(torch, ANALYSIS_PROFILED)

    def sweep():
        gradient_sweep(trainer, state.model)
        torch.cuda.synchronize()

    sweep()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
    t0 = time.time()
    sweep()
    wall_ms = 1e3 * (time.time() - t0)
    kernels, _, total, classes = device_time(prof)
    result["profile"] = {"chunks": 8, "wall_ms": wall_ms, "device_ms": total,
                         "busy_share": total / wall_ms if total else None,
                         "by_class_ms": classes,
                         "top": sorted(kernels, key=lambda k: -k[1])[:8]}
    log(f"  8 chunks: wall {wall_ms:.1f} ms untraced, device {total:.1f} ms traced, busy "
        f"share {result['profile']['busy_share']}; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items()))
    del trainer, state
    torch.cuda.empty_cache()
    return result


def phase_analysis_train(torch, bn):
    """14d: ``training.train`` with ``hyp=fb1 analysis=full``, one
    full-width bf16 step (phase 4's configuration), against the same step
    without analysis: params and running stats bitwise equal (the pre-step
    pass moved nothing); every ``analysis=full`` entry recorded; launches
    exactly twice the step's pass (the pre-step pass) plus the sweep's
    (chunks of 2048, float32); the step, the pre-step pass and ``analyze``
    timed apart."""
    import fullbatchtraining_tpu_torch.analysis as analysis_pkg
    from fullbatchtraining_tpu_torch.training import training

    base = FULL_WIDTH + ["hyp.steps=1"]
    bn.reset_counts()
    _, bundle, _, ref_state, ref_stats = run_main_path(torch, base)
    ref = {k: v.clone() for k, v in ref_state.model.state_dict().items()}
    ref_counts = dict(bn.launches)
    del ref_state
    times = {"analyze": [], "pre_step": []}
    real_analyze, real_pre = analysis_pkg.analyze, training.Trainer.pre_step_gradient

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.time() - t0)
            return out
        return wrapped

    analysis_pkg.analyze = timed(real_analyze, "analyze")
    training.Trainer.pre_step_gradient = timed(real_pre, "pre_step")
    try:
        bn.reset_counts()
        cfg, _, _, state, stats = run_main_path(torch, base + ["analysis=full"], bundle=bundle)
    finally:
        analysis_pkg.analyze, training.Trainer.pre_step_gradient = real_analyze, real_pre
    counts = dict(bn.launches)
    ours = state.model.state_dict()
    differ = [k for k in ref if not torch.equal(ours[k], ref[k])]
    # the step's chunks and the sweep's (internal_batch_size_chunks=1) are
    # the same blocks of 2048; the pre-step pass is one more full-batch
    # pass: the step's launches again, less the evaluation's applies
    sweep_chunks = len(bundle.train) // bundle.batch_size
    pre_step = dict(ref_counts, apply=BN_LAYERS * sweep_chunks)
    expected = {k: ref_counts[k] + pre_step[k] + v
                for k, v in sweep_launches(sweep_chunks).items()}
    keys = {"analysis_param_norm", "analysis_grad_norm", "analysis_momentum_dist",
            "analysis_momentum_sim", *(f"analysis_grad_norm_{i}" for i in range(sweep_chunks))}
    result = {"step_s": stats["train_time"][0], "step_s_without": ref_stats["train_time"][0],
              "pre_step_s": times["pre_step"], "analyze_s": times["analyze"],
              "tensors_differ": len(differ), "launches": counts, "expected_launches": expected,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "values": {k: stats[k][0] for k in sorted(keys) if "grad_norm_" not in k}}
    log(f"  step with analysis {result['step_s']:.3f} s (its pre-step pass {times['pre_step']} "
        f"s), without {result['step_s_without']:.3f} s; analyze {times['analyze']} s over "
        f"{sweep_chunks} chunks of {bundle.batch_size}; {len(differ)} of {len(ref)} tensors "
        f"differ from the step without analysis; launches {counts} (expected {expected}); "
        f"{result['values']}")
    check(not differ, f"the pre-step pass moved {differ[:5]}")
    check({k for k in stats if k.startswith("analysis_")} == keys,
          f"analysis entries {sorted(k for k in stats if k.startswith('analysis_'))[:8]}...")
    check(counts == expected, f"launches {counts}, expected {expected}")
    del state
    torch.cuda.empty_cache()
    return result


def phase_analysis_flatness(torch, bundle):
    """14e: the flatness walk at 14b's cut (``analysis.flatness_threshold=3.0
    analysis.flatness_step_size=0.5``, ``tests/test_analysis.py``'s values):
    its steps, its value and the seconds an evaluation of the train split."""
    from fullbatchtraining_tpu_torch.analysis.analysis import flatness

    trainer, state, _ = analysis_setup(torch, ANALYSIS_CUT + FLATNESS, bundle)
    evals, real = [], trainer.eval_step

    def counted(*args, **kwargs):
        t0 = time.time()
        out = real(*args, **kwargs)
        out["valid_loss"].item()
        evals.append(time.time() - t0)
        return out

    trainer.eval_step = counted
    t0 = time.time()
    value = flatness(trainer, state)
    seconds = time.time() - t0
    result = {"value": value, "steps": len(evals) - 1, "s": seconds,
              "s_per_eval": sum(evals) / len(evals)}
    log(f"  flatness {value:.4g} after {result['steps']} steps, {seconds:.3f} s, "
        f"{result['s_per_eval']:.3f} s an evaluation of {len(bundle.train)} images")
    check(math.isfinite(value) and value >= 0 and 0 <= result["steps"] < 1000,
          f"flatness {value} after {result['steps']} steps")
    return result


# ---------------------------------------------------------------------------
# phase 15: the loss landscape and the tools
# ---------------------------------------------------------------------------

SURFACE_DIR = ROOT / "build" / "chip_smoke_surface"
SURFACE = ["hyp.warmup=0", "data.batch_size=2048", "hyp.sub_batch=2048",
           "viz.database_name=chip_smoke"]
SURFACE_FULL = ["data.size=50_000", "impl.mixed_precision=True", "viz=1d",
                "viz.coordinates.x.num=5", "viz.vmap_positions=5"]           # 15a: one group
SURFACE_CUT = ["data.size=4096", "impl.mixed_precision=False", "viz=2d",
               "viz.coordinates.x.num=3", "viz.coordinates.y.num=3",
               "viz.vmap_positions=4"]                                     # 15b: 3 groups
SURFACE_STREAMED = ["impl.hbm_epoch_max_bytes=8388608"]                    # a block a segment
SURFACE_TOL = 1e-5
SNAPSHOT = ["analysis.save_model_every_nth_step=1", "impl.checkpoint.name=chip_smoke_snap.ckpt"]


def surface_setup(torch, extra, folder, bundle=None):
    """``(trainer, state, bundle)`` of ``hyp=gradreg`` with ``SURFACE +
    extra`` at its seeded full-width weights, the running stats calibrated
    by train-mode forwards (no grad) over the first 4 blocks, the store
    under ``folder``."""
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    cfg = main_path_config(SURFACE + list(extra), hyp="gradreg")
    cfg.original_cwd = str(folder)
    if bundle is None:
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed, device=DEVICE)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    training.configure_backends(cfg)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    with torch.no_grad():
        for start, images, _ in trainer.segments(*trainer.stage(0)):
            for chunk in images[:max(4 - start, 0)]:
                trainer.forward(model, trainer._normalize(chunk))
    return trainer, training.TrainState(step=0, model=model, optimizer=None), bundle


def surface_launches(positions, blocks):
    """A surface with block gradients: per position and block, each
    BatchNorm's ``BNEval`` forward (``apply``) and backward (``apply``,
    ``bwd_reduce``)."""
    n = positions * blocks * BN_LAYERS
    return {"stats": 0, "apply": 2 * n, "bwd_reduce": n, "bwd_apply": 0}


def timed_crunch(torch, trainer, state):
    from fullbatchtraining_tpu_torch.visualization import crunch

    torch.cuda.synchronize()
    t0 = time.time()
    store, positions = crunch(trainer, state)
    torch.cuda.synchronize()
    return store, positions, time.time() - t0


def phase_surface_full(torch, bn, fb1):
    """15a: the 1D surface at full width (``SURFACE_FULL``), counts set to
    0 just before ``crunch``."""
    import shutil

    from fullbatchtraining_tpu_torch.data import epoch_layout

    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    trainer, state, bundle = surface_setup(torch, SURFACE_FULL, SURFACE_DIR / "full")
    blocks, _, _ = epoch_layout(len(bundle.train), bundle.batch_size, bundle.batch_size)
    torch.cuda.reset_peak_memory_stats()
    bn.reset_counts()
    store, positions, seconds = timed_crunch(torch, trainer, state)
    counts, wide = dict(bn.launches), dict(bn.vector_launches)
    rows = [store.results().get(store._key(p), {}) for p in positions]
    expected = surface_launches(len(positions), blocks)
    result = {"s": seconds, "positions": len(positions), "blocks": blocks,
              "s_per_position": seconds / len(positions),
              "ratio_to_fb1_step": seconds / len(positions) / fb1["step_s"][-1],
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": counts, "wide_launches": wide, "expected_launches": expected,
              "rows": rows}
    log(f"  {len(positions)} positions x {blocks} blocks of {bundle.batch_size}: {seconds:.3f} s, "
        f"{result['s_per_position']:.3f} s a position, {result['ratio_to_fb1_step']:.2f}x "
        f"phase 4's warm step ({fb1['step_s'][-1]:.3f} s); peak "
        f"{result['peak_memory_gib']:.2f} GiB; launches {counts} (16 B {wide}), expected "
        f"{expected}")
    for row in rows:
        log(f"    {row}")
    check(counts == expected, f"surface launches {counts}, expected {expected}")
    check(len(rows) == 5 and all(
        all(math.isfinite(row.get(k, math.nan)) for k in ("train_loss", "train_acc", "full_loss"))
        for row in rows), "a surface row is missing or not finite")
    check(all(row["full_loss"] >= row["train_loss"] for row in rows),
          "full_loss below train_loss with block_strength 0.5")
    del trainer, state
    torch.cuda.empty_cache()
    return result


def phase_surface_plain(torch, bn):
    """15b: ``SURFACE_CUT`` (float32, 4,096 images, 3x3) on the kernels,
    under ``plain_versions()`` and streamed from the host; then the
    kernels' store again, which computes nothing."""
    fields = ("train_loss", "train_acc", "full_loss")
    runs, bundle = {}, None
    for name, extra in (("kernels", []), ("plain", []), ("streamed", SURFACE_STREAMED)):
        trainer, state, bundle = surface_setup(torch, SURFACE_CUT + extra, SURFACE_DIR / name,
                                               bundle)
        bn.reset_counts()
        if name == "plain":
            with bn.plain_versions():
                store, positions, seconds = timed_crunch(torch, trainer, state)
        else:
            store, positions, seconds = timed_crunch(torch, trainer, state)
        runs[name] = {"rows": store.results(), "launches": dict(bn.launches), "s": seconds,
                      "store": store, "trainer": trainer, "state": state}
        log(f"  {name}: {seconds:.3f} s, launches {runs[name]['launches']}")
    ours, plain, streamed = (runs[k]["rows"] for k in ("kernels", "plain", "streamed"))
    images = len(bundle.train)
    gaps = {f: max(abs(ours[k][f] - plain[k][f]) / abs(plain[k][f]) for k in plain)
            for f in ("train_loss", "full_loss")}
    acc_images = max(abs(ours[k]["train_acc"] - plain[k]["train_acc"]) * images for k in plain)
    differ = [k for k in ours if any(ours[k][f] != streamed[k][f] for f in fields)]
    store = runs["kernels"]["store"]
    before = store.results_file.read_bytes()
    bn.reset_counts()
    _, _, again_s = timed_crunch(torch, runs["kernels"]["trainer"], runs["kernels"]["state"])
    again = {"launches": dict(bn.launches), "s": again_s,
             "file_unchanged": store.results_file.read_bytes() == before}
    blocks = images // bundle.batch_size
    expected = surface_launches(9, blocks)
    log(f"  kernels against plain: relative gaps {gaps} (tol {SURFACE_TOL:g}), accuracy "
        f"{acc_images:.0f} images apart; streamed against resident: {len(differ)} of "
        f"{len(ours)} rows differ; second call {again_s:.3f} s, launches {again['launches']}, "
        f"results file unchanged: {again['file_unchanged']}")
    check(ours.keys() == plain.keys() == streamed.keys() and len(ours) == 9,
          "the runs hold other positions")
    check(all(g <= SURFACE_TOL for g in gaps.values()), f"kernels against plain: {gaps}")
    check(acc_images <= 1, f"accuracy {acc_images} images apart")
    check(runs["kernels"]["launches"] == expected == runs["streamed"]["launches"],
          f"launches {runs['kernels']['launches']}, expected {expected}")
    check(runs["plain"]["launches"] == dict.fromkeys(expected, 0),
          "plain_versions() launched kernels")
    check(not differ, f"the streamed surface differs from the resident one: {differ}")
    check(again["file_unchanged"] and not any(again["launches"].values()),
          "the second call computed positions or changed the results file")
    result = {name: {k: v for k, v in run.items() if k in ("launches", "s")}
              for name, run in runs.items()}
    result.update(gaps=gaps, accuracy_images_apart=acc_images, streamed_differ=differ,
                  second_call=again, rows=ours)
    del runs
    torch.cuda.empty_cache()
    return result


def phase_snapshot(torch):
    """15c: phase 4's configuration for one step with and without
    ``SNAPSHOT`` (and a checkpoint, for 15d), in ``SURFACE_DIR / "snapshot"``;
    returns the result and the snapshot run's ``(cfg, bundle, state,
    stats, checkpoint file)``."""
    import os

    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    base = FULL_WIDTH + ["hyp.steps=1"]
    _, bundle, _, ref, _ = run_main_path(torch, base)
    ref_tensors = {**{f"model/{k}": v.clone() for k, v in ref.model.state_dict().items()},
                   **{f"momentum/{n}": ref.optimizer.state[p]["momentum_buffer"].clone()
                      for n, p in ref.model.named_parameters()}}
    del ref
    folder = SURFACE_DIR / "snapshot"
    folder.mkdir(parents=True, exist_ok=True)
    writes, real = [], training.save_state_for_visualization

    def timed(*args, **kwargs):
        t0 = time.time()
        out = real(*args, **kwargs)
        writes.append(time.time() - t0)
        return out

    cwd = os.getcwd()
    os.chdir(folder)
    training.save_state_for_visualization = timed
    try:
        cfg, _, _, state, stats = run_main_path(torch, base + SNAPSHOT, bundle=bundle)
    finally:
        training.save_state_for_visualization = real
        os.chdir(cwd)
    tensors = {**{f"model/{k}": v for k, v in state.model.state_dict().items()},
               **{f"momentum/{n}": state.optimizer.state[p]["momentum_buffer"]
                  for n, p in state.model.named_parameters()}}
    differ = [k for k in ref_tensors if not torch.equal(tensors[k], ref_tensors[k])]
    [file] = folder.glob("chip_smoke_ResNet18_step_1.pt")
    payload = torch.load(file, map_location="cpu", weights_only=True)

    # the gradient of the same initial state, taken apart
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                            pixels=bundle.pixels)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    fresh = training.TrainState(step=0, model=model, optimizer=None)
    grads = trainer.pre_step_gradient(fresh, *trainer.stage(0))
    names = [n for n, _ in model.named_parameters()]
    grads_differ = [n for n, g in zip(names, grads) if not torch.equal(g.cpu(), payload["grads"][n])]
    result = {"file_bytes": file.stat().st_size, "write_s": writes, "tensors": len(ref_tensors),
              "tensors_differ": differ, "grads_differ": grads_differ,
              "step_s": stats["train_time"][0], "valid_acc": stats["valid_acc"][-1],
              "update_directions": payload["update_directions"] is not None}
    log(f"  snapshot {file.name}: {result['file_bytes'] / 1e6:.1f} MB written in {writes} s; "
        f"step {result['step_s']:.3f} s (its pre-step pass included); {len(differ)} of "
        f"{len(ref_tensors)} tensors differ from the step without a snapshot; {len(grads_differ)} "
        f"of {len(names)} stored gradients differ from a pre_step_gradient apart")
    check(len(writes) == 1, f"{len(writes)} snapshot writes, expected 1")
    check(not differ, f"the snapshot run's step differs: {differ[:5]}")
    check(not grads_differ, f"stored gradients differ: {grads_differ[:5]}")
    check(result["update_directions"], "the snapshot holds no update directions")
    del trainer, fresh, grads, payload
    run = (cfg, bundle, state, stats, folder / "checkpoints" / "chip_smoke_snap.ckpt")
    return result, run


def phase_tools(torch, run):
    """15d: ``verify_model_checkpoint`` on 15c's checkpoint, and
    ``measure_floating_point_accuracy`` at phase 4's configuration under
    both ``impl.deterministic`` settings."""
    from fullbatchtraining_tpu_torch.measure_floating_point_accuracy import (
        measure_implementation_noise)
    from fullbatchtraining_tpu_torch.verify_model_checkpoint import verify_checkpoint

    cfg, bundle, _, stats, file = run
    t0 = time.time()
    metrics = verify_checkpoint(cfg, file, DEVICE, bundle=bundle)
    verify_s = time.time() - t0
    result = {"verify": metrics, "verify_s": verify_s, "train_valid_acc": stats["valid_acc"][-1],
              "deviations": {}}
    log(f"  verify: {metrics} in {verify_s:.3f} s; the run's last valid_acc "
        f"{stats['valid_acc'][-1]!r}")
    check(metrics["valid_acc"] == stats["valid_acc"][-1],
          f"verify gives valid_acc {metrics['valid_acc']!r}, the run {stats['valid_acc'][-1]!r}")
    for flag in (True, False):
        mcfg = main_path_config(FULL_WIDTH + ["hyp.steps=1", f"impl.deterministic={flag}"])
        t0 = time.time()
        deviations = measure_implementation_noise(mcfg, DEVICE, bundle=bundle)
        result["deviations"][str(flag)] = {**deviations, "s": time.time() - t0}
        log(f"  impl.deterministic={flag}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in deviations.items())
            + f" ({time.time() - t0:.2f} s)")
        check(all(map(math.isfinite, deviations.values())), f"non-finite deviation {deviations}")
    torch.backends.cudnn.deterministic = True
    return result


def phase_pth(torch, run):
    """15e: 15c's trained state to the upstream 5-tuple and back into a fresh
    model: every tensor, and the evaluation on the card, bitwise."""
    from fullbatchtraining_tpu_torch import pretrained
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import training

    cfg, bundle, state, _, _ = run
    file = SURFACE_DIR / "export" / "resnet18.pth"
    t0 = time.time()
    pretrained.export_reference_training_checkpoint(state, cfg, file)
    export_s = time.time() - t0
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed + 1,
                            pixels=bundle.pixels)
    trainer = training.Trainer(model, bundle, cfg, torch.device(DEVICE))
    fresh = training.TrainState(step=0, model=model,
                                optimizer=training.make_optimizer(model, cfg.hyp))
    t0 = time.time()
    fresh, step = pretrained.import_reference_training_checkpoint(file, cfg, fresh)
    import_s = time.time() - t0
    ours, theirs = state.model.state_dict(), fresh.model.state_dict()
    differ = [k for k in ours if not torch.equal(ours[k], theirs[k])]
    momentum_differ = [n for n, p in state.model.named_parameters() if not torch.equal(
        state.optimizer.state[p]["momentum_buffer"],
        fresh.optimizer.state[dict(fresh.model.named_parameters())[n]]["momentum_buffer"])]
    val = training.stage_validation(bundle, bundle.batch_size, torch.device(DEVICE),
                                    cfg_impl=cfg.impl)
    first = {k: v.item() for k, v in trainer.eval_step(state.model, *val).items()}
    second = {k: v.item() for k, v in trainer.eval_step(fresh.model, *val).items()}
    result = {"file_bytes": file.stat().st_size, "export_s": export_s, "import_s": import_s,
              "step": step, "tensors_differ": differ, "momentum_differ": momentum_differ,
              "eval": first, "eval_imported": second}
    log(f"  {file.name}: {result['file_bytes'] / 1e6:.1f} MB, export {export_s:.3f} s, import "
        f"{import_s:.3f} s, step {step}; {len(differ)} of {len(ours)} tensors and "
        f"{len(momentum_differ)} momentum buffers differ; evaluation {first} against {second}")
    check(step == state.step and not differ and not momentum_differ,
          f"the round trip changed step {step}, tensors {differ[:5]} or momentum "
          f"{momentum_differ[:5]}")
    check(first == second, f"the imported model evaluates to {second}, the first to {first}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)   # phase 10b's ranks
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.rank is not None:
        return rank_main(torch, args.rank, args.port, args.out)
    from fullbatchtraining_tpu_torch.ops import _build, bn

    started = time.time()

    starts = {}   # phase -> its start, s after the script's

    def phase(title):
        starts[title.split()[0]] = time.time() - started
        log(f"{title}  (at {starts[title.split()[0]]:.0f} s)")

    card = card_line()
    log(f"[1] card: {card}")
    log(f"    python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    path, compiler = _build.build("bn_kernels")
    log(f"    built {path.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    for line in compiler.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")
    reported = spills(compiler)
    missing = [k for k in BN_KERNEL_NAMES if not any(k in name for name in reported)]
    spilled = {k: v for k, v in reported.items() if v != (0, 0)}
    check(compiler and not missing, f"no -Xptxas -v report for {missing or 'any kernel'}")
    check(not spilled, f"kernels spill (store, load bytes): {spilled}")

    phase("[2] kernels against their plain versions (chunk of 2048 images)")
    rows = phase_kernels(torch, bn)
    phase("[3] float32 full-batch step: kernels against plain versions")
    phase_fp32_step(torch, bn)
    phase("[4] main path at full width: ResNet-18 hyp=fb1, 3 steps, bf16")
    full = phase_full_width(torch, bn)
    phase("[5] profile of one full-width step")
    profile = phase_profile(torch)
    phase("[6] float32 hyp=gradreg step: kernels against plain versions")
    double_backward = phase_gradreg_fp32(torch, bn)
    phase("[7] hyp=gradreg at full width: ResNet-18, 3 steps, bf16")
    gradreg = phase_gradreg_full_width(torch, bn, full)
    phase("[8a] kernels against their plain versions at blocks of 128 and chunks of 32 images")
    small_rows = phase_kernels_small(torch, bn)
    phase("[8b] float32 hyp=base_sgd epoch (16 updates, shuffled), with and without SAM: "
        "kernels against plain versions")
    sgd_epoch = phase_sgd_epoch(torch, bn)
    phase("[8c] hyp=base_sgd at full width: 2 steps of 390 updates, float32")
    sgd = phase_sgd_full_width(torch, bn)
    phase("[8d] hyp=gradreg data.batch_size=32 hyp.shuffle=True: 1 full-width bf16 step, "
          "195 chunks")
    fb_practice = phase_fb_practice(torch, bn, full)
    phase("[8e] resume from a checkpoint: bitwise equal to the straight run")
    resume = phase_resume(torch)
    phase("[9a] bake the 10x CIFAR store: 10 rounds of 50,000 images, crop+flip on the card")
    bake = phase_bake(torch)
    phase("[9b] fb_10_1: 1 full-width bf16 hyp=fb1 step over the 500,000 baked images")
    baked_fb1 = phase_baked_fb1(torch, bn, full)
    phase("[9c] SGD_10_CIFAR: hyp=base_sgd hyp.train_semi_stochastic=True, 2 steps, float32")
    baked_sgd, resident = phase_baked_sgd(torch, bn, sgd)
    phase("[9d] float32 semi-stochastic hyp=fb1 step on a 2-round store: kernels against plain "
        "versions")
    phase_fp32_step(torch, bn, BAKED_FP32)
    phase("[9e] the host path of semi-stochastic staging")
    baked_host = phase_baked_host_path(torch, resident)
    del resident
    phase("[10a] NCCL in a group of one: phase 4's step, bitwise the step without the group")
    dist_one = phase_dist_one(torch, bn, full)
    phase("[10b] two gloo ranks sharing the card: phase 3's float32 step against one process")
    dist_two = phase_dist_two(torch, bn)
    phase("[10c] train_distributed_multinode.sh:8: hyp=gradreg model=resnet152, 20 chunks of 128")
    dist_152 = phase_dist_resnet152(torch, bn)
    phase("[11] kernels against their plain versions at the 224 px first-stage BN (128 images)")
    stem_rows = phase_kernels(torch, bn, 128, STEM_224)
    phase("[11a] data=TinyImageNet hyp=fb1 at full width: 100,000 images of 64x64, resident")
    tiny, tiny_run_a = phase_tiny_resident(torch, bn)
    phase("[11b] the same streamed from the host: bitwise 11a, in order and shuffled")
    tiny_streamed = phase_tiny_streamed(torch, bn, tiny_run_a)
    del tiny_run_a
    phase("[11c] data=ImageNet hyp=fb1: RandomResizedCrop, Resize, streamed epoch and evaluation")
    imagenet = phase_imagenet(torch, bn)
    phase("[11d] a JPEG ImageFolder tree through the CLI, twice: decoded, then cached")
    jpeg = phase_jpeg_tree(torch)
    phase("[12a] hyp/optim=lbfgs at full width: Wolfe, history 10, 2 steps, bf16")
    zoo_lbfgs = phase_zoo_lbfgs(torch, bn, full)
    zoo_bundle = zoo_lbfgs.pop("bundle")
    phase("[12b] L-BFGS resumed from a checkpoint: bitwise equal to the straight run, float32")
    zoo_resume = phase_zoo_resume(torch)
    phase("[12c] one full-width step each: Wolfe GD, AdamW under LARC, GD-AGC, GD-clip")
    zoo_steps = phase_zoo_one_step(torch, bn, zoo_bundle)
    del zoo_bundle
    phase("[13a] train_distributed_multinode.sh:15-16: hyp=gradreg model=densenet121, "
          "20 chunks of 128")
    fam_multinode = phase_family_multinode(torch, bn)
    phase("[13b] model.memory_efficient=True: 13a's model over 4 chunks against the plain one")
    fam_memeff = phase_family_memory_efficient(torch, bn)
    phase("[13c] float32 steps of VGG11, PyramidNet-110, DenseNet-121 and ResNet-18 under "
          "SequentialGhostNorm: kernels against plain versions")
    fam_fp32 = phase_family_fp32(torch, bn)
    phase("[13d] two bf16 hyp=fb1 steps each of 7 families and norms, 16 chunks of 128")
    fam_bf16 = phase_family_bf16(torch, bn)
    phase("[13e] kernels at PyramidNet-110's odd first-stage widths (128 and 2048 images) "
          "and DenseNet-121's widest norm (128 images)")
    family_rows = (phase_kernels(torch, bn, 128, ODD_WIDTHS + DENSENET_WIDEST)
                   + phase_kernels(torch, bn, CHUNK, ODD_WIDTHS))
    phase("[13f] profile of one bf16 PyramidNet-110 chunk of 128")
    fam_profile = phase_family_profile(torch)
    phase("[14a] BNEval forward and backward against the plain versions (chunk of 128)")
    bn_eval_rows = phase_bn_eval(torch, bn)
    phase("[14b] analyze at full width, 32 chunks of 128, float32: kernels against plain "
          "versions, streamed against resident")
    analysis_plain, analysis_bundle = phase_analysis_plain(torch, bn)
    phase("[14c] the analysis sweep: 50,000 images in 390 chunks of 128, float32")
    analysis_sweep = phase_analysis_sweep(torch, bn, full)
    phase("[14d] hyp=fb1 analysis=full: one full-width bf16 step, bitwise the step without")
    analysis_train = phase_analysis_train(torch, bn)
    phase("[14e] the flatness walk at 14b's cut")
    analysis_flatness = phase_analysis_flatness(torch, analysis_bundle)
    del analysis_bundle
    phase("[15a] a loss surface at full width: hyp=gradreg, bf16, 5 positions x 24 blocks "
          "of 2048")
    surface = phase_surface_full(torch, bn, full)
    phase("[15b] a 3x3 surface over 4,096 images, float32: kernels against plain versions, "
          "streamed against resident, a second call")
    surface_plain = phase_surface_plain(torch, bn)
    phase("[15c] a hyp=fb1 step with a model snapshot: bitwise the step without")
    snapshot, snapshot_run = phase_snapshot(torch)
    phase("[15d] verify_model_checkpoint and measure_floating_point_accuracy")
    tools = phase_tools(torch, snapshot_run)
    phase("[15e] the trained state through the upstream .pth format and back")
    pth = phase_pth(torch, snapshot_run)
    del snapshot_run
    import shutil
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    family_runs = [fam_multinode, fam_memeff["plain"], fam_memeff["memory_efficient"],
                   *fam_fp32.values(), *fam_bf16.values()]

    kernels = []
    for name in ("stats", "apply", "bwd_reduce", "bwd_apply"):
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]

        def total(key, mine=mine):
            return LAYERS_PER_STAGE * sum(r[key] for r in mine)

        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": full["launches"][name],
            "launches_gradreg": gradreg["forward-differences"]["launches"][name],
            "launches_sgd": sgd["launches"][name],
            "launches_fb_shuffle": fb_practice["launches"][name],
            "launches_baked": baked_fb1["launches"][name],
            "launches_dist": dist_one["launches"][name],
            "launches_tinyimagenet": tiny["launches"][name],
            "launches_streamed": tiny_streamed["launches"][name],
            "launches_imagenet": imagenet["launches"][name],
            "launches_zoo": zoo_lbfgs["launches"][name],
            "launches_families": sum(run["launches"][name] for run in family_runs),
            "launches_analysis": analysis_sweep["launches"][name],
            "launches_landscape": surface["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes", "library_ms": total("library_ms"),
            "stem_224": {key: next(r[key] for r in stem_rows if r["kernel"] == name
                                   and r["dtype"] == "bfloat16")
                         for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")},
            "family_shapes": {f"{r['dtype']} M={r['m']} C={r['c']}": {
                key: r[key] for key in ("access_bytes", "ms", "host_ms", "plain_ms",
                                        "bound_ms", "library_ms", "max_abs_err")}
                for r in family_rows if r["kernel"] == name}})
        k = kernels[-1]
        log(f"  {name:10s} bf16 chunk: {k['ms']:.4f} ms, {k['ms'] / k['library_ms']:.2f}x its "
            f"library call, {k['ms'] / k['bound_ms']:.2f}x its bound")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
             "compiler": compiler, "kernel_rows": rows, "full_width": full, "profile": profile,
             "double_backward": double_backward, "gradreg": gradreg,
             "small_kernel_rows": small_rows, "sgd_epoch": sgd_epoch, "sgd": sgd,
             "fb_practice": fb_practice, "resume": resume, "bake": bake,
             "baked_fb1": baked_fb1, "baked_sgd": baked_sgd, "baked_host": baked_host,
             "dist_one": dist_one, "dist_two": dist_two, "dist_resnet152": dist_152,
             "stem_kernel_rows": stem_rows, "tinyimagenet": tiny,
             "tinyimagenet_streamed": tiny_streamed, "imagenet": imagenet, "jpeg_tree": jpeg,
             "zoo_lbfgs": zoo_lbfgs, "zoo_resume": zoo_resume, "zoo_steps": zoo_steps,
             "family_multinode": fam_multinode, "family_memory_efficient": fam_memeff,
             "family_fp32": fam_fp32, "family_bf16": fam_bf16, "family_kernel_rows": family_rows,
             "family_profile": fam_profile, "bn_eval_rows": bn_eval_rows,
             "analysis_plain": analysis_plain, "analysis_sweep": analysis_sweep,
             "analysis_train": analysis_train, "analysis_flatness": analysis_flatness,
             "surface": surface, "surface_plain": surface_plain, "snapshot": snapshot,
             "tools": tools, "pth": pth,
             "kernels": kernels, "phase_starts_s": starts}, indent=1, default=str))
    log(f"all phases passed in {time.time() - started:.0f} s; phases started at (s): "
        + ", ".join(f"{k} {v:.0f}" for k, v in starts.items()))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
