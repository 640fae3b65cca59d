"""Learning-rate schedules and the SGD optimizer
(``fullbatchtraining_tpu/training/optimizers.py``).

The schedule is a pure function of the step counter. The optimizer is
``torch.optim.SGD``, which is what the JAX package's ``torch_sgd`` was
written to reproduce (momentum buffer = gradient on the first step,
dampening, Nesterov, coupled weight decay).
"""

from __future__ import annotations

import math
import re
from typing import Callable

import torch
from torch import nn

NO_WD_PATTERN = re.compile(r"(bias|gain)|skip_gain")


def make_lr_schedule(cfg_hyp) -> Callable[[int], float]:
    base = float(cfg_hyp.optim.lr)
    steps = int(cfg_hyp.steps)
    name = cfg_hyp.scheduler
    warmup = int(cfg_hyp.warmup or 0)

    def cosine(T: int, eta_min: float):
        def fn(e):
            # no clamp past T: torch's CosineAnnealingLR closed form is
            # periodic, and cosine-4000 with hyp.steps > 4000 relies on it
            return eta_min + (base - eta_min) * 0.5 * (1 + math.cos(math.pi * e / T))
        return fn

    if name == "linear":
        # drop by 10x at ~5/8, 6/8, 7/8 of training
        milestones = [steps // 2.667, steps // 1.6, steps // 1.142]

        def after(e):
            return base * 0.1 ** sum(e >= m for m in milestones)
    elif name == "exponential":
        def after(e):
            return base * 0.99 ** e
    elif name == "cosine-decay":
        after = cosine(steps, 0.0)
    elif name == "cosine-decay-floored":
        after = cosine(steps, base / 25)
    elif name == "cosine-4000":
        after = cosine(4000, 0.0)
    elif name in ("", " ", None, "none"):
        def after(e):
            return base
    else:
        raise ValueError(f"Invalid scheduler {name} provided.")

    def schedule(step: int) -> float:
        if warmup > 0:
            # the warmup holds the base lr at steps `warmup` AND `warmup + 1`
            # (the after-scheduler starts counting one .step() later)
            if step < warmup:
                return base * step / warmup
            return float(after(max(step - warmup - 1, 0)))
        return float(after(step))

    return schedule


def make_optimizer(model: nn.Module, cfg_hyp) -> torch.optim.SGD:
    """``torch.optim.SGD`` for ``hyp.optim.name == 'Gradient Descent'``; with
    ``hyp.only_linear_layers_weight_decay`` the parameters whose name matches
    NO_WD_PATTERN form a group without weight decay. The lr is set per step
    from the schedule. ``hyp.optim_modification`` may be SAM, which the
    trainer applies; LARS and LARC raise."""
    optim = cfg_hyp.optim
    if optim.name != "Gradient Descent" or optim.get("line_search", "none") != "none":
        raise NotImplementedError(
            f"optimizer {optim.name!r} (line search {optim.get('line_search')!r}) is not "
            "ported yet (ROADMAP.md, 'Optimizer zoo')")
    # SAM wraps the step (two gradients a step or a block, training.py), not
    # the optimizer
    if cfg_hyp.optim_modification.name not in (None, "none", "SAM"):
        raise NotImplementedError(
            f"optim_modification {cfg_hyp.optim_modification.name!r} is not ported yet "
            "(ROADMAP.md, 'Optimizer zoo')")
    weight_decay = float(optim.get("weight_decay", 0.0) or 0.0)
    named = list(model.named_parameters())
    if cfg_hyp.only_linear_layers_weight_decay:
        groups = [
            {"params": [p for n, p in named if not NO_WD_PATTERN.search(n.lower())]},
            {"params": [p for n, p in named if NO_WD_PATTERN.search(n.lower())],
             "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": [p for _, p in named]}]
    return torch.optim.SGD(groups, lr=float(optim.lr), momentum=optim.momentum,
                           dampening=optim.dampening, nesterov=optim.nesterov,
                           weight_decay=weight_decay)
