"""Learning-rate schedules and the optimizer interface
(``fullbatchtraining_tpu/training/optimizers.py``).

The schedule is a pure function of the step counter. Each per-step optimizer
is a ``torch.optim.Optimizer``, so a checkpoint carries its state through
``state_dict()``:

* ``Gradient Descent``: ``torch.optim.SGD``, which is what the JAX package's
  ``torch_sgd`` was written to reproduce (momentum buffer = gradient on the
  first step, dampening, Nesterov, coupled weight decay);
* ``Adam``: ``torch.optim.AdamW``, which its ``torch_adamw`` reproduces
  (decoupled weight decay, ``amsgrad``). Its bias corrections are Python
  floats, the JAX function's are at the parameters' precision: the same
  numbers in float64, about 1e-8 apart in float32;
* ``GD-AGC``, ``Adaptive Gradient Descent`` and ``FISTA``: :mod:`.opt.agc`,
  :mod:`.opt.adaptive_clipping`, :mod:`.opt.fista`;
* ``hyp/optim_modification=LARS|LARC`` wraps any of them (:mod:`.opt.lars`),
  which then applies the weight decay that the inner optimizer's groups no
  longer have.

``Gradient Descent`` with ``hyp.optim.line_search``, FISTA with
``line_search=backtracking`` and ``L-BFGS`` are closure optimizers: their
step re-evaluates the full gradient, and :mod:`.opt.closures` drives it.
``info["closure"]`` names the driver; L-BFGS has no per-step optimizer.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import torch
from torch import nn

from ..convert import jax_param_paths

NO_WD_PATTERN = re.compile(r"(bias|gain)|skip_gain")
CLOSURE_OPTIMIZERS = {"wolfe", "non-monotone", "restarting"}


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


def wd_flags(model: nn.Module) -> list[bool]:
    """True for each of ``model``'s params (in ``parameters()`` order) that
    weight decay applies to under ``hyp.only_linear_layers_weight_decay``:
    NO_WD_PATTERN matched against its JAX path, as the JAX ``wd_mask`` does
    (against its torch name for a module that has no JAX layout)."""
    try:
        paths = jax_param_paths(model)
    except TypeError:
        paths = [name.lower() for name, _ in model.named_parameters()]
    return [NO_WD_PATTERN.search(path) is None for path in paths]


def param_groups(params, flags, weight_decay: float) -> list[dict]:
    """One group at ``weight_decay``, or with ``flags`` the flagged params at
    ``weight_decay`` and the others in a group without it."""
    if flags is None:
        return [{"params": list(params), "weight_decay": weight_decay}]
    return [{"params": [p for p, f in zip(params, flags) if f], "weight_decay": weight_decay},
            {"params": [p for p, f in zip(params, flags) if not f], "weight_decay": 0.0}]


def optim_interface(model: nn.Module, cfg_hyp):
    """``(optimizer, info)`` for ``cfg_hyp``, with the JAX ``optim_interface``'s
    dispatch and errors: ``info = {"closure": driver kind or None,
    "modification": hyp.optim_modification.name}``. The optimizer is None for
    L-BFGS. The lr is set per step from the schedule."""
    optim = cfg_hyp.optim
    name = optim.name
    mod = cfg_hyp.optim_modification.name
    info = {"closure": None, "modification": mod}
    make_lr_schedule(cfg_hyp)   # an unknown scheduler raises here, as in JAX
    params = list(model.parameters())
    only_linear = bool(cfg_hyp.only_linear_layers_weight_decay)
    flags = wd_flags(model) if only_linear else None
    # LARS/LARC absorb the inner optimizer's weight decay
    weight_decay = float(optim.get("weight_decay", 0.0) or 0.0)
    inner_wd = 0.0 if mod in ("LARS", "LARC") else weight_decay
    lr = float(optim.lr)

    if name == "Gradient Descent":
        line_search = optim.get("line_search", "none")
        if line_search != "none":
            if line_search not in CLOSURE_OPTIMIZERS:
                raise ValueError(f"Invalid linesearch {line_search} defined.")
            info["closure"] = line_search
        optimizer = torch.optim.SGD(param_groups(params, flags, inner_wd), lr=lr,
                                    momentum=optim.momentum, dampening=optim.dampening,
                                    nesterov=optim.nesterov)
    elif name == "Adam":
        optimizer = torch.optim.AdamW(param_groups(params, flags, inner_wd), lr=lr,
                                      betas=tuple(float(b) for b in optim.betas),
                                      eps=float(optim.eps), amsgrad=bool(optim.amsgrad))
    elif name == "Adaptive Gradient Descent":
        from .opt.adaptive_clipping import AdaptiveClippedSGD
        optimizer = AdaptiveClippedSGD(param_groups(params, flags, inner_wd), optim)
    elif name == "GD-AGC":
        from .opt.agc import SGDAGC
        optimizer = SGDAGC(model, optim, only_linear_wd=only_linear, weight_decay=inner_wd)
    elif name == "FISTA":
        from .opt.fista import FISTA
        if optim.get("line_search") in ("backtracking", "search"):
            info["closure"] = "fista-search"
        optimizer = FISTA(params, optim)
    elif name == "L-BFGS":
        info["closure"] = "lbfgs"
        optimizer = None
    else:
        raise ValueError(f"Invalid optimizer {name} provided.")

    if mod in ("LARS", "LARC") and optimizer is not None:
        from .opt.lars import LARS
        decays = [weight_decay if f else 0.0 for f in (flags or [True] * len(params))]
        optimizer = LARS(optimizer, params, decays,
                         trust_coefficient=float(cfg_hyp.optim_modification.trust_coefficient),
                         clip=(mod == "LARC"), eps=float(cfg_hyp.optim_modification.eps))
    # SAM wraps the step (two gradients a step or a block, training.py), not
    # the optimizer
    return optimizer, info


def make_optimizer(model: nn.Module, cfg_hyp):
    """The optimizer of :func:`optim_interface`."""
    return optim_interface(model, cfg_hyp)[0]
