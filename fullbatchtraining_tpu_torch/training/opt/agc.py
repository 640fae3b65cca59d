"""SGD with NFNet adaptive gradient clipping
(``fullbatchtraining_tpu/training/opt/agc.py``).

Unit-wise, ``g`` is scaled to ``clipping * max(||p||, eps)`` where its norm
exceeds that; then torch SGD steps. The norms follow the port's layouts:
OIHW conv weights reduce over ``(1, 2, 3)`` per output channel, ``[out,
in]`` linear weights over dim 1, anything with at most one dimension above 1
over everything (the JAX function reduces HWIO over ``(0, 1, 2)`` and IO over
axis 0: the same units). The classifier (a top-level ``linear``, ``fc`` or
``classifier`` module) is not clipped, and ``only_linear_layers_weight_decay``
exempts ``_AGC_WD_EXEMPT``'s params from weight decay; both match the JAX path
of each param (``convert.jax_param_paths``), never its torch name.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ...convert import jax_param_paths
from ..optimizers import param_groups

_AGC_WD_EXEMPT = re.compile(r"stem.*(bias|gain)|conv.*(bias|gain)|skip_gain")
_CLASSIFIERS = ("linear", "fc", "classifier")


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    if sum(1 for s in x.shape if s != 1) <= 1:
        return torch.sqrt(torch.sum(torch.square(x)))
    if x.ndim == 2:   # [out, in] linear weights: per output row
        return torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    if x.ndim == 4:   # OIHW conv weights: per output channel
        return torch.sqrt(torch.sum(torch.square(x), dim=(1, 2, 3), keepdim=True))
    raise ValueError(f"Got a parameter with ndim not in [1, 2, 4]: {tuple(x.shape)}")


def agc_clip(g: torch.Tensor, p: torch.Tensor, clipping: float, eps: float) -> torch.Tensor:
    max_norm = torch.clamp(unitwise_norm(p), min=eps) * clipping
    grad_norm = unitwise_norm(g)
    clipped = g * (max_norm / torch.clamp(grad_norm, min=1e-6))
    return torch.where(grad_norm > max_norm, clipped, g)


class SGDAGC(torch.optim.SGD):
    """torch SGD on unit-wise clipped gradients of ``model``'s params."""

    def __init__(self, model: nn.Module, cfg_optim, only_linear_wd: bool = False,
                 weight_decay: float | None = None):
        params = list(model.parameters())
        paths = jax_param_paths(model)
        flags = [_AGC_WD_EXEMPT.search(s) is None for s in paths] if only_linear_wd else None
        wd = float(cfg_optim.weight_decay if weight_decay is None else weight_decay)
        super().__init__(param_groups(params, flags, wd), lr=float(cfg_optim.lr),
                         momentum=cfg_optim.momentum, dampening=cfg_optim.dampening,
                         nesterov=cfg_optim.nesterov)
        self.clipping = float(cfg_optim.clipping)
        self.eps = float(cfg_optim.eps)
        self.clipped = [(p, not s.strip("[]'\" ").startswith(_CLASSIFIERS))
                        for p, s in zip(params, paths)]

    @torch.no_grad()
    def step(self, closure=None):
        for p, clip in self.clipped:
            if clip and p.grad is not None:
                p.grad = agc_clip(p.grad, p, self.clipping, self.eps)
        return super().step(closure)
