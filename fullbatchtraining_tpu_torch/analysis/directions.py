"""Random directions in parameter space and the flatness walk
(``fullbatchtraining_tpu/analysis/directions.py``), over a list of tensors
in the model's ``parameters()`` order.

A direction is normalized leaf by leaf: ``filter``, ``layer``, ``entire``,
``weight``, ``dfilter`` or ``dlayer``, and under the ``biasbn`` rule every
tensor of rank <= 1 (biases, norm scales, scalar gains) gets a zero
direction. The layout differs from the JAX package's: a torch conv weight is
OIHW and a ``Linear`` weight ``(out, in)``, so a "filter" (an output unit)
is a slice along dim 0, and filter norms reduce over every other dim (flax's
HWIO and ``(in, out)`` kernels reduce over every axis but the last).

The random draws come from an explicit ``torch.Generator``; they match the
JAX package's in distribution only, so :func:`create_random_direction` also
takes the raw draws as given.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch

from ..training.grad_reg import tree_sqnorm

log = logging.getLogger(__name__)


def _filter_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-output-unit norms: reduce every dim but dim 0 (OIHW, ``(out, in)``)."""
    return torch.sqrt(torch.sum(torch.square(x), dim=tuple(range(1, x.dim())), keepdim=True))


def tree_norm(tensors) -> torch.Tensor:
    return torch.sqrt(tree_sqnorm(tensors))


def _normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device).to(like.device)


def _normalize_leaf(d: torch.Tensor, w: torch.Tensor, norm: str, ignore: str,
                    generator: torch.Generator, entire_scale=None) -> torch.Tensor:
    # in promote(draw, param) dtype throughout: float64 params give float64
    # directions from float32 draws, as in JAX
    d = d.to(torch.promote_types(d.dtype, w.dtype))
    if d.dim() <= 1:
        # rank <= 1: zero under biasbn; else norm-specific replacements,
        # fresh draws from ``generator``
        if ignore == "biasbn":
            return torch.zeros_like(d)
        fresh = _normal(generator, d.shape, d).to(d.dtype)
        if norm == "layer":
            return fresh * torch.linalg.vector_norm(w) / (torch.linalg.vector_norm(fresh) + 1e-10)
        if norm == "entire":
            return fresh * entire_scale
        sign = torch.sign(fresh)
        return w * torch.where(sign == 0, torch.ones_like(sign), sign)
    if norm == "filter":
        return d * _filter_norms(w) / (_filter_norms(d) + 1e-10)
    if norm in ("layer", "entire"):
        return d * torch.linalg.vector_norm(w) / (torch.linalg.vector_norm(d) + 1e-10)
    if norm == "weight":
        return d * w
    if norm == "dfilter":
        return d / (_filter_norms(d) + 1e-10)
    if norm == "dlayer":
        return d / (torch.linalg.vector_norm(d) + 1e-10)
    raise ValueError(f"Unknown direction norm {norm}.")


def create_random_direction(params, generator: torch.Generator, norm: str = "filter",
                            ignore: str = "biasbn", raw=None) -> list:
    """A random direction shaped like ``params`` (a list of tensors): a
    float32 standard normal draw a tensor from ``generator`` (or the draws
    ``raw``, one a tensor, where given), normalized by ``norm``."""
    params = [p.detach() for p in params]
    if raw is None:
        raw = [_normal(generator, p.shape, p) for p in params]
    entire_scale = None
    if norm == "entire":
        # the global scale comes from the raw draws, before any replacement
        entire_scale = tree_norm(params) / (tree_norm(raw) + 1e-10)
    return [_normalize_leaf(d, w, norm, ignore, generator, entire_scale)
            for d, w in zip(raw, params, strict=True)]


def set_parameter_offset(base, dx, x, dy=None, y=0.0) -> list:
    """``base + x*dx (+ y*dy)``, tensor by tensor."""
    if dy is None:
        return [b + x * d for b, d in zip(base, dx)]
    return [b + x * d1 + y * d2 for b, d1, d2 in zip(base, dx, dy)]


def perturb2threshold(params, loss_fn: Callable[[list], torch.Tensor],
                      generator: torch.Generator, step_size: float = 0.1,
                      threshold: float = 1.0, norm: str = "filter", ignore: str = "biasbn",
                      max_steps: int = 1000):
    """Walk a random direction from ``params`` until the loss ``loss_fn``
    exceeds ``threshold`` or is NaN. Returns ``(direction norm * steps,
    steps)``; at ``max_steps`` it warns that the value is a lower bound."""
    params = [p.detach() for p in params]
    direction = create_random_direction(params, generator, norm=norm, ignore=ignore)
    direction_norm = float(tree_norm(direction))
    counter = 0
    current = params
    while counter < max_steps:
        loss = float(loss_fn(current))
        # NaN stops the walk as a crossing does (not NaN <= threshold)
        if not (loss <= threshold):
            break
        current = set_parameter_offset(current, direction, step_size)
        counter += 1
    else:
        log.warning("perturb2threshold hit max_steps=%d without the loss exceeding %g; the "
                    "recorded flatness is a lower bound.", max_steps, threshold)
    return direction_norm * counter, counter
