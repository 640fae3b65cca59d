"""Welford's online mean and variance of flat vectors
(``fullbatchtraining_tpu/analysis/welford.py``), with Chan's exact merge of
two accumulations, so the ranks' states combine into the statistics of all
their vectors.

``welford_finalize`` guards its divisors as the JAX package does: the sample
variance divides by ``max(count - 1, 1)`` and the averages by ``max(count,
1)``, so a state of 0 or 1 vectors gives zeros, not inf or nan.

``count`` is float32, the rest in the accumulation dtype the caller picks
(``promote(param dtype, float32)`` in the sweep).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    norm_estimate: torch.Tensor           # running sum of ||v||
    squared_norm_estimate: torch.Tensor   # running sum of ||v||^2


def welford_init(dim: int, dtype=torch.float32, device=None) -> WelfordState:
    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return WelfordState(zeros(dtype=torch.float32), zeros(dim), zeros(dim), zeros(), zeros())


def welford_update(state: WelfordState, vector: torch.Tensor) -> WelfordState:
    count = state.count + 1
    delta = vector - state.mean
    mean = state.mean + delta / count
    sq = torch.sum(vector * vector)
    return WelfordState(count, mean, state.m2 + delta * (vector - mean),
                        state.norm_estimate + torch.sqrt(sq),
                        state.squared_norm_estimate + sq)


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Exact parallel combination of two accumulations."""
    count = a.count + b.count
    safe = torch.clamp(count, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe)
    m2 = a.m2 + b.m2 + delta * delta * (a.count * b.count / safe)
    return WelfordState(count, mean, m2, a.norm_estimate + b.norm_estimate,
                        a.squared_norm_estimate + b.squared_norm_estimate)


def welford_finalize(state: WelfordState):
    """``(mean, sample variance, sample std, mean norm, mean squared norm)``."""
    variance = state.m2 / torch.clamp(state.count - 1, min=1.0)
    count = torch.clamp(state.count, min=1.0)
    return (state.mean, variance, torch.sqrt(variance), state.norm_estimate / count,
            state.squared_norm_estimate / count)
