"""LARS / LARC trust-ratio gradient scaling
(``fullbatchtraining_tpu/training/opt/lars.py``).

Per parameter, ``adaptive = tc * ||p|| / (||g|| + wd * ||p|| + eps)``; LARC
clips it to the lr as ``min(adaptive / lr, 1)``. The gradient becomes
``(g + wd * p) * adaptive``, and the inner optimizer steps on it: the wrapper
applies the weight decay that the inner optimizer's groups were built
without. Where either norm is zero the gradient stays exactly as it is, the
weight decay included.
"""

from __future__ import annotations

import torch


class LARS:
    """Wraps a ``torch.optim.Optimizer``: :meth:`step` scales each param's
    ``.grad`` and steps the inner optimizer, whose param groups (and lr),
    state and ``state_dict`` it shares. ``weight_decays[i]`` is the decay of
    ``params[i]``."""

    def __init__(self, inner, params, weight_decays, trust_coefficient: float = 0.02,
                 clip: bool = False, eps: float = 1e-8):
        self.inner = inner
        self.decays = list(zip(params, weight_decays))
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state_dict):
        self.inner.load_state_dict(state_dict)

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        lr = self.param_groups[0]["lr"]
        for p, wd in self.decays:
            g = p.grad
            if g is None:
                continue
            param_norm = torch.linalg.vector_norm(p)
            grad_norm = torch.linalg.vector_norm(g)
            adaptive = self.trust_coefficient * param_norm / (
                grad_norm + param_norm * wd + self.eps)
            if self.clip:
                adaptive = torch.clamp(adaptive / lr, max=1.0)
            active = (param_norm != 0) & (grad_norm != 0)
            p.grad = torch.where(active, (g + wd * p) * adaptive, g)
        self.inner.step()
