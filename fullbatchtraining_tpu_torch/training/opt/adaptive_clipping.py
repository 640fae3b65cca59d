"""Iteration-adaptive gradient clipping, 'Adaptive Gradient Descent'
(``fullbatchtraining_tpu/training/opt/adaptive_clipping.py``).

The optimizer keeps the gradient norms (``norm_type`` 2 or inf) of the last
``interval`` steps; where the current norm reaches their maximum, the
gradient is scaled down to that maximum, then torch SGD steps. The JAX
package's two fixes of the reference hold: the *gradients* are scaled (not
the parameters), and every update steps. Clipped norms are not recorded, the
first norm seeds the window twice, and with ``interval=1`` the first step is
already armed, as there. The window and its count live on the device (no
host sync), the window in at least float32 and in float64 for float64
params, and ride in ``state_dict()``.
"""

from __future__ import annotations

import math

import torch


class AdaptiveClippedSGD(torch.optim.SGD):
    def __init__(self, groups, cfg_optim):
        super().__init__(groups, lr=float(cfg_optim.lr), momentum=cfg_optim.momentum,
                         dampening=cfg_optim.dampening, nesterov=cfg_optim.nesterov)
        self.interval = int(cfg_optim.interval)
        self.norm_type = (math.inf if cfg_optim.norm_type == "inf"
                          else float(cfg_optim.norm_type))
        p = self.param_groups[0]["params"][0]
        self.norm_history = torch.zeros(self.interval, device=p.device,
                                        dtype=torch.promote_types(p.dtype, torch.float32))
        self.count = torch.zeros((), dtype=torch.int32, device=p.device)

    def state_dict(self):
        out = super().state_dict()
        out["norm_history"], out["count"] = self.norm_history, self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        hist, count = state_dict.pop("norm_history"), state_dict.pop("count")
        super().load_state_dict(state_dict)
        self.norm_history = hist.to(self.norm_history)
        self.count = count.to(self.count)

    def _grad_norm(self, grads):
        if math.isinf(self.norm_type):
            return torch.stack([g.abs().max() for g in grads]).max()
        norms = torch.stack([torch.linalg.vector_norm(g, self.norm_type) for g in grads])
        return torch.linalg.vector_norm(norms, self.norm_type)

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        hist, count, interval = self.norm_history, self.count, self.interval
        norm = self._grad_norm([p.grad for p in params]).to(hist.dtype)
        first = count == 0
        if interval > 1:
            warm = count >= interval
            recent_max = hist.max()
        else:
            warm = torch.ones((), dtype=torch.bool, device=hist.device)
            recent_max = torch.where(first, norm, hist.max())
        clipped = warm & (norm >= recent_max)
        scale = torch.where(clipped, recent_max / (norm + 1e-6), torch.ones_like(norm))
        for p in params:
            p.grad = p.grad * scale
        slots = torch.arange(interval, device=hist.device)
        at_slot = slots == count % interval
        hist = torch.where(at_slot & ~clipped, norm, hist)
        seed = 1 if interval > 1 else 0
        hist = torch.where((slots == seed) & first, norm, hist)
        one = torch.ones_like(count)
        if interval > 1:
            inc = torch.where(clipped, 0 * one, torch.where(first, 2 * one, one))
        else:
            inc = torch.where(first, one, torch.where(clipped, 0 * one, one))
        self.norm_history, self.count = hist, count + inc
        return super().step(closure)
