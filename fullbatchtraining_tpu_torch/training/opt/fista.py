"""FISTA / FISTA-MOD accelerated gradient descent
(``fullbatchtraining_tpu/training/opt/fista.py``).

With ``(p, q, r) = hyp.optim.fista_mod`` (1, 1, 4 is classic FISTA):

    x+    = y_k - lr * grad(y_k)           [the model's params are y_k]
    t_k+1 = (p + sqrt(q + r t_k^2)) / 2
    a_k   = (t_k - 1) / t_k+1
    y_k+1 = x+ (1 + a_k) - x- a_k ;  x- = x+

:class:`FISTA` is the per-step optimizer: ``x_prev`` per param in its state,
``t_k`` a float32 scalar (computed in float32, as the JAX state's is), both in
``state_dict()``. :class:`FISTALineSearchDriver` (``line_search=backtracking``)
shrinks the lr by ``eta`` while the descent lemma fails, each probe a full
gradient evaluation, and composes the schedule's per-step ratio on the
backtracked lr.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

log = logging.getLogger(__name__)


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def fista_coefficients(tk: float, pqr) -> tuple[float, float, float]:
    """``(t_k+1, a_k, 1 + a_k)`` in float32 arithmetic, as Python floats."""
    p, q, r = pqr
    tk = _f32(tk)
    tk_new = (p + torch.sqrt(q + r * tk ** 2)) / 2
    ak = (tk - 1) / tk_new
    return float(tk_new), float(ak), float(1 + ak)


class FISTA(torch.optim.Optimizer):
    def __init__(self, params, cfg_optim, projection=None):
        if cfg_optim.get("projection") and projection is None:
            raise ValueError(f"Unknown projection {cfg_optim.projection!r}; "
                             "pass a callable to FISTA().")
        super().__init__(params, {"lr": float(cfg_optim.lr)})
        self.pqr = tuple(float(v) for v in cfg_optim.fista_mod)
        self.projection = projection
        self.tk = 1.0

    def state_dict(self):
        out = super().state_dict()
        out["tk"] = self.tk
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.tk = float(state_dict.pop("tk"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        tk_new, ak, one_plus_ak = fista_coefficients(self.tk, self.pqr)
        pairs = [(group["lr"], p) for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        x_plus = [p - lr * p.grad for lr, p in pairs]
        if self.projection is not None:
            x_plus = self.projection(x_plus)
        for (_, p), xp in zip(pairs, x_plus):
            state = self.state[p]
            # the JAX state's x_prev starts as the initial params
            x_prev = state["x_prev"] if "x_prev" in state else p.detach().clone()
            p.copy_(xp * one_plus_ak - x_prev * ak)
            state["x_prev"] = xp
        self.tk = tk_new


class FISTALineSearchDriver:
    """FISTA with descent-lemma backtracking on the step size: shrink lr by
    ``eta`` while ``(f(x+) - f(y) - <g, x+ - y>) * lr > ||x+ - y||^2 / 2``.
    When every probe fails, the step keeps ``y_k``. ``get_state`` holds
    ``lr``, ``t_k`` and ``x_prev`` (a list in the params' order)."""

    def __init__(self, fns, cfg):
        o = cfg.hyp.optim
        self.fns = fns
        self.lr = float(o.lr)
        self.eta = float(o.get("eta", 0.8))
        self.max_searches = int(o.get("max_searches", 25))
        self.pqr = tuple(float(v) for v in o.fista_mod)
        self.tk = float(o.get("tk", 1.0))
        self.x_prev = None

    def get_state(self):
        return {"lr": float(self.lr), "tk": float(self.tk),
                "x_prev": list(self.x_prev) if self.x_prev is not None else []}

    def set_state(self, payload):
        self.lr = float(payload.get("lr", self.lr))
        self.tk = float(payload.get("tk", self.tk))
        xp = payload.get("x_prev")
        self.x_prev = [v.to(self.fns.device) for v in xp] if xp else None

    def step(self, state, images, labels):
        from .closures import tree_dot
        params = state.params   # y_k
        grads, metrics = self.fns.gradient_eval(state, images, labels)
        loss_yk = float(metrics["train_loss"])
        if self.x_prev is None:
            self.x_prev = params

        p, q, r = self.pqr
        tk_new = (p + (q + r * self.tk ** 2) ** 0.5) / 2
        ak = (self.tk - 1) / tk_new
        self.tk = tk_new

        x_plus, accepted = params, False
        for _ in range(self.max_searches):
            cand = [y - self.lr * g for y, g in zip(params, grads)]
            delta = [c - y for c, y in zip(cand, params)]
            linearization = float(tree_dot(grads, delta))
            distance = float(tree_dot(delta, delta)) / 2
            _, m2 = self.fns.gradient_eval(dataclasses.replace(state, params=cand),
                                           images, labels)
            loss_xk = float(m2["train_loss"])
            if (loss_xk - loss_yk - linearization) * self.lr > distance:
                self.lr *= self.eta
            else:
                x_plus, accepted = cand, True
                break
        if not accepted:
            log.info("FISTA backtracking exhausted; keeping y_k.")
            x_plus = params

        y_new = [xp * (1 + ak) - xm * ak for xp, xm in zip(x_plus, self.x_prev)]
        self.x_prev = x_plus
        metrics = dict(metrics)
        metrics["lr"] = self.lr
        # the schedule's per-step ratio on top of the backtracked lr; a zero
        # schedule value (warmup step 0) has no finite ratio
        s_now = float(self.fns.schedule(state.step))
        s_next = float(self.fns.schedule(state.step + 1))
        if s_now > 0.0:
            self.lr *= s_next / s_now
        return dataclasses.replace(state, step=state.step + 1, params=y_new), metrics
