"""Multi-batch L-BFGS with Powell damping and Armijo/Wolfe line search
(``fullbatchtraining_tpu/training/opt/lbfgs.py``).

The two-loop recursion over an ``(s, y)`` history with ``H_diag = ys/yy``,
curvature pairs accepted where ``ys > eps * sBs`` (or damped, Powell's
``y <- theta*y + (1-theta)*Bs``), and a closure-driven line search
(``None`` | ``Armijo`` | ``Wolfe``). Kept from the JAX package: ``s = d*t`` in
the unscaled line-search units, ``H_diag`` from the pre-damping ``ys``, the
zero-pair guard, the first step's pseudo-gradient (``wd * theta``, or zeros),
the memory restart on an ascent direction, an illegal trial loss counted as
an Armijo violation, and the ``lbfgs_t`` metric.

Every flat vector is one contiguous tensor on the trainer's device in the
params' ``parameters()`` order (OIHW conv and ``[out, in]`` linear weights,
as the model holds them); ``convert.py`` maps them to and from the JAX
package's ``ravel_pytree`` order. Each dot that a branch reads is a host
sync (``syncs`` counts them with the loss reads).

``impl.shard_opt_vectors`` with several ranks: each rank holds a contiguous
``1/W`` slice of every flat vector, zero-padded to a multiple of ``W``. A dot
is a local partial dot plus one scalar ``all_reduce``; a probe's params are
rebuilt with one ``all_gather``; ``get_state`` gathers on every rank (a
collective) and strips the padding. The branches read only reduced scalars,
so every rank takes the same one. In a world of one it changes nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from ...parallel import World, all_gather, all_reduce

log = logging.getLogger(__name__)


def _is_legal(v: float) -> bool:
    return math.isfinite(v)


def _polyinterp_min(points):
    """Minimizer of the interpolating polynomial through (x, f, g) rows
    (g = nan when unknown), clamped to [min x, max x]."""
    pts = np.asarray(points, float)
    order = int(np.sum(~np.isnan(pts[:, 1:3]))) - 1
    x_lo, x_hi = float(pts[:, 0].min()), float(pts[:, 0].max())
    bisect = 0.5 * (x_lo + x_hi)
    if len(pts) == 2 and order == 2 and pts[0, 0] == 0.0:
        denom = 2.0 * (pts[1, 1] - pts[0, 1] - pts[0, 2] * pts[1, 0])
        if denom == 0:
            return bisect
        return float(np.clip(-pts[0, 2] * pts[1, 0] ** 2 / denom, x_lo, x_hi))
    A, b = [], []
    for x, f, g in pts:
        if not np.isnan(f):
            A.append([x ** (order - j) for j in range(order + 1)])
            b.append(f)
        if not np.isnan(g):
            A.append([(order - j) * x ** max(order - j - 1, 0)
                      for j in range(order)] + [0.0])
            b.append(g)
    try:
        coeffs = np.linalg.solve(np.asarray(A), np.asarray(b))
    except np.linalg.LinAlgError:
        return bisect
    dcoeffs = np.polyder(coeffs)
    candidates = [x_lo, x_hi]
    for r in np.roots(dcoeffs) if len(dcoeffs) else []:
        if abs(r.imag) < 1e-12 and x_lo <= r.real <= x_hi:
            candidates.append(float(r.real))
    vals = [float(np.polyval(coeffs, c)) for c in candidates]
    best = candidates[int(np.argmin(vals))]
    return best if math.isfinite(best) else bisect


class LBFGSDriver:
    def __init__(self, fns, cfg):
        o = cfg.hyp.optim
        self.fns = fns
        self.lr = float(o.lr)
        self.history_size = int(o.history_size)
        self.line_search = str(o.line_search)
        self.eps = float(o.eps)
        self.damping = bool(o.damping)
        self.eta = float(o.eta)
        self.c1 = float(o.c1)
        self.c2 = float(o.get("c2", 0.9))
        self.max_ls = int(o.get("max_linesearches", 10))
        self.weight_decay = float(o.get("weight_decay", 0.0))
        self.hyp = cfg.hyp
        self._wd_flat = None   # flat per-element wd factors (lazy, needs params)
        self._size = None      # unpadded flat length
        self._shapes = None    # (shape, dtype) of each param
        self.world = getattr(fns, "world", None) or World()
        impl = getattr(cfg, "impl", None)
        self.sharded = (self.world.size > 1 and impl is not None
                        and bool(impl.get("shard_opt_vectors", False)))
        self.syncs = 0

        self.s_hist: list[torch.Tensor] = []
        self.y_hist: list[torch.Tensor] = []
        self.H_diag = 1.0
        self.prev_flat_grad = None
        self.d = None
        self.t = 1.0
        self.Bs = None
        self.fail = False
        self.n_iter = 0
        self.curv_skips = 0
        self.fail_skips = 0

    # -- checkpoint state ------------------------------------------------------
    def get_state(self):
        """The checkpoint payload, unsharded and unpadded; sharded, a gather
        that every rank must enter."""
        def host(v):
            if v is None:
                return torch.zeros((0,), dtype=torch.float32)
            return self._unshard(v)
        return {"s_hist": [host(v) for v in self.s_hist],
                "y_hist": [host(v) for v in self.y_hist],
                "H_diag": float(self.H_diag), "t": float(self.t),
                "n_iter": int(self.n_iter), "curv_skips": int(self.curv_skips),
                "fail_skips": int(self.fail_skips), "fail": bool(self.fail),
                "prev_flat_grad": host(self.prev_flat_grad),
                "Bs": host(self.Bs), "d": host(self.d)}

    def set_state(self, p):
        def track(v):
            if v is None or not v.numel():
                return None
            self._size = v.shape[0]
            return self._shard(v.to(getattr(self.fns, "device", v.device)))
        self.s_hist = [track(v) for v in p.get("s_hist", [])]
        self.y_hist = [track(v) for v in p.get("y_hist", [])]
        self.H_diag = float(p.get("H_diag", 1.0))
        self.t = float(p.get("t", 1.0))
        self.n_iter = int(p.get("n_iter", 0))
        self.curv_skips = int(p.get("curv_skips", 0))
        self.fail_skips = int(p.get("fail_skips", 0))
        self.fail = bool(p.get("fail", False))
        self.prev_flat_grad = track(p.get("prev_flat_grad"))
        self.Bs = track(p.get("Bs"))
        self.d = track(p.get("d"))

    # -- flat vectors ------------------------------------------------------------
    @staticmethod
    def _flat(tensors):
        return torch.cat([t.reshape(-1) for t in tensors])

    def _unravel(self, flat):
        out, offset = [], 0
        for shape, dtype in self._shapes:
            n = math.prod(shape)
            out.append(flat[offset:offset + n].view(shape).to(dtype))
            offset += n
        return out

    def _shard(self, vec):
        """This rank's contiguous slice of ``vec`` zero-padded to a multiple
        of the world size; ``vec`` itself when not sharded."""
        if not self.sharded or vec is None:
            return vec
        ranks = self.world.size
        pad = (-vec.shape[0]) % ranks
        if pad:
            vec = torch.cat([vec, vec.new_zeros(pad)])
        n = vec.shape[0] // ranks
        return vec[self.world.rank * n:(self.world.rank + 1) * n].clone()

    def _unshard(self, vec):
        """The whole unpadded vector from every rank's slice (one all_gather)."""
        if not self.sharded:
            return vec
        return all_gather(self.world, vec)[:self._size]

    def _dot(self, a, b) -> float:
        v = torch.dot(a, b)
        if self.sharded:
            all_reduce(self.world, v)
        self.syncs += 1
        return float(v)

    def _ensure_wd(self, params):
        """Flat per-element wd factors (``hyp.only_linear_layers_weight_decay``
        zeroes the exempt params')."""
        if self.weight_decay and self._wd_flat is None:
            from .closures import wd_factors
            factors = wd_factors(self.fns.param_paths, self.hyp)
            self._wd_flat = self._shard(self._flat(
                [torch.full_like(p, w) for p, w in zip(params, factors)]))

    def vector_bytes(self) -> int:
        """Bytes this rank holds in flat driver vectors."""
        vecs = [*self.s_hist, *self.y_hist, self.prev_flat_grad, self.Bs, self.d,
                self._wd_flat]
        return sum(v.numel() * v.element_size() for v in vecs if v is not None)

    def _eval(self, state, images, labels, flat_params):
        """One closure evaluation at ``flat_params``; the running stats chain
        through every evaluation in call order."""
        probe = dataclasses.replace(state, params=self._unravel(self._unshard(flat_params)))
        grads, metrics = self.fns.gradient_eval(probe, images, labels)
        g = self._shard(self._flat(grads))
        if self.weight_decay:
            g = g + self._wd_flat * flat_params
        self.syncs += 1
        return float(metrics["train_loss"]), g, metrics

    def two_loop_recursion(self, vec):
        q = vec
        alphas = []
        rhos = [1.0 / self._dot(y, s) for s, y in zip(self.s_hist, self.y_hist)]
        for s, y, rho in zip(reversed(self.s_hist), reversed(self.y_hist), reversed(rhos)):
            a = self._dot(s, q) * rho
            alphas.append(a)
            q = q - a * y
        r = q * self.H_diag
        for (s, y, rho), a in zip(zip(self.s_hist, self.y_hist, rhos), reversed(alphas)):
            beta = self._dot(y, r) * rho
            r = r + (a - beta) * s
        return r

    def curvature_update(self, flat_grad):
        """Accept, damp or reject the ``(s, y)`` pair; ``s = d*t`` in unscaled
        units."""
        if self.fail:
            self.fail_skips += 1
            return
        y = flat_grad - self.prev_flat_grad
        s = self.d * self.t
        sBs = self._dot(s, self.Bs)
        ys = self._dot(y, s)
        if (ys > self.eps * sBs or self.damping) and self._dot(s, s) > 0:
            if self.damping and ys < self.eps * sBs and sBs != ys:
                theta = ((1 - self.eps) * sBs) / (sBs - ys)
                y = theta * y + (1 - theta) * self.Bs
                # H_diag below keeps the pre-damping ys
            if self._dot(y, s) == 0.0:
                self.curv_skips += 1   # degenerate pair: rho would divide by 0
                return
            if len(self.s_hist) == self.history_size:
                self.s_hist.pop(0)
                self.y_hist.pop(0)
            self.s_hist.append(s)
            self.y_hist.append(y)
            yy = self._dot(y, y)
            if yy > 0:
                self.H_diag = ys / yy
        else:
            self.curv_skips += 1

    # -- line searches -------------------------------------------------------------
    def _armijo(self, phi, F_k, gtd):
        """Armijo backtracking with minFunc polynomial interpolation, clamped
        to [1e-3, 0.6] * t; an exhausted search re-evaluates at t = 0."""
        t = 1.0
        t_prev, F_prev = 0.0, float("nan")
        ls_step = 0
        F_new = phi(t)
        while F_new > F_k + self.c1 * t * gtd or not _is_legal(F_new):
            if ls_step >= self.max_ls:
                F_new = phi(0.0)
                return 0.0, F_new, True
            t_new = t
            if ls_step == 0 or not _is_legal(F_new):
                t = t / self.eta
            elif ls_step == 1 or not math.isfinite(F_prev):
                t = _polyinterp_min([(0.0, F_k, gtd), (t_new, F_new, float("nan"))])
            else:
                t = _polyinterp_min([(0.0, F_k, gtd), (t_new, F_new, float("nan")),
                                     (t_prev, F_prev, float("nan"))])
            t = min(max(t, 1e-3 * t_new), 0.6 * t_new)
            F_prev, t_prev = F_new, t_new
            F_new = phi(t)
            ls_step += 1
        return t, F_new, False

    @staticmethod
    def _quadinterp(x1, f1, g1, x2, f2):
        """minFunc 2-point quadratic minimizer, clamped to [min x, max x]."""
        lo, hi = min(x1, x2), max(x1, x2)
        if x1 == 0:
            denom = 2.0 * (f2 - f1 - g1 * x2)
            x = -g1 * x2 ** 2 / denom if denom != 0 else 0.5 * (lo + hi)
        else:
            a = -(f1 - f2 - g1 * (x1 - x2)) / (x1 - x2) ** 2
            x = x1 - g1 / (2 * a) if a != 0 else 0.5 * (lo + hi)
        if not math.isfinite(x):
            x = 0.5 * (lo + hi)
        return float(min(max(lo, x), hi))

    def _wolfe(self, phi_grad, F_k, gtd):
        """Weak-Wolfe bracketing: eta growth or bisection while the upper
        bound is unknown, quadratic interpolation once it is, with the
        reference's clamps; an illegal trial loss sets the upper bound."""
        t = 1.0
        ls_step = 0
        t_prev = 0.0
        alpha, beta = 0.0, float("inf")
        F_a, g_a = F_k, gtd
        F_b = float("nan")
        F_new, g_new = phi_grad(t)
        while True:
            if ls_step >= self.max_ls:
                F_new, g_new = phi_grad(0.0)
                return 0.0, F_new, True
            if F_new > F_k + self.c1 * t * gtd or not _is_legal(F_new):
                beta = t
                t_prev = t
                F_b = F_new
            else:
                if g_new < self.c2 * gtd:
                    alpha = t
                    t_prev = t
                    F_a, g_a = F_new, g_new
                else:
                    return t, F_new, False
            if not _is_legal(F_b):
                t = self.eta * t if beta == float("inf") else 0.5 * (alpha + beta)
            else:
                t = self._quadinterp(alpha, F_a, g_a, beta, F_b)
                if beta == float("inf"):
                    t = min(max(t, self.eta * t_prev), 2 * self.eta * t_prev)
                else:
                    if t < alpha + 0.2 * (beta - alpha):
                        t = alpha + 0.2 * (beta - alpha)
                    elif t > (beta - alpha) / 2.0:
                        t = (beta - alpha) / 2.0
                if t <= 0:
                    t = (beta - alpha) / 2.0
            F_new, g_new = phi_grad(t)
            ls_step += 1

    # -- the step --------------------------------------------------------------
    def step(self, state, images, labels):
        lr_sched = float(self.fns.schedule(state.step))
        self._shapes = [(tuple(p.shape), p.dtype) for p in state.params]
        self._ensure_wd(state.params)
        theta0 = self._flat(state.params)
        self._size = theta0.shape[0]
        theta0 = self._shard(theta0)
        loss, g, metrics = self._eval(state, images, labels, theta0)
        if self.n_iter == 0:
            # the reference's first direction comes from the zeros + wd*theta
            # pseudo-gradient, the loss from the true closure value
            g = self._wd_flat * theta0 if self.weight_decay else torch.zeros_like(theta0)

        if self.n_iter > 0:
            self.curvature_update(g)
        self.prev_flat_grad = g

        d = -self.two_loop_recursion(g) if self.s_hist else -g * self.H_diag
        gtd = self._dot(g, d)
        if gtd > 0:
            # an ascent direction restarts the memory (minFunc's practice)
            log.info("L-BFGS direction is not a descent direction (gtd=%g); "
                     "restarting memory.", gtd)
            self.s_hist, self.y_hist, self.H_diag = [], [], 1.0
            d = -g

        # t in the reference's unscaled units; the lr multiplies in the probe
        lr_eff = lr_sched
        cache: dict[float, tuple] = {}

        def eval_at(t):
            if t not in cache:
                cache[t] = self._eval(state, images, labels, theta0 + (t * lr_eff) * d)
            return cache[t]

        if self.line_search == "Armijo":
            t, F_new, self.fail = self._armijo(lambda tt: eval_at(tt)[0], loss, gtd)
        elif self.line_search == "Wolfe":
            def phi_grad(tt):
                F, g_t, _ = eval_at(tt)
                return F, self._dot(g_t, d)
            t, F_new, self.fail = self._wolfe(phi_grad, loss, gtd)
        else:   # 'None': t = 1, scaled by the lr
            t, self.fail = 1.0, False
            eval_at(t)

        self.d, self.t = d, t
        self.Bs = -t * g   # for Powell damping, in unscaled t units
        self.n_iter += 1

        if t > 0:
            if t in cache:
                metrics = cache[t][2]
            new_params = self._unravel(self._unshard(theta0 + (t * lr_eff) * d))
        else:
            if 0.0 in cache:   # a failed search re-evaluated the restored point
                metrics = cache[0.0][2]
            new_params = self._unravel(self._unshard(theta0))
        metrics = dict(metrics)
        metrics["lr"] = lr_sched
        metrics["lbfgs_t"] = t
        return dataclasses.replace(state, step=state.step + 1, params=new_params), metrics
