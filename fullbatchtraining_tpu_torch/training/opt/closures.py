"""Closure-based line-search optimizers
(``fullbatchtraining_tpu/training/opt/closures.py``).

``RestartingLineSearch``, ``NonMonotoneLinesearch`` and
``WolfeGradientDescent`` run their search in Python; each closure call is one
gradient evaluation through the driver's ``fns``, the narrow hook

    fns.gradient_eval(state, images, labels) -> (grads, metrics)

at ``state.params`` (a list of tensors in the model's ``parameters()``
order), with ``fns.schedule(step)``, ``fns.param_paths`` (the JAX path of
each param, for ``hyp.only_linear_layers_weight_decay``) and optionally
``fns.world``/``fns.device``. In a run the hook is the trainer's full-batch
pass or, in stochastic mode, its pass over one block (:class:`_BlockFns`);
a test can put a stub objective behind it. A driver's ``step(state, images,
labels)`` returns ``(state, metrics)`` with a new :class:`DriverState`.

The JAX package's semantics, kept on purpose:

- norm running stats chain through every closure evaluation in call order,
  retries and Wolfe probes included: each evaluation is a train-mode pass
  that updates the model's buffers in place, and no evaluation saves or
  restores them, so after a step they are the last evaluation's;
- Wolfe leaves the params at the last fresh attempt and never re-applies the
  alpha the search returns; a NaN trial loss counts as an Armijo violation;
- a restart leaves a zeros momentum buffer, so the redo step is
  ``(1 - dampening) * grad`` even on step 0;
- non-monotone retries scale the gradient of the latest trial point once by
  ``factor``;
- stochastic mode feeds each block's own loss, and the lr stays fixed within
  the epoch.

The momentum buffers are those of the run's ``torch.optim.SGD``
(``DriverState.momentum``, None before the first step), so its
``state_dict()`` carries them; the drivers' own scratch travels through
``get_state``/``set_state``.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch

from ..grad_reg import tree_add_scaled, tree_scale

log = logging.getLogger(__name__)


@dataclasses.dataclass
class DriverState:
    """What a closure step reads and returns: the step counter, the params
    (a list, never changed in place) and the SGD momentum buffers (None
    before the first update)."""

    step: int
    params: list
    momentum: list | None = None


def tree_dot(a, b) -> torch.Tensor:
    return torch.stack([torch.sum(x * y) for x, y in zip(a, b)]).sum()


def wd_factors(param_paths, cfg_hyp):
    """Per-param weight-decay factors, None without weight decay; with
    ``hyp.only_linear_layers_weight_decay`` 0 where NO_WD_PATTERN matches the
    param's JAX path (the reference's per-group weight decay)."""
    from ..optimizers import NO_WD_PATTERN
    wd = float(cfg_hyp.optim.get("weight_decay", 0.0) or 0.0)
    if not wd:
        return None
    if cfg_hyp.get("only_linear_layers_weight_decay", False):
        return [0.0 if NO_WD_PATTERN.search(path) else wd for path in param_paths]
    return [wd] * len(param_paths)


def apply_wd(grads, params, wdt):
    """``grads + wd * params`` with the per-param factors of :func:`wd_factors`."""
    if wdt is None:
        return grads
    return [g + w * p for g, p, w in zip(grads, params, wdt)]


def _descent_direction(grads, params, momentum, cfg_optim, wdt):
    """torch-SGD direction and momentum-buffer update: returns ``(p_k, new
    buffers, phi'(0))``. ``momentum`` None is the first step (buffer = grad)."""
    mu, dampening = float(cfg_optim.momentum), float(cfg_optim.dampening)
    g = apply_wd(grads, params, wdt)
    if mu:
        if momentum is None:
            buf = [gg.clone() for gg in g]
        else:
            buf = [mu * b + (1 - dampening) * gg for b, gg in zip(momentum, g)]
        direction = tree_add_scaled(g, buf, mu) if cfg_optim.nesterov else buf
    else:
        buf = momentum
        direction = g
    p_k = tree_scale(direction, -1.0)
    return p_k, buf, float(tree_dot(g, p_k))


def _finish(state, params, momentum, metrics):
    return dataclasses.replace(state, step=state.step + 1, params=params,
                               momentum=momentum), metrics


class _ResumableDriver:
    """The driver's scratch rides with the checkpoint."""

    def get_state(self):
        return {"losses": [float(v) for v in getattr(self, "losses", [])]}

    def set_state(self, payload):
        if "losses" in payload:
            self.losses = [float(v) for v in payload["losses"]]


class RestartingLineSearch(_ResumableDriver):
    """Reset momentum and redo the step when the loss reaches the maximum of
    the last ``interval`` losses."""

    def __init__(self, fns, cfg):
        self.fns = fns
        self.hyp = cfg.hyp
        self.optim = cfg.hyp.optim
        self.interval = int(cfg.hyp.optim.get("interval", 10))
        self.losses: list[float] = []

    def step(self, state, images, labels):
        lr = self.fns.schedule(state.step)
        grads, metrics = self.fns.gradient_eval(state, images, labels)
        loss = float(metrics["train_loss"])
        wdt = wd_factors(self.fns.param_paths, self.hyp)
        p_k, momentum, _ = _descent_direction(grads, state.params, state.momentum,
                                              self.optim, wdt)
        params = tree_add_scaled(state.params, p_k, lr)

        if not self.losses:
            # the reference seeds the history with the first loss twice
            self.losses.append(loss)
        if len(self.losses) < self.interval:
            self.losses.append(loss)
        else:
            recent_max = max(self.losses[-self.interval:])
            if loss < recent_max:
                self.losses.append(loss)
            else:
                log.info("Recent maximum was %g, but new loss is %g. Resetting momentum...",
                         recent_max, loss)
                zero = [torch.zeros_like(p) for p in state.params]
                p_k, momentum, _ = _descent_direction(grads, state.params, zero,
                                                      self.optim, wdt)
                params = tree_add_scaled(state.params, p_k, lr)
        metrics["lr"] = lr
        return _finish(state, params, momentum, metrics)


class NonMonotoneLinesearch(_ResumableDriver):
    """Retry the step with a factor-shrunk gradient until the loss beats the
    maximum of the last ``interval`` losses."""

    def __init__(self, fns, cfg):
        self.fns = fns
        self.hyp = cfg.hyp
        self.optim = cfg.hyp.optim
        self.interval = int(cfg.hyp.optim.get("interval", 10))
        self.factor = float(cfg.hyp.optim.get("factor", 0.25))
        self.max_iter = int(cfg.hyp.optim.get("max_iter", 10))
        self.losses: list[float] = []

    def step(self, state, images, labels):
        lr = self.fns.schedule(state.step)
        grads, metrics = self.fns.gradient_eval(state, images, labels)
        loss = float(metrics["train_loss"])
        wdt = wd_factors(self.fns.param_paths, self.hyp)

        def take(gr):
            p_k, momentum, _ = _descent_direction(gr, state.params, state.momentum,
                                                  self.optim, wdt)
            return tree_add_scaled(state.params, p_k, lr), momentum

        params, momentum = take(grads)

        if not self.losses:
            self.losses.append(loss)   # seeded twice, as in the reference
        if len(self.losses) < self.interval:
            self.losses.append(loss)
        else:
            # each retry restores the initial params and momentum and scales
            # the latest closure gradient once by `factor`; the check reads the
            # latest closure loss; an exhausted loop keeps the last trial
            # without recording its loss
            recent_max = max(self.losses[-self.interval:])
            cur_g = grads
            for _ in range(self.max_iter):
                if loss < recent_max:
                    self.losses.append(loss)
                    break
                log.info("Recent maximum was %g, but new loss is %g. Reducing lr by %g.",
                         recent_max, loss, self.factor)
                cur_g = tree_scale(cur_g, self.factor)
                params, momentum = take(cur_g)
                cur_g, m2 = self.fns.gradient_eval(dataclasses.replace(state, params=params),
                                                   images, labels)
                loss = float(m2["train_loss"])
        metrics["lr"] = lr
        return _finish(state, params, momentum, metrics)


class WolfeGradientDescent(_ResumableDriver):
    """Strong-Wolfe line search along the (momentum) descent direction with
    cubic-interpolation zoom."""

    def __init__(self, fns, cfg):
        self.fns = fns
        self.hyp = cfg.hyp
        self.optim = cfg.hyp.optim
        self.c1 = float(cfg.hyp.optim.get("c1", 1e-4))
        self.c2 = float(cfg.hyp.optim.get("c2", 0.9))
        self.alpha_max = float(cfg.hyp.optim.get("alpha_max", 10.0))
        self.max_iter = int(cfg.hyp.optim.get("max_iter", 10))

    def _phi(self, state, images, labels, theta0, p_k, lr, alpha, lut, track):
        """phi(a) = loss(theta0 + lr*a*p_k); phi'(a) = (grad + wd*theta) . p_k.
        A fresh (LUT-miss) evaluation becomes the last attempted step."""
        if alpha in lut:
            entry = lut[alpha]
            return entry["val"], entry["grad"], entry
        params = tree_add_scaled(theta0, p_k, lr * alpha)
        grads, metrics = self.fns.gradient_eval(dataclasses.replace(state, params=params),
                                                images, labels)
        g = apply_wd(grads, params, wd_factors(self.fns.param_paths, self.hyp))
        entry = {"val": float(metrics["train_loss"]), "grad": float(tree_dot(g, p_k)),
                 "params": params, "metrics": metrics}
        lut[alpha] = entry
        track["last"] = entry
        return entry["val"], entry["grad"], entry

    @staticmethod
    def _interpolate(a1, a2, lut):
        """Cubic interpolation; non-finite endpoint values bisect."""
        if a1 == a2:
            return a1
        if not all(math.isfinite(lut[a]["val"]) and math.isfinite(lut[a]["grad"])
                   for a in (a1, a2)):
            return 0.5 * (a1 + a2)
        quotient = (lut[a1]["val"] - lut[a2]["val"]) / (a1 - a2)
        d_1 = lut[a1]["grad"] + lut[a2]["grad"] - 3 * quotient
        radicand = d_1**2 - lut[a1]["grad"] * lut[a2]["grad"]
        if radicand < 0:
            return 0.5 * (a1 + a2)
        d_2 = math.copysign(1.0, a2 - a1) * math.sqrt(radicand)
        nom = lut[a2]["grad"] + d_2 - d_1
        denom = lut[a2]["grad"] - lut[a1]["grad"] + 2 * d_2
        if denom == 0:
            return 0.5 * (a1 + a2)
        return a2 - (a2 - a1) * nom / denom

    def _zoom(self, alpha_low, alpha_high, phi_eval, phi0, lut):
        for _ in range(self.max_iter):
            if abs(alpha_low - alpha_high) < 1e-4:
                return alpha_low
            alpha = self._interpolate(alpha_low, alpha_high, lut)
            val, grad, _ = phi_eval(alpha)
            sufficient = phi0["val"] + self.c1 * alpha * phi0["grad"]
            if (not math.isfinite(val) or val > sufficient
                    or val > lut[alpha_low]["val"]):
                alpha_high = alpha
            else:
                if grad <= -self.c2 * phi0["grad"]:
                    return alpha
                if grad * (alpha_high - alpha_low) >= 0:
                    alpha_high = alpha_low
                alpha_low = alpha
        return self._interpolate(alpha_low, alpha_high, lut)

    def step(self, state, images, labels):
        lr = float(self.fns.schedule(state.step))
        grads, metrics = self.fns.gradient_eval(state, images, labels)
        loss = float(metrics["train_loss"])
        theta0 = state.params
        p_k, momentum, phi0_grad = _descent_direction(
            grads, theta0, state.momentum, self.optim,
            wd_factors(self.fns.param_paths, self.hyp))
        if phi0_grad > 0:
            log.info("phi'=%g is positive. p_k is not a descent direction.", phi0_grad)

        lut: dict[float, dict] = {0.0: {"val": loss, "grad": phi0_grad, "params": theta0,
                                        "metrics": metrics}}
        phi0 = lut[0.0]
        track = {"last": phi0}

        def phi_eval(alpha):
            return self._phi(state, images, labels, theta0, p_k, lr, alpha, lut, track)

        alpha, prev_alpha, prev_loss = 1.0, 0.0, float("inf")
        for _ in range(self.max_iter):
            val, grad, _ = phi_eval(alpha)
            sufficient = phi0["val"] + self.c1 * alpha * phi0["grad"]
            # a NaN trial loss is an Armijo violation: zoom into the bracket
            if not math.isfinite(val) or val > sufficient or val > prev_loss:
                alpha = self._zoom(prev_alpha, alpha, phi_eval, phi0, lut)
                break
            if abs(grad) <= -self.c2 * phi0["grad"]:
                break
            if grad >= 0:
                alpha = self._zoom(alpha, prev_alpha, phi_eval, phi0, lut)
                break
            # prev_loss stays inf (the reference never updates it)
            prev_alpha = alpha
            last_evaluated = alpha
            alpha = min(alpha * 2.5, self.alpha_max)
            if alpha == self.alpha_max:
                # bracket exhausted growing: no step at the grown alpha
                alpha = last_evaluated
                break
        else:
            alpha = prev_alpha

        # the params stay where the last fresh attempt put them
        chosen = track["last"]
        metrics = dict(chosen["metrics"])
        metrics["lr"] = lr
        metrics["wolfe_alpha"] = alpha
        return _finish(state, chosen["params"], momentum, metrics)


_DRIVERS = {
    "restarting": RestartingLineSearch,
    "non-monotone": NonMonotoneLinesearch,
    "wolfe": WolfeGradientDescent,
}


class _BlockFns:
    """The evaluation hook every driver is built over. With ``bidx=None``
    (full-batch mode) ``gradient_eval`` is ``fns``'s full-batch evaluation;
    with an integer ``bidx`` (stochastic mode) it is ``fns.block_gradient_eval``
    on the block the caller passes. One facade a driver lets one driver
    object, its scratch and its checkpoint serve both modes."""

    def __init__(self, fns):
        self._fns = fns
        self.schedule = fns.schedule
        self.bidx = None

    def gradient_eval(self, state, images, labels):
        if self.bidx is None:
            return self._fns.gradient_eval(state, images, labels)
        return self._fns.block_gradient_eval(state, images, labels)

    def __getattr__(self, name):
        return getattr(self._fns, name)


def make_stochastic_closure_step(driver):
    """Per-block closure optimization in stochastic mode: ``step(state,
    blocks)`` runs ``driver.step`` once per ``(images, labels)`` of
    ``blocks`` against the per-block evaluation, the step counter (and the lr)
    fixed within the epoch, then advances it once. The metrics are the last
    block's with ``train_loss``/``train_acc`` the blocks' means. Pass the
    run's driver, so its scratch spans blocks, mode switches and resume."""
    block_fns = driver.fns

    def step(state, blocks):
        epoch_step = state.step
        loss_sum, acc_sum, n = 0.0, 0.0, 0
        metrics = {}
        for block, (images, labels) in enumerate(blocks):
            block_fns.bidx = block
            state, metrics = driver.step(state, images, labels)
            state = dataclasses.replace(state, step=epoch_step)
            loss_sum += float(metrics["train_loss"])
            acc_sum += float(metrics["train_acc"])
            n += 1
        block_fns.bidx = None
        state = dataclasses.replace(state, step=epoch_step + 1)
        metrics = dict(metrics)
        metrics["train_loss"] = loss_sum / n
        metrics["train_acc"] = acc_sum / n
        return state, metrics

    return step


def make_closure_step(fns, cfg, kind: str):
    """The driver object of ``kind`` (``driver.step(state, images, labels)``,
    ``get_state``/``set_state``), built over a :class:`_BlockFns` facade."""
    fns = fns if isinstance(fns, _BlockFns) else _BlockFns(fns)
    if kind == "lbfgs":
        from .lbfgs import LBFGSDriver
        return LBFGSDriver(fns, cfg)
    if kind == "fista-search":
        from .fista import FISTALineSearchDriver
        return FISTALineSearchDriver(fns, cfg)
    if kind not in _DRIVERS:
        raise ValueError(f"Invalid linesearch {kind} defined.")
    return _DRIVERS[kind](fns, cfg)
