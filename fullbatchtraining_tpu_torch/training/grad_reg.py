"""Gradient-norm regularization (``fullbatchtraining_tpu/training/grad_reg.py``).

The regularizer adds an approximation of ``(lr/4) * H @ (block_strength * g
+ acc_strength * g_pre)`` to each chunk gradient ``g``: the gradient of the
penalty ``(lr/4) * s * ||grad L||^2``. ``hyp.grad_reg.implementation``
selects how:

* ``forward-differences``: one extra gradient at ``params + eps_n * v``,
  ``eps_n = eps / ||v||``;
* ``forward-differences-legacy``: the same along ``v = g``, scaled by
  ``block_strength`` afterwards; ``acc_strength`` is ignored;
* ``central-differences``: two extra gradients at ``params +- eps_n/2 * v``;
* ``autograd`` and ``complex-step``: one exact Hessian-vector product on the
  combined direction, reverse over reverse (``create_graph=True``, then a
  gradient of the gradient against ``v``; the Hessian is symmetric, so this
  is the JAX package's forward-over-reverse ``H @ v``);
* ``autograd-pen``: the gradient of the explicit penalty, with the
  reference's factor 2 when there are no ``pre_grads``.

Gradients and parameters are lists of tensors in the order of
``model.parameters()``. The exact variants differentiate BatchNorm twice,
which ``ops.bn.BNTrain`` supports.
"""

from __future__ import annotations

from typing import Callable

import torch

VARIANTS = ("forward-differences", "forward-differences-legacy", "central-differences",
            "autograd", "autograd-pen", "complex-step")


def tree_sqnorm(tensors) -> torch.Tensor:
    return torch.stack([t.square().sum() for t in tensors]).sum()


def tree_add_scaled(a, b, alpha):
    return [x + alpha * y for x, y in zip(a, b)]


def tree_scale(a, alpha):
    return [alpha * x for x in a]


def _leaves(params, v=None, alpha=None):
    """Fresh leaves that require grad: ``params``, or ``params + alpha * v``."""
    with torch.no_grad():
        values = params if v is None else tree_add_scaled(params, v, alpha)
        return [p.detach().requires_grad_() for p in values]


def make_grad_regularizer(cfg_reg, grad_fn: Callable):
    """Build the per-chunk regularizer.

    ``grad_fn(params, images, labels, create_graph=False) -> grads``
    re-evaluates the chunk gradient with respect to ``params`` (tensors that
    require grad), on the chunk's own inputs, with BatchNorm in train mode
    and its running stats left alone.

    Returns ``reg_fn(grads, params, images, labels, pre_grads, lr) -> grads``,
    or ``None`` when both strengths are 0.
    """
    block_strength = float(cfg_reg.block_strength)
    acc_strength = float(cfg_reg.acc_strength)
    eps = float(cfg_reg.eps)
    implementation = cfg_reg.implementation

    if block_strength == 0.0 and acc_strength == 0.0:
        return None
    if implementation not in VARIANTS:
        raise ValueError(f"Invalid spec. given for regularizer implementation: {implementation}")
    if implementation == "autograd-pen" and acc_strength != 0 and block_strength == 0:
        raise ValueError("Requires non-zero block strength if computing pre_grads")

    def direction(grads, pre_grads):
        v = tree_scale(grads, block_strength)
        if pre_grads is not None and acc_strength != 0.0:
            v = tree_add_scaled(v, pre_grads, acc_strength)
        return v

    def regrad(params, images, labels, v=None, alpha=None):
        """The gradient at ``params + alpha * v``, with no graph kept."""
        return [g.detach() for g in grad_fn(_leaves(params, v, alpha), images, labels)]

    def reg_fn(grads, params, images, labels, pre_grads, lr):
        correction = lr / 4.0

        if implementation in ("autograd", "complex-step"):
            # one exact HVP on the combined direction (linear in v)
            v = direction(grads, pre_grads)
            p = _leaves(params)
            g = grad_fn(p, images, labels, create_graph=True)
            hv = torch.autograd.grad(g, p, grad_outputs=[t.to(x.dtype) for t, x in zip(v, g)])
            return tree_add_scaled(grads, hv, correction)

        if implementation == "autograd-pen":
            p = _leaves(params)
            g = grad_fn(p, images, labels, create_graph=True)
            if pre_grads is not None and acc_strength != 0.0:
                fac = 1.0 / (2.0 * block_strength)
                mix = tree_add_scaled(tree_scale(g, block_strength), pre_grads, acc_strength)
                penalty = fac * tree_sqnorm(mix)
            else:
                penalty = block_strength * tree_sqnorm(g)
            vhp = torch.autograd.grad(penalty, p)
            return tree_add_scaled(grads, vhp, correction)

        if implementation == "forward-differences-legacy":
            eps_n = eps / torch.sqrt(tree_sqnorm(grads))
            offset = regrad(params, images, labels, grads, eps_n)
            hv = tree_scale([o - g for o, g in zip(offset, grads)], 1.0 / eps_n)
            return tree_add_scaled(grads, hv, correction * block_strength)

        v = direction(grads, pre_grads)
        eps_n = eps / torch.sqrt(tree_sqnorm(v))

        if implementation == "forward-differences":
            offset = regrad(params, images, labels, v, eps_n)
            hv = tree_scale([o - g for o, g in zip(offset, grads)], 1.0 / eps_n)
            return tree_add_scaled(grads, hv, correction)

        # central-differences
        plus = regrad(params, images, labels, v, 0.5 * eps_n)
        minus = regrad(params, images, labels, v, -0.5 * eps_n)
        hv = tree_scale([a - b for a, b in zip(plus, minus)], 1.0 / eps_n)
        return tree_add_scaled(grads, hv, correction)

    return reg_fn
