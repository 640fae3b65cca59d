"""The parts every model family of the reference shares: train-mode
BatchNorm, the default layer functions, the benchmark's draws of initial
weights and the parameters and running statistics of a flat list of layers.

A family module (``resnet.py``, ``densenet.py``, one for each value of a
configuration's ``model`` less its trailing digits) gives ``architecture``,
``layers``, ``parameter_shapes``, ``init_std``, ``initial_stats``,
``forward`` and ``tiny``; its layers are tuples ``("conv", name, cin, cout,
k, stride, h_in)``, ``("bn", name, c, h)``, ``("pool", name, stride)`` and
``("fc", name, cin, cout)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def require(config: dict, wanted: dict) -> None:
    """Raise where ``config`` states another value than ``wanted``, the
    settings the reference builds."""
    wrong = {k: (config.get(k), v) for k, v in wanted.items() if config.get(k) != v}
    if wrong:
        raise ValueError(f"the reference builds only (stated, built): {wrong}")


def update_stats_(stats, name, mean, var, n) -> None:
    """Move ``stats[name.*]`` towards a batch's mean and biased variance over
    ``n`` values a channel."""
    with torch.no_grad():
        rm, rv = stats[f"{name}.running_mean"], stats[f"{name}.running_var"]
        rm.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean.detach())
        rv.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var.detach() * n / (n - 1))


def batch_norm(x, weight, bias, stats, name, update_stats: bool):
    """Train-mode BatchNorm of NCHW ``x``; moves ``stats[name.*]`` in place
    when ``update_stats``."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    if update_stats:
        update_stats_(stats, name, mean, var, x.numel() / x.shape[1])
    scale = weight * torch.rsqrt(var + BN_EPS)
    return x * scale[None, :, None, None] + (bias - mean * scale)[None, :, None, None]


class Functions:
    """A forward's ``conv(x, w, stride, padding)``, ``linear(x, w, b)``,
    ``act(t)`` and ``norm``: ``F.conv2d``, ``F.linear``, none and
    :func:`batch_norm` where not given (:mod:`.precision` gives its own)."""

    def __init__(self, conv, linear, act, norm):
        self.conv = conv or (lambda x, w, stride, padding: F.conv2d(x, w, None, stride, padding))
        self.linear = linear or F.linear
        self.act = act or (lambda t: t)
        self.norm = norm or batch_norm


def parameter_shapes(layers) -> dict:
    """``{name: (shape, kind)}`` of every parameter of the flat ``layers``,
    ``kind`` one of ``conv`` (fan-out ``cout * k * k``), ``bn_weight``,
    ``bn_bias``, ``fc_weight``, ``fc_bias``."""
    shapes = {}
    for layer in layers:
        if layer[0] == "conv":
            _, name, cin, cout, k, _, _ = layer
            shapes[f"{name}.weight"] = ((cout, cin, k, k), "conv")
        elif layer[0] == "bn":
            _, name, c, _ = layer
            shapes[f"{name}.weight"] = ((c,), "bn_weight")
            shapes[f"{name}.bias"] = ((c,), "bn_bias")
        elif layer[0] == "fc":
            _, name, cin, cout = layer
            shapes[f"{name}.weight"] = ((cout, cin), "fc_weight")
            shapes[f"{name}.bias"] = ((cout,), "fc_bias")
    return shapes


def initial_stats(layers, device) -> dict:
    """Running statistics of the flat ``layers`` before the first step: mean
    0, variance 1."""
    stats = {}
    for layer in layers:
        if layer[0] == "bn":
            c = layer[2]
            stats[f"{layer[1]}.running_mean"] = torch.zeros(c, device=device)
            stats[f"{layer[1]}.running_var"] = torch.ones(c, device=device)
    return stats


def init_std(shape, kind) -> tuple[float, float]:
    """``(mean, std)`` of the benchmark's draws for a parameter: He (fan-out)
    for convolutions, ``1/sqrt(fan_in)`` for the linear weight, BN scale
    around 1 and shifts around 0 (none zero, so every residual branch
    carries gradient from the first step)."""
    if kind == "conv":
        return 0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "fc_weight":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if kind == "bn_weight":
        return 1.0, 0.1
    return 0.0, 0.05
