"""Layer factory: convolution, BatchNorm and nonlinearity constructors.

Counterpart of ``fullbatchtraining_tpu/models/layers.py`` for the layers of
this port's slice: zero-padded ``Standard`` convolutions with kaiming-normal
fan-out init and ``BatchNorm2d`` on the BN kernels of ``ops.bn``. Modules
take NCHW tensors; the model keeps them in ``torch.channels_last``, so every
BN input is a row-major ``[M, C]`` view without a copy.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn as bn_ops


def kaiming_normal_out_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """torch's kaiming_normal_(mode='fan_out', nonlinearity='relu'), the
    JAX package's ``kaiming_normal_out``."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def torch_default_linear_(layer: nn.Linear, generator: torch.Generator | None) -> None:
    """torch's Linear default, uniform(+-1/sqrt(fan_in)) for weight and bias,
    drawn from ``generator`` (``torch_linear_init``/``torch_default_bias``)."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if layer.bias is not None:
            layer.bias.uniform_(-bound, bound, generator=generator)


def _conv(in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
          padding: int = 0, groups: int = 1, bias: bool = False, dilation: int = 1,
          generator: torch.Generator | None = None) -> nn.Conv2d:
    """Zero-padded conv, kaiming-normal fan-out weights, zero bias."""
    conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride, padding=padding,
                     dilation=dilation, groups=groups, bias=bias)
    kaiming_normal_out_(conv.weight, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


class BatchNorm2d(nn.Module):
    """BatchNorm with the semantics of the JAX package's ``_TorchBatchNorm``.

    * flax momentum convention (0.9 here equals torch's 0.1):
      ``running = momentum * running + (1 - momentum) * batch``;
    * the running variance takes the unbiased batch variance (``n/(n-1)``),
      normalisation uses the biased one;
    * statistics in ``promote(x.dtype, float32)``;
    * bfloat16 inputs see ``weight``/``bias`` rounded to bfloat16 first, as
      the JAX step casts every param to the compute dtype before the forward.

    Train mode runs ``ops.bn.bn_train``; eval mode runs the ``apply`` kernel
    with ``a``, ``b`` folded from the running stats and is not
    differentiable (call it under ``torch.no_grad()``).
    """

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 scale_init: float = 1.0):
        super().__init__()
        self.channels = channels
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.permute(0, 2, 3, 1)  # NHWC: contiguous when x is channels_last
        scale, bias = self.weight, self.bias
        if x.dtype == torch.bfloat16:
            scale, bias = scale.to(x.dtype), bias.to(x.dtype)
        if self.training:
            y, mean, var = bn_ops.bn_train(rows, scale, bias, self.epsilon)
            n = rows.numel() / self.channels
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var * (n / max(n - 1, 1)))
        else:
            if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
                raise RuntimeError("eval-mode BatchNorm2d is not differentiable; "
                                   "call it under torch.no_grad()")
            acc = bn_ops.stat_dtype(x.dtype)
            a = scale.to(acc) * torch.rsqrt(self.running_var.to(acc) + self.epsilon)
            b = bias.to(acc) - self.running_mean.to(acc) * a
            flat = bn_ops.apply(bn_ops.as_rows(rows), torch.stack([a, b]))
            y = flat.view(rows.shape)
        return y.permute(0, 3, 1, 2)


def get_layer_functions(convolution_type: str, norm: str, nonlin: str):
    """``(conv_ctor, norm_ctor, nonlin_fn)`` for the slice's layers.

    conv_ctor(in_channels, features, kernel_size=, stride=, padding=, groups=,
    bias=, dilation=, generator=); norm_ctor(channels, scale_init=)."""
    if convolution_type.lower() not in ("standard", "default", "zeros"):
        raise NotImplementedError(
            f"convolution type {convolution_type!r} is not ported yet "
            "(ROADMAP.md, 'Other model families and norms')")
    if norm.lower() != "batchnorm2d":
        raise NotImplementedError(
            f"norm {norm!r} is not ported yet "
            "(ROADMAP.md, 'Other model families and norms')")
    return _conv, BatchNorm2d, get_nonlin(nonlin)


_NONLINS: dict[str, Callable] = {
    "relu": F.relu,
    "gelu": partial(F.gelu, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "celu": F.celu,
    "selu": F.selu,
    "leakyrelu": F.leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "hardswish": F.hardswish,
    "mish": F.mish,
    "identity": lambda x: x,
}


def get_nonlin(name: str) -> Callable:
    try:
        return _NONLINS[name.lower()]
    except KeyError as err:
        raise ValueError(f"Invalid nonlinearity {name}.") from err


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))
