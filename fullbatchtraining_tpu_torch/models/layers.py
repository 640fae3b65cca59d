"""Layer factory: convolution, normalization and nonlinearity constructors.

Counterpart of ``fullbatchtraining_tpu/models/layers.py``: zero-padded
``Standard`` convolutions with kaiming-normal fan-out init, scaled
weight-standardized ones (``WSConv2d``), ``BatchNorm2d`` on the BN kernels of
``ops.bn`` and the norms of the zoo (``GroupNorm2d``, ``LayerNorm2d``,
``InstanceNorm2d``, ``Identity``; ``GhostBatchNorm`` lives in
``modules.py``). Modules take NCHW tensors; the model keeps them in
``torch.channels_last``, so every BN input is a row-major ``[M, C]`` view
without a copy.

A norm whose JAX counterpart wraps an inner flax module names that module in
``jax_inner`` (``bn``, ``gn``, ``ln``): ``convert.py`` puts its leaves one
level down, and the activation estimate counts its output twice, as the JAX
package's trace does.

The initialisers take ``(tensor, generator)`` and follow the JAX package's
distributions (its bits cannot match: threefry vs Philox).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn as bn_ops
from ..ops import pool


def _fans(weight: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of an ``[out, in, *kernel]`` weight."""
    receptive = weight[0, 0].numel() if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def kaiming_normal_out_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """torch's kaiming_normal_(mode='fan_out', nonlinearity='relu'), the
    JAX package's ``kaiming_normal_out``."""
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / _fans(weight)[1]), generator=generator)


def kaiming_normal_in_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """torch's kaiming_normal_() defaults (fan_in, relu): ``kaiming_normal_in``."""
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / _fans(weight)[0]), generator=generator)


def torch_default_conv_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """torch's Conv2d/Linear default weight, uniform(+-1/sqrt(fan_in))
    (``torch_default_conv``, ``torch_linear_init``)."""
    bound = 1.0 / math.sqrt(_fans(weight)[0])
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def xavier_normal_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax ``xavier_normal``: variance 2/(fan_in + fan_out), drawn from a
    standard normal truncated to (-2, 2) and rescaled to that variance."""
    fan_in, fan_out = _fans(weight)
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


def normal_(std: float):
    def init(weight: torch.Tensor, generator: torch.Generator | None) -> None:
        with torch.no_grad():
            weight.normal_(0.0, std, generator=generator)
    return init


def zeros_(tensor: torch.Tensor, generator: torch.Generator | None = None) -> None:
    with torch.no_grad():
        tensor.zero_()


def torch_default_bias_(fan_in: int):
    """torch's module-default bias, uniform(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(bias: torch.Tensor, generator: torch.Generator | None) -> None:
        with torch.no_grad():
            bias.uniform_(-bound, bound, generator=generator)
    return init


def half_product(fn: Callable, x: torch.Tensor, weight: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, weight, None, *args)``, ``F.conv2d`` or ``F.linear``, without
    bias. On the CPU, a float16 product (float16 inputs, or under float16
    autocast) runs in float32 and rounds once, as XLA's CPU backend computes
    it; torch's own CPU float16 kernels, on a host with AVX512-FP16, round
    as they accumulate and underflow otherwise."""
    if x.device.type == "cpu":
        autocast = torch.is_autocast_enabled("cpu")
        dtype = torch.get_autocast_dtype("cpu") if autocast else x.dtype
        if dtype == torch.float16:
            with torch.autocast("cpu", enabled=False):
                return fn(x.to(dtype).float(), weight.to(dtype).float(), None,
                          *args).to(dtype)
    return fn(x, weight, None, *args)


def add_bias(y: torch.Tensor, bias: torch.Tensor | None, channels_axis: int = -1):
    """``y + bias`` along ``channels_axis``, in ``y``'s dtype: flax ``Dense``
    and ``Conv`` round the product to a half dtype, then the sum
    (``F.linear``/``F.conv2d`` with a bias round once)."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channels_axis] = -1
    return y + bias.to(y.dtype).view(shape)


class Linear(nn.Linear):
    """``nn.Linear`` through :func:`half_product` and :func:`add_bias`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_bias(half_product(F.linear, x, self.weight), self.bias)


class Conv2d(nn.Conv2d):
    """Zero-padded ``nn.Conv2d`` through :func:`half_product` and
    :func:`add_bias`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = half_product(F.conv2d, x, self.weight, self.stride, self.padding, self.dilation,
                         self.groups)
        return add_bias(y, self.bias, 1)


def linear(in_features: int, out_features: int, generator: torch.Generator | None,
           weight_init: Callable = torch_default_conv_,
           bias_init: Callable | None = None) -> nn.Linear:
    """:class:`Linear` drawn from ``generator``: ``weight_init`` for the
    weight, ``bias_init`` (default: torch's uniform) for the bias."""
    layer = Linear(in_features, out_features)
    weight_init(layer.weight, generator)
    (bias_init or torch_default_bias_(in_features))(layer.bias, generator)
    return layer


def _conv(in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
          padding: int = 0, groups: int = 1, bias: bool = False, dilation: int = 1,
          generator: torch.Generator | None = None, kernel_init: Callable = kaiming_normal_out_,
          bias_init: Callable = zeros_) -> nn.Conv2d:
    """Zero-padded :class:`Conv2d`; kaiming-normal fan-out weights and zero
    bias unless ``kernel_init``/``bias_init`` say otherwise."""
    conv = Conv2d(in_channels, features, kernel_size, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=bias)
    kernel_init(conv.weight, generator)
    if conv.bias is not None:
        bias_init(conv.bias, generator)
    return conv


class WSConv2d(nn.Module):
    """Scaled weight-standardized convolution (NFNet's; JAX ``WSConv2d``).

    The weight is ``(w - mean) * rsqrt(max(var * fan_in, 1e-4)) * gain``,
    mean and unbiased var over the fan-in of each output channel, made from
    the float parameters on every call, so under bf16 autocast the
    standardization runs in float32 and only the convolution in bf16.
    Xavier-normal weight, gain 1, torch-default uniform bias."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True, dilation: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.groups, self.dilation = stride, padding, groups, dilation
        self.weight = nn.Parameter(torch.empty(features, in_channels // groups,
                                               kernel_size, kernel_size))
        self.gain = nn.Parameter(torch.ones(features))
        self.fan_in = self.weight[0].numel()
        xavier_normal_(self.weight, generator)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(features))
            torch_default_bias_(self.fan_in)(self.bias, generator)

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=True)
        scale = torch.rsqrt(torch.clamp(var * self.fan_in, min=1e-4))
        return (w - mean) * scale * self.gain.view(-1, 1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = half_product(F.conv2d, x, self.standardized_weight(), self.stride, self.padding,
                         self.dilation, self.groups)
        return add_bias(y, self.bias, 1)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

_stat_updates = True


class no_stat_updates:
    """Norms leave their running stats alone inside this block: a
    checkpointed forward's recompute runs in it, so a forward updates them
    once, as the JAX package's ``nn.remat`` does. Reentrant: a double
    backward enters one instance again."""

    def __init__(self):
        self._previous = []

    def __enter__(self):
        global _stat_updates
        self._previous.append(_stat_updates)
        _stat_updates = False

    def __exit__(self, *exc):
        global _stat_updates
        _stat_updates = self._previous.pop()


def stat_updates_on() -> bool:
    return _stat_updates


_HALF = (torch.bfloat16, torch.float16)


def half_affine(x: torch.Tensor, *params: torch.Tensor) -> list[torch.Tensor]:
    """``params`` rounded to ``x.dtype`` where that is bfloat16 or float16:
    the JAX step casts every param to the compute dtype before the forward."""
    return [p.to(x.dtype) if x.dtype in _HALF else p for p in params]


def ema_(running: torch.Tensor, batch: torch.Tensor, momentum: float, factor: float = 1.0):
    """``running = momentum * running + (1 - momentum) * batch * factor``."""
    with torch.no_grad():
        running.copy_(momentum * running + (1 - momentum) * batch * factor)


def eval_affine(x: torch.Tensor, weight, bias, running_mean, running_var, eps) -> torch.Tensor:
    """Eval-mode BatchNorm of NCHW ``x`` from running stats
    (``ops.bn.bn_eval``: the ``apply`` kernel with ``a``, ``b`` folded in
    ``stat_dtype``), differentiable in ``x``, ``weight`` and ``bias``."""
    rows = x.permute(0, 2, 3, 1)  # NHWC: contiguous when x is channels_last
    y = bn_ops.bn_eval(rows, weight, bias, running_mean, running_var, eps)
    return y.permute(0, 3, 1, 2)


class BatchNorm2d(nn.Module):
    """BatchNorm with the semantics of the JAX package's ``_TorchBatchNorm``.

    * flax momentum convention (0.9 here equals torch's 0.1):
      ``running = momentum * running + (1 - momentum) * batch``;
    * the running variance takes the unbiased batch variance (``n/(n-1)``),
      normalisation uses the biased one;
    * statistics in ``promote(x.dtype, float32)``;
    * bfloat16 and float16 inputs see ``weight``/``bias`` rounded to their
      dtype first;
    * the input's gradient is the sum of two parts each rounded to the
      input's dtype (``bn_train(..., split_dx=True)``): ``_TorchBatchNorm``
      casts x to float32 twice, and autodiff casts each cotangent back.

    Train mode runs ``ops.bn.bn_train``; eval mode runs the ``apply`` kernel
    with ``a``, ``b`` folded from the running stats (:func:`eval_affine`),
    differentiable through ``apply`` and ``bwd_reduce``. ``jax_inner="bn"``
    is the JAX ``BatchNorm2d`` wrapper; None is a bare ``_TorchBatchNorm``
    (PyramidNet's).
    """

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 scale_init: float = 1.0, jax_inner: str | None = "bn"):
        super().__init__()
        self.channels = channels
        self.momentum = momentum
        self.epsilon = epsilon
        self.jax_inner = jax_inner
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = half_affine(x, self.weight, self.bias)
        if not self.training:
            return eval_affine(x, scale, bias, self.running_mean, self.running_var,
                               self.epsilon)
        rows = x.permute(0, 2, 3, 1)  # NHWC: contiguous when x is channels_last
        y, mean, var = bn_ops.bn_train(rows, scale, bias, self.epsilon, split_dx=True)
        if _stat_updates:
            n = rows.numel() / self.channels
            ema_(self.running_mean, mean, self.momentum)
            ema_(self.running_var, var, self.momentum, n / max(n - 1, 1))
        return y.permute(0, 3, 1, 2)


class GroupNorm2d(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-5) over NCHW, holding ``gn.{scale,bias}``;
    ``channels`` must be a multiple of ``num_groups``, as flax requires."""

    jax_inner = "gn"

    def __init__(self, channels: int, num_groups: int = 32, scale_init: float = 1.0):
        super().__init__()
        if num_groups <= 0 or channels % num_groups:
            raise ValueError(f"Number of groups ({num_groups}) does not divide the number "
                             f"of channels ({channels}).")
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = half_affine(x, self.weight, self.bias)
        return F.group_norm(x, self.num_groups, weight, bias, 1e-5).to(x.dtype)


class LayerNorm2d(nn.Module):
    """flax ``nn.LayerNorm()`` as the JAX package applies it to NHWC
    activations: over the channel axis alone, per pixel, eps 1e-6, holding
    ``ln.{scale,bias}``."""

    jax_inner = "ln"

    def __init__(self, channels: int, scale_init: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = half_affine(x, self.weight, self.bias)
        rows = x.permute(0, 2, 3, 1)
        y = F.layer_norm(rows, (rows.shape[-1],), weight, bias, 1e-6)
        return y.to(x.dtype).permute(0, 3, 1, 2)


class InstanceNorm2d(nn.Module):
    """torch ``InstanceNorm2d``'s defaults: no affine, biased variance over
    H, W per sample and channel, eps 1e-5."""

    def __init__(self, channels: int, scale_init: float = 1.0):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


class Identity(nn.Identity):
    """The norm that is none (``SkipInit``, ``none``, ``identity``)."""

    def __init__(self, channels: int = 0, scale_init: float = 1.0):
        super().__init__()


def _refused_padding(mode: str):
    def conv(*args, **kwargs):
        raise ValueError(
            f"convolution type {mode!r}: the JAX reference cannot build this padding mode "
            "either (its _PaddedConv takes the name of the conv it wraps, and flax raises "
            "NameInUseError), so the port refuses it")
    return conv


def _standardized(in_channels, features, kernel_size=3, stride=1, padding=0, groups=1,
                  bias=False, dilation=1, generator=None, **_):
    """``Standardized``: the callers' ``bias`` passes through, and any
    ``kernel_init``/``bias_init`` is dropped (WSConv2d has its own)."""
    return WSConv2d(in_channels, features, kernel_size, stride, padding, groups, bias,
                    dilation, generator)


def get_layer_functions(convolution_type: str, norm: str, nonlin: str):
    """``(conv_ctor, norm_ctor, nonlin_fn)``, as the JAX package's.

    conv_ctor(in_channels, features, kernel_size=, stride=, padding=, groups=,
    bias=, dilation=, generator=, kernel_init=, bias_init=);
    norm_ctor(channels, scale_init=)."""
    ct = convolution_type.lower()
    if ct in ("standard", "default", "zeros"):
        conv_layer = _conv
    elif ct in ("circular", "reflect", "replicate"):
        conv_layer = _refused_padding(ct)
    elif ct == "standardized":
        conv_layer = _standardized
    else:
        raise ValueError(f"Invalid convolution type {convolution_type} provided.")

    from .modules import GhostBatchNorm   # modules.py imports this module

    nl = norm.lower()
    if nl == "batchnorm2d":
        norm_layer = BatchNorm2d
    elif nl in ("sequentialghostnorm", "ghostnorm"):
        norm_layer = GhostBatchNorm
    elif nl == "groupnorm":
        norm_layer = partial(GroupNorm2d, num_groups=32)
    elif nl == "groupnorm1":
        norm_layer = partial(GroupNorm2d, num_groups=1)
    elif nl == "groupnorm8":
        def norm_layer(channels, **kw):
            return GroupNorm2d(channels, num_groups=min(8, channels), **kw)
    elif nl == "groupnorm32":
        def norm_layer(channels, **kw):
            return GroupNorm2d(channels, num_groups=min(32, channels), **kw)
    elif nl == "groupnorm4th":
        def norm_layer(channels, **kw):
            return GroupNorm2d(channels, num_groups=channels // 4, **kw)
    elif nl == "layernorm":
        norm_layer = LayerNorm2d
    elif nl == "instancenorm2d":
        norm_layer = InstanceNorm2d
    elif nl in ("skipinit", "none", "identity"):
        norm_layer = Identity
    else:
        raise ValueError(f"Invalid norm layer {norm} found.")
    return conv_layer, norm_layer, get_nonlin(nonlin)


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


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             count_include_pad: bool = True) -> torch.Tensor:
    """torch ``nn.AvgPool2d``: with ``count_include_pad=False`` each window
    divides by the real (unpadded) elements it covers. ``pool.route`` picks
    the way from the input: window == stride == 1 returns ``x`` itself;
    disjoint windows that tile ``H`` and ``W`` take the pooling kernels
    (``ops.pool.AvgPool``); anything else ``F.avg_pool2d``. All three give
    ``F.avg_pool2d``'s values bitwise, but that the identity keeps a -0
    which ATen's sum, starting from +0, turns into +0."""
    how = pool.route(x.shape, x.dtype, window, stride, padding)
    if how == "identity":
        pool.identity_calls += 1
        return x
    if how == "kernel":
        return pool.AvgPool.apply(x, window)
    pool.plain_calls += 1
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, H*W*C]`` in NHWC order, the order of the JAX
    package's ``x.reshape(N, -1)``, so flax ``Dense`` kernels convert without
    a permutation of rows."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
