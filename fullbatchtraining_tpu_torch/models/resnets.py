"""ResNet family (``fullbatchtraining_tpu/models/resnets.py``) in PyTorch.

Submodule names follow the JAX package (``stem_conv1``, ``stem_bn1``,
``layer{s}_block{b}`` with ``conv1``/``bn1``/``conv2``/``bn2``/
``downsample.conv``/``downsample.norm``, ``fc``), so moving weights between
the two is a name join plus layout transposes (``convert.py``).
``initialization: skip-residual`` zero-initialises the last BN of every
block, as the JAX package does. ``normalization: SkipInit`` builds the
pre-activation blocks that end in a ``Skipper`` (``skip``), with biases on
every conv and ``preact-`` shortcuts; ``none`` builds the plain blocks over
``Identity`` norms with no conv bias, as the JAX package does. The public
``forward`` takes NHWC images; inside, activations are NCHW tensors in
``torch.channels_last``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from .layers import avg_pool, get_layer_functions, global_avg_pool, linear, max_pool
from .modules import Skipper


def resnet_depths_to_config(depth: int):
    """Depth -> (block_type, stage sizes)."""
    table = {
        20: ("basic", [3, 3, 3]),
        32: ("basic", [5, 5, 5]),
        56: ("basic", [9, 9, 9]),
        110: ("basic", [18, 18, 18]),
        18: ("basic", [2, 2, 2, 2]),
        34: ("basic", [3, 4, 6, 3]),
        50: ("bottleneck", [3, 4, 6, 3]),
        101: ("bottleneck", [3, 4, 23, 3]),
        152: ("bottleneck", [3, 8, 36, 3]),
    }
    if depth not in table:
        raise ValueError(f"Unsupported ResNet depth {depth}.")
    return table[depth]


_EXPANSION = {"basic": 1, "bottleneck": 4}


class _Downsample(nn.Module):
    """Shortcut projection, variants A (1x1 conv), B (1x1 conv + norm), C
    (avg_pool, 1x1 conv, norm), preact-B (nonlin, 1x1 conv) and preact-C
    (nonlin, avg_pool, 1x1 conv)."""

    def __init__(self, variant: str, in_planes: int, features: int, stride: int,
                 conv: Callable, norm: Callable, nonlin: Callable, use_bias: bool, generator):
        super().__init__()
        if variant not in ("A", "B", "C", "preact-B", "preact-C"):
            raise ValueError("Invalid downsample block specification.")
        self.variant, self.stride, self.nonlin = variant, stride, nonlin
        pooled = variant.endswith("C")
        self.conv = conv(in_planes, features, kernel_size=1, stride=1 if pooled else stride,
                         bias=use_bias, generator=generator)
        if variant in ("B", "C"):
            self.norm = norm(features)

    def forward(self, x):
        if self.variant.startswith("preact"):
            x = self.nonlin(x)
        if self.variant.endswith("C"):
            x = avg_pool(x, window=self.stride, stride=self.stride)
        x = self.conv(x)
        return self.norm(x) if self.variant in ("B", "C") else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int, conv: Callable,
                 norm: Callable, nonlin: Callable, use_bias: bool, downsample: str | None = None,
                 zero_init_residual: bool = False, groups: int = 1, base_width: int = 64,
                 generator=None):
        super().__init__()
        self.nonlin = nonlin
        self.conv1 = conv(in_planes, planes, kernel_size=3, stride=stride, padding=1,
                          bias=use_bias, generator=generator)
        self.bn1 = norm(planes)
        self.conv2 = conv(planes, planes, kernel_size=3, stride=1, padding=1,
                          bias=use_bias, generator=generator)
        self.bn2 = norm(planes, scale_init=0.0 if zero_init_residual else 1.0)
        self.downsample = None
        if downsample is not None:
            self.downsample = _Downsample(downsample, in_planes, planes, stride, conv,
                                          norm, nonlin, use_bias, generator)

    def forward(self, x):
        out = self.nonlin(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.nonlin(out + identity)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int, conv: Callable,
                 norm: Callable, nonlin: Callable, use_bias: bool, downsample: str | None = None,
                 zero_init_residual: bool = False, groups: int = 1, base_width: int = 64,
                 generator=None):
        super().__init__()
        self.nonlin = nonlin
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.conv1 = conv(in_planes, width, kernel_size=1, stride=1, bias=use_bias,
                          generator=generator)
        self.bn1 = norm(width)
        self.conv2 = conv(width, width, kernel_size=3, stride=stride, padding=1,
                          groups=groups, bias=use_bias, generator=generator)
        self.bn2 = norm(width)
        self.conv3 = conv(width, out_planes, kernel_size=1, stride=1, bias=use_bias,
                          generator=generator)
        self.bn3 = norm(out_planes, scale_init=0.0 if zero_init_residual else 1.0)
        self.downsample = None
        if downsample is not None:
            self.downsample = _Downsample(downsample, in_planes, out_planes, stride, conv,
                                          norm, nonlin, use_bias, generator)

    def forward(self, x):
        out = self.nonlin(self.bn1(self.conv1(x)))
        out = self.nonlin(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.nonlin(out + identity)


class BasicBlockSkipInit(nn.Module):
    """Pre-activation basic block ending in SkipInit's gain (``skip``)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int, conv: Callable,
                 norm: Callable, nonlin: Callable, use_bias: bool, downsample: str | None = None,
                 zero_init_residual: bool = False, groups: int = 1, base_width: int = 64,
                 generator=None):
        super().__init__()
        self.nonlin = nonlin
        self.conv1 = conv(in_planes, planes, kernel_size=3, stride=stride, padding=1,
                          bias=use_bias, generator=generator)
        self.conv2 = conv(planes, planes, kernel_size=3, stride=1, padding=1,
                          bias=use_bias, generator=generator)
        self.skip = Skipper()
        self.downsample = None
        if downsample is not None:
            self.downsample = _Downsample(downsample, in_planes, planes, stride, conv,
                                          norm, nonlin, use_bias, generator)

    def forward(self, x):
        out = self.conv1(self.nonlin(x))
        out = self.skip(self.conv2(self.nonlin(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class BottleneckSkipInit(nn.Module):
    """Pre-activation bottleneck (stride on the 3x3) ending in ``skip``."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int, conv: Callable,
                 norm: Callable, nonlin: Callable, use_bias: bool, downsample: str | None = None,
                 zero_init_residual: bool = False, groups: int = 1, base_width: int = 64,
                 generator=None):
        super().__init__()
        self.nonlin = nonlin
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.conv1 = conv(in_planes, width, kernel_size=1, stride=1, bias=use_bias,
                          generator=generator)
        self.conv2 = conv(width, width, kernel_size=3, stride=stride, padding=1,
                          groups=groups, bias=use_bias, generator=generator)
        self.conv3 = conv(width, out_planes, kernel_size=1, stride=1, bias=use_bias,
                          generator=generator)
        self.skip = Skipper()
        self.downsample = None
        if downsample is not None:
            self.downsample = _Downsample(downsample, in_planes, out_planes, stride, conv,
                                          norm, nonlin, use_bias, generator)

    def forward(self, x):
        out = self.conv1(self.nonlin(x))
        out = self.conv2(self.nonlin(out))
        out = self.skip(self.conv3(self.nonlin(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


_BLOCKS = {
    ("basic", False): BasicBlock,
    ("basic", True): BasicBlockSkipInit,
    ("bottleneck", False): Bottleneck,
    ("bottleneck", True): BottleneckSkipInit,
}


class ResNet(nn.Module):
    """ResNet with CIFAR, standard or efficient stem; NHWC in, logits out."""

    def __init__(self, block_type: str, layers: Sequence[int], channels: int, classes: int,
                 zero_init_residual: bool = False, strides: Sequence[int] = (1, 2, 2, 2),
                 groups: int = 1, width_per_group: int = 64, norm: str = "BatchNorm2d",
                 nonlin: str = "ReLU", stem: str = "CIFAR", downsample: str = "B",
                 convolution_type: str = "Standard", generator: torch.Generator | None = None):
        super().__init__()
        conv, norm_layer, self.nonlin = get_layer_functions(convolution_type, norm, nonlin)
        skipinit = norm.lower() == "skipinit"
        use_bias = skipinit
        if skipinit:
            downsample = f"preact-{downsample}"
        block_cls = _BLOCKS[(block_type, skipinit)]
        expansion = _EXPANSION[block_type]
        inplanes = width_per_group if block_type == "basic" else 64
        base_width = width_per_group if block_type == "bottleneck" else 64

        self.stem = stem
        if stem == "CIFAR":
            stem_layers = [(inplanes, 3, 1, 1)]
        elif stem == "standard":
            stem_layers = [(inplanes, 7, 2, 3)]
        elif stem == "efficient":
            half = inplanes // 2
            stem_layers = [(half, 3, 2, 1), (half, 3, 1, 1), (inplanes, 3, 1, 1)]
        else:
            raise ValueError(f"Invalid stem designation {stem}.")
        self.num_stem = len(stem_layers)
        current = channels
        for i, (feats, k, s, p) in enumerate(stem_layers):
            self.add_module(f"stem_conv{i + 1}", conv(current, feats, kernel_size=k, stride=s,
                                                      padding=p, bias=use_bias,
                                                      generator=generator))
            self.add_module(f"stem_bn{i + 1}", norm_layer(feats))
            current = feats

        self.block_names = []
        width = inplanes
        for stage_idx, num_blocks in enumerate(layers):
            stride = strides[stage_idx]
            for block_idx in range(num_blocks):
                s = stride if block_idx == 0 else 1
                needs_ds = s != 1 or current != width * expansion
                name = f"layer{stage_idx + 1}_block{block_idx}"
                self.add_module(name, block_cls(
                    current, width, s, conv, norm_layer, self.nonlin, use_bias,
                    downsample=downsample if (block_idx == 0 and needs_ds) else None,
                    zero_init_residual=zero_init_residual, groups=groups,
                    base_width=base_width, generator=generator))
                self.block_names.append(name)
                current = width * expansion
            width *= 2
        # fc keeps torch Linear's default init (uniform +-1/sqrt(fan_in))
        self.fc = linear(current, classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> logits. ``permute`` of a contiguous NHWC tensor is
        already a channels_last NCHW view: no copy."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_stem):
            x = getattr(self, f"stem_conv{i + 1}")(x)
            x = self.nonlin(getattr(self, f"stem_bn{i + 1}")(x))
        if self.stem != "CIFAR":
            x = max_pool(x, window=3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(global_avg_pool(x))
