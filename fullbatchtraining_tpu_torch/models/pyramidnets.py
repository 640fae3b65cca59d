"""PyramidNet for CIFAR (``fullbatchtraining_tpu/models/pyramidnets.py``) in PyTorch.

Widths grow by ``alpha / (3n)`` a block (``planes = int(round(16 + k *
alpha / (3n)))``); pre-activation blocks end in a BN, the shortcut is
average-pooled where the block downsamples and zero-padded in channels to
the block's width. The norms are bare ``_TorchBatchNorm``s in the JAX
package, leaves directly under ``bn1`` etc.: ``BatchNorm2d(jax_inner=None)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, _conv, avg_pool, global_avg_pool, linear


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, jax_inner=None)


def _shortcut_add(out: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
    """``out + shortcut`` zero-padded along channels, padded in the NHWC view
    so the sum stays channels_last."""
    extra = out.shape[1] - shortcut.shape[1]
    if extra > 0:
        shortcut = F.pad(shortcut.permute(0, 2, 3, 1), (0, extra)).permute(0, 3, 1, 2)
    return out + shortcut


class PyramidBasicBlock(nn.Module):
    outchannel_ratio = 1

    def __init__(self, in_channels: int, planes: int, stride: int, downsample: bool, generator):
        super().__init__()
        self.downsample = downsample
        self.bn1 = _bn(in_channels)
        self.conv1 = _conv(in_channels, planes, 3, stride, 1, generator=generator)
        self.bn2 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1, generator=generator)
        self.bn3 = _bn(planes)

    def forward(self, x):
        out = self.conv1(self.bn1(x))
        out = self.bn3(self.conv2(F.relu(self.bn2(out))))
        shortcut = avg_pool(x, window=2, stride=2) if self.downsample else x
        return _shortcut_add(out, shortcut)


class PyramidBottleneck(nn.Module):
    outchannel_ratio = 4

    def __init__(self, in_channels: int, planes: int, stride: int, downsample: bool, generator):
        super().__init__()
        self.downsample = downsample
        self.bn1 = _bn(in_channels)
        self.conv1 = _conv(in_channels, planes, 1, 1, 0, generator=generator)
        self.bn2 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, generator=generator)
        self.bn3 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1, 1, 0, generator=generator)
        self.bn4 = _bn(planes * 4)

    def forward(self, x):
        out = self.conv1(self.bn1(x))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.bn4(self.conv3(F.relu(self.bn3(out))))
        shortcut = avg_pool(x, window=2, stride=2) if self.downsample else x
        return _shortcut_add(out, shortcut)


def pyramid_widths(depth: int, alpha: float, bottleneck: bool) -> list[list[int]]:
    """``planes`` of each block, stage by stage."""
    n = (depth - 2) // (9 if bottleneck else 6)
    addrate = alpha / (3 * n * 1.0)
    featuremap_dim, stages = 16.0, []
    for _ in range(3):
        stage = []
        for _ in range(n):
            featuremap_dim += addrate
            stage.append(int(round(featuremap_dim)))
        stages.append(stage)
    return stages


class PyramidNet(nn.Module):
    def __init__(self, depth: int, alpha: float, channels: int, classes: int,
                 bottleneck: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        block_cls = PyramidBottleneck if bottleneck else PyramidBasicBlock
        self.conv1 = _conv(channels, 16, 3, 1, 1, generator=generator)
        self.bn1 = _bn(16)
        self.block_names = []
        current = 16
        for stage, widths in enumerate(pyramid_widths(depth, alpha, bottleneck)):
            stride = 1 if stage == 0 else 2
            for block_idx, planes in enumerate(widths):
                name = f"layer{stage + 1}_block{block_idx}"
                self.add_module(name, block_cls(current, planes,
                                                stride if block_idx == 0 else 1,
                                                stride != 1 and block_idx == 0, generator))
                self.block_names.append(name)
                current = planes * block_cls.outchannel_ratio
        self.bn_final = _bn(current)
        # torch Linear defaults, weight and bias
        self.fc = linear(current, classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(x.permute(0, 3, 1, 2)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(global_avg_pool(F.relu(self.bn_final(x))))
