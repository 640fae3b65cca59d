"""NFNet, the normalizer-free family (``fullbatchtraining_tpu/models/nfnets.py``),
in PyTorch.

Variants F0-F7; variance-preserving GELU (tanh form) or ReLU; the
signal-propagation ``beta`` pre-scaling and ``alpha`` residual scale with a
0-d ``skip_gain`` from 0; scaled weight-standardized convolutions
(``layers.WSConv2d``); squeeze-excite whose gate the block doubles;
stochastic depth without rescaling. No running stats at all.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import WSConv2d, avg_pool, global_avg_pool, linear, normal_
from .modules import Dropout, stochastic_depth

nfnet_params = {
    "F0": {"width": [256, 512, 1536, 1536], "depth": [1, 2, 6, 3], "train_imsize": 192,
           "test_imsize": 256, "drop_rate": 0.2},
    "F1": {"width": [256, 512, 1536, 1536], "depth": [2, 4, 12, 6], "train_imsize": 224,
           "test_imsize": 320, "drop_rate": 0.3},
    "F2": {"width": [256, 512, 1536, 1536], "depth": [3, 6, 18, 9], "train_imsize": 256,
           "test_imsize": 352, "drop_rate": 0.4},
    "F3": {"width": [256, 512, 1536, 1536], "depth": [4, 8, 24, 12], "train_imsize": 320,
           "test_imsize": 416, "drop_rate": 0.4},
    "F4": {"width": [256, 512, 1536, 1536], "depth": [5, 10, 30, 15], "train_imsize": 384,
           "test_imsize": 512, "drop_rate": 0.5},
    "F5": {"width": [256, 512, 1536, 1536], "depth": [6, 12, 36, 18], "train_imsize": 416,
           "test_imsize": 544, "drop_rate": 0.5},
    "F6": {"width": [256, 512, 1536, 1536], "depth": [7, 14, 42, 21], "train_imsize": 448,
           "test_imsize": 576, "drop_rate": 0.5},
    "F7": {"width": [256, 512, 1536, 1536], "depth": [8, 16, 48, 24], "train_imsize": 480,
           "test_imsize": 608, "drop_rate": 0.5},
}

# variance-preserving activation gains
VP_GAINS = {"gelu": 1.7015043497085571, "relu": 1.7139588594436646}


def vp_activation(name: str):
    gain = VP_GAINS[name]
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh") * gain
    return lambda x: F.relu(x) * gain


class SqueezeExcite(nn.Module):
    """Mean over H, W, ``linear``, activation, ``linear_1``, sigmoid: the gate
    ``[N, C, 1, 1]``, which the caller doubles. torch-default Linears."""

    def __init__(self, channels: int, se_ratio: float = 0.5, activation: str = "gelu",
                 generator=None):
        super().__init__()
        self.act = vp_activation(activation)
        hidden = max(1, int(channels * se_ratio))
        self.linear = linear(channels, hidden, generator)
        self.linear_1 = linear(hidden, channels, generator)

    def forward(self, x):
        out = self.linear_1(self.act(self.linear(x.mean(dim=(2, 3)))))
        return torch.sigmoid(out)[:, :, None, None]


class NFBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int, alpha: float,
                 beta: float, se_ratio: float, group_size: int, stochdepth_rate: float,
                 activation: str, pad: int, expansion: float = 0.5, generator=None):
        super().__init__()
        self.act = vp_activation(activation)
        self.stride, self.alpha, self.beta, self.pad = stride, alpha, beta, pad
        self.stochdepth_rate = stochdepth_rate
        width = int(out_channels * expansion)
        groups = width // group_size
        width = group_size * groups
        self.use_projection = stride > 1 or in_channels != out_channels
        if self.use_projection:
            self.conv_shortcut = WSConv2d(in_channels, out_channels, 1, generator=generator)
        self.conv0 = WSConv2d(in_channels, width, 1, generator=generator)
        self.conv1 = WSConv2d(width, width, 3, stride, 1, groups, generator=generator)
        self.conv1b = WSConv2d(width, width, 3, 1, 1, groups, generator=generator)
        self.conv2 = WSConv2d(width, out_channels, 1, generator=generator)
        self.squeeze_excite = SqueezeExcite(out_channels, se_ratio, activation, generator)
        self.skip_gain = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        out = self.act(x) * self.beta
        if self.stride > 1:
            shortcut = self.conv_shortcut(avg_pool(out, window=2, stride=2, padding=self.pad))
        elif self.use_projection:
            shortcut = self.conv_shortcut(out)
        else:
            shortcut = x
        out = self.act(self.conv0(out))
        out = self.act(self.conv1(out))
        out = self.act(self.conv1b(out))
        out = self.conv2(out)
        out = (self.squeeze_excite(out) * 2) * out
        out = stochastic_depth(out, self.stochdepth_rate, self.training)
        return out * self.alpha * self.skip_gain + shortcut


class NFNet(nn.Module):
    def __init__(self, channels: int, classes: int, variant: str = "F0",
                 stochdepth_rate: float = 0.0, alpha: float = 0.2, se_ratio: float = 0.5,
                 activation: str = "gelu", stem: str = "ImageNet", use_dropout: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in nfnet_params:
            raise RuntimeError(f"Variant {variant} does not exist.")
        params = nfnet_params[variant]
        self.act = vp_activation(activation)
        stride_stem = {"ImageNet": 2, "CIFAR": 1}[stem]
        current = channels
        for i, (feats, s) in enumerate([(16, stride_stem), (32, 1), (64, 1),
                                        (128, stride_stem)]):
            self.add_module(f"stem_conv{i}", WSConv2d(current, feats, 3, s, generator=generator))
            current = feats

        num_blocks = sum(params["depth"])
        index, expected_std = 0, 1.0
        sd_rate = stochdepth_rate or 0.0
        for block_width, stage_depth, stride in zip(params["width"], params["depth"],
                                                    [1, 2, 2, 2]):
            for block_index in range(stage_depth):
                self.add_module(f"block{index}", NFBlock(
                    current, block_width, stride if block_index == 0 else 1, alpha,
                    1.0 / expected_std, se_ratio, 128, sd_rate * index / num_blocks,
                    activation, 1 if stem == "ImageNet" else 0, generator=generator))
                current = block_width
                index += 1
                if block_index == 0:
                    expected_std = 1.0
                expected_std = (expected_std ** 2 + alpha ** 2) ** 0.5
        self.num_blocks = num_blocks
        final = 2 * params["width"][-1]
        self.final_conv = WSConv2d(current, final, 1, generator=generator)
        if use_dropout and params["drop_rate"] > 0:
            self.dropout = Dropout(params["drop_rate"])
        # normal(0.01) weight, torch-default uniform bias
        self.linear = linear(final, classes, generator, normal_(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"stem_conv{i}")(x)
            if i < 3:
                x = self.act(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = global_avg_pool(self.act(self.final_conv(x)))
        if self.training and hasattr(self, "dropout"):
            x = self.dropout(x)
        return self.linear(x)
