"""DenseNet-BC family (``fullbatchtraining_tpu/models/densenets.py``) in PyTorch.

Depths 121/161/169/201; ``CIFAR``, ``standard``/``imagenet`` and
``efficient`` stems; bottleneck dense layers (norm, nonlinearity, 1x1 conv
to ``bn_size * growth``, norm, nonlinearity, 3x3 conv to ``growth``,
optional dropout) whose outputs are concatenated on channels; transitions
(norm, nonlinearity, 1x1 conv to half, average pool 2). Convs are
kaiming-normal fan-in; the ``classifier`` has torch's default weight and a
zero bias.

``memory_efficient`` recomputes each dense layer's body in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``nn.remat`` does in the JAX
package. The recompute runs under ``layers.no_stat_updates()``, so the
running stats take one update a forward, and it reads the layer's params
from the checkpoint's inputs, so a forward at other params
(``torch.func.functional_call``, as the regularizer's second gradient runs)
recomputes at those. Dropout runs after the checkpoint, so the recompute
draws nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .layers import (avg_pool, get_layer_functions, global_avg_pool, kaiming_normal_in_, linear,
                     max_pool, no_stat_updates, torch_default_conv_, zeros_)
from .modules import Dropout


def densenet_depths_to_config(depth: int):
    """Depth -> (growth_rate, block_config, num_init_features)."""
    table = {
        121: (32, (6, 12, 24, 16), 64),
        161: (48, (6, 12, 36, 24), 96),
        169: (32, (6, 12, 32, 32), 64),
        201: (32, (6, 12, 48, 32), 64),
    }
    if depth not in table:
        raise ValueError(f"Unsupported DenseNet depth {depth}.")
    return table[depth]


class _DenseLayer(nn.Module):
    """norm1, nonlinearity, conv1 (1x1), norm2, nonlinearity, conv2 (3x3),
    optional dropout. ``remat``: the JAX package wraps a memory-efficient
    layer in ``nn.remat``, whose int32 scalar its activation trace counts
    as one more element."""

    def __init__(self, in_channels: int, growth_rate: int, bn_size: int, drop_rate: float,
                 conv: Callable, norm: Callable, nonlin: Callable, memory_efficient: bool,
                 generator):
        super().__init__()
        self.nonlin, self.memory_efficient = nonlin, memory_efficient
        self.remat = memory_efficient
        width = bn_size * growth_rate
        self.norm1 = norm(in_channels)
        self.conv1 = conv(in_channels, width, kernel_size=1, stride=1, bias=False,
                          generator=generator, kernel_init=kaiming_normal_in_)
        self.norm2 = norm(width)
        self.conv2 = conv(width, growth_rate, kernel_size=3, stride=1, padding=1, bias=False,
                          generator=generator, kernel_init=kaiming_normal_in_)
        if drop_rate > 0:
            self.dropout = Dropout(drop_rate)

    def body(self, x):
        h = self.conv1(self.nonlin(self.norm1(x)))
        return self.conv2(self.nonlin(self.norm2(h)))

    def forward(self, x, body_only: bool = False):
        if body_only:
            return self.body(x)
        if self.memory_efficient and torch.is_grad_enabled():
            names = [name for name, _ in self.named_parameters()]

            def run(inputs, *params):
                return functional_call(self, dict(zip(names, params)), (inputs,),
                                       {"body_only": True})

            out = checkpoint(run, x, *self.parameters(), use_reentrant=False,
                             context_fn=lambda: (contextlib.nullcontext(), no_stat_updates()))
        else:
            out = self.body(x)
        return self.dropout(out) if hasattr(self, "dropout") else out


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, drop_rate: float = 0.0,
                 classes: int = 1000, channels: int = 3, memory_efficient: bool = False,
                 norm: str = "BatchNorm2d", nonlin: str = "ReLU", stem: str = "CIFAR",
                 convolution_type: str = "Standard", generator: torch.Generator | None = None):
        super().__init__()
        conv, norm_layer, self.nonlin = get_layer_functions(convolution_type, norm, nonlin)
        self.stem = stem
        init = num_init_features
        if stem in ("imagenet", "standard"):
            stem_layers = [(init, 7, 2, 3)]
        elif stem == "CIFAR":
            stem_layers = [(init, 3, 1, 1)]
        elif stem == "efficient":
            stem_layers = [(init // 2, 3, 2, 1), (init // 2, 3, 1, 1), (init, 3, 1, 1)]
        else:
            raise ValueError(f"Invalid stem {stem}.")
        self.num_stem = len(stem_layers)
        current = channels
        for i, (feats, k, s, p) in enumerate(stem_layers):
            self.add_module(f"stem_conv{i}", conv(current, feats, kernel_size=k, stride=s,
                                                  padding=p, bias=False, generator=generator,
                                                  kernel_init=kaiming_normal_in_))
            if stem != "CIFAR":
                self.add_module(f"stem_norm{i}", norm_layer(feats))
            current = feats

        self.layout = []   # per block: its dense layers' names, then its transition's or None
        for block_idx, num_layers in enumerate(block_config):
            names = []
            for layer_idx in range(num_layers):
                name = f"block{block_idx + 1}_layer{layer_idx + 1}"
                self.add_module(name, _DenseLayer(current, growth_rate, bn_size, drop_rate,
                                                  conv, norm_layer, self.nonlin,
                                                  memory_efficient, generator))
                names.append(name)
                current += growth_rate
            transition = None
            if block_idx != len(block_config) - 1:
                transition = f"transition{block_idx + 1}"
                self.add_module(f"{transition}_norm", norm_layer(current))
                self.add_module(f"{transition}_conv", conv(
                    current, current // 2, kernel_size=1, stride=1, bias=False,
                    generator=generator, kernel_init=kaiming_normal_in_))
                current //= 2
            self.layout.append((names, transition))
        self.final_norm = norm_layer(current)
        # torch default weight, zero bias
        self.classifier = linear(current, classes, generator, torch_default_conv_, zeros_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_stem):
            x = getattr(self, f"stem_conv{i}")(x)
            if self.stem != "CIFAR":
                x = self.nonlin(getattr(self, f"stem_norm{i}")(x))
        if self.stem != "CIFAR":
            x = max_pool(x, window=3, stride=2, padding=1)
        for names, transition in self.layout:
            for name in names:
                x = torch.cat([x, getattr(self, name)(x)], dim=1)
            if transition is not None:
                x = self.nonlin(getattr(self, f"{transition}_norm")(x))
                x = avg_pool(getattr(self, f"{transition}_conv")(x), window=2, stride=2)
        x = self.nonlin(self.final_norm(x))
        return self.classifier(global_avg_pool(x))
