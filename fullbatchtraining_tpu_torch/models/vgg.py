"""VGG family (``fullbatchtraining_tpu/models/vgg.py``) in PyTorch.

Conv-norm-nonlinearity stacks by the VGG11/13/16/19 plans with max-pool
``M`` markers (``conv{i}`` with bias, ``norm{i}``), and three heads:
``CIFAR`` (flatten, ``classifier``), ``TinyImageNet`` (global average pool,
``classifier``) and ``ImageNet`` (average pool to 7x7, flatten, ``fc1``/
``fc2`` with ReLU and dropout, ``classifier``). Flattening is in NHWC order,
the JAX package's, so its ``Dense`` kernels convert row for row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (avg_pool, flatten_nhwc, get_layer_functions, global_avg_pool,
                     kaiming_normal_out_, linear, max_pool, normal_, torch_default_bias_,
                     torch_default_conv_, zeros_)
from .modules import Dropout

VGG_PLANS = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """VGG over NHWC images. ``classical_weight_init``: convs kaiming-normal
    fan-out with zero bias, Linear normal(0, 0.01) with zero bias; else
    torch's module defaults, uniform biases included. The ImageNet head
    needs the feature map's side to be at least 7 (``H // 7`` pooling)."""

    def __init__(self, vgg_name: str, channels: int = 3, classes: int = 10,
                 norm: str = "BatchNorm2d", nonlin: str = "ReLU", head: str = "CIFAR",
                 convolution_type: str = "Standard", drop_rate: float = 0.0,
                 classical_weight_init: bool = True, pixels: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv, norm_layer, self.nonlin = get_layer_functions(convolution_type, norm, nonlin)
        classical = classical_weight_init
        conv_init, dense_init = ((kaiming_normal_out_, normal_(0.01)) if classical
                                 else (torch_default_conv_, torch_default_conv_))

        def bias_for(fan_in):
            return zeros_ if classical else torch_default_bias_(fan_in)

        self.plan = VGG_PLANS[vgg_name.upper()]
        current, side, idx = channels, pixels, 0
        for entry in self.plan:
            if entry == "M":
                side //= 2
                continue
            self.add_module(f"conv{idx}", conv(current, entry, kernel_size=3, padding=1,
                                               bias=True, generator=generator,
                                               kernel_init=conv_init,
                                               bias_init=bias_for(current * 9)))
            self.add_module(f"norm{idx}", norm_layer(entry))
            current, idx = entry, idx + 1
        self.head = head
        if head == "CIFAR":
            features = current * side * side
        elif head == "TinyImageNet":
            features = current
        else:
            features = current * (side // (side // 7)) ** 2 if side >= 7 else 0
            self.fc1 = linear(features, 4096, generator, dense_init, bias_for(features))
            self.drop1 = Dropout(drop_rate)
            self.fc2 = linear(4096, 4096, generator, dense_init, bias_for(4096))
            self.drop2 = Dropout(drop_rate)
            features = 4096
        self.classifier = linear(features, classes, generator, dense_init, bias_for(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        idx = 0
        for entry in self.plan:
            if entry == "M":
                x = max_pool(x, window=2, stride=2)
            else:
                x = getattr(self, f"norm{idx}")(getattr(self, f"conv{idx}")(x))
                x = self.nonlin(x)
                idx += 1
        if self.head == "CIFAR":
            return self.classifier(flatten_nhwc(x))
        if self.head == "TinyImageNet":
            return self.classifier(global_avg_pool(x))
        window = x.shape[2] // 7
        x = flatten_nhwc(avg_pool(x, window=window, stride=window))
        x = self.drop1(F.relu(self.fc1(x)))
        x = self.drop2(F.relu(self.fc2(x)))
        return self.classifier(x)
