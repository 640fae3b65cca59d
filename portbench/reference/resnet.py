"""ResNet for CIFAR in plain PyTorch, written from the published description.

He et al. 2016 (arXiv:1512.03385): basic blocks (two 3x3 convolutions) for
ResNet-18 and ResNet-34, stages of 64, 128, 256 and 512 channels times
``width / 64``; bottleneck blocks (1x1, 3x3, 1x1 to four times the stage's
channels) for the deeper ones, stages of 256 to 2048 channels, ``width / 64``
setting the inner width (torchvision's ``width_per_group``). The first
block of stages 2-4 is at stride 2. The CIFAR form
(as the upstream project builds it): the stem is one 3x3 convolution at
stride 1 with no max pool. Bottlenecks stride in their 3x3 convolution
(ResNet v1.5). The projection shortcut is "downsample C" (He et al. 2019,
arXiv:1812.01187, ResNet-D): average pool over ``stride x stride``, a 1x1
convolution, BatchNorm. Global average pool, one linear layer.

BatchNorm in train mode normalises with the biased batch variance, eps
1e-5, and moves the running statistics as ``r = 0.9 r + 0.1 b``, the
running variance taking the unbiased one (the upstream project's
convention). Convolutions have no bias.

Nothing here imports the program under test: parameters are a dict of
tensors under the names this module gives them, activations NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as common
from .layers import init_std  # noqa: F401 (the family's draws)

DEPTHS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}
EXPANSION = {"basic": 1, "bottleneck": 4}
BUILT = {"model.stem": "CIFAR", "model.downsample": "C", "model.convolution": "Standard",
         "model.nonlin_fn": "ReLU", "model.normalization": "BatchNorm2d"}


def architecture(config: dict):
    """The layers of ``config``'s ResNet (``model.depth``, ``model.width``,
    ``data.channels``, ``data.classes``, ``data.pixels``) in order:
    ``("conv", name, cin, cout, k, stride, h_in)``, ``("bn", name, c,
    h)``, ``("pool", name, stride)`` and ``("fc", name, cin, cout)``, grouped
    by block: ``[("stem", [...]), (block name, {"body": [...], "shortcut":
    [...]}), ..., ("head", [...])]``."""
    common.require(config, BUILT)
    depth, width = int(config["model.depth"]), int(config["model.width"])
    if depth not in DEPTHS:
        raise ValueError(f"the reference has no ResNet of depth {depth}; it has {sorted(DEPTHS)}")
    channels, classes = int(config["data.channels"]), int(config["data.classes"])
    pixels = int(config["data.pixels"])
    kind, stages = DEPTHS[depth]
    expansion = EXPANSION[kind]
    # basic blocks: ``width`` is the stem's and the first stage's channels;
    # bottlenecks (torchvision's ``width_per_group``): the stem has 64, a
    # stage of ``planes`` is ``planes * width / 64`` wide inside
    base = width if kind == "basic" else 64
    plan = [("stem", [("conv", "stem_conv1", channels, base, 3, 1, pixels),
                      ("bn", "stem_bn1", base, pixels)])]
    current, h = base, pixels
    planes = base
    for s, blocks in enumerate(stages):
        for b in range(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}_block{b}"
            out = planes * expansion
            h_out = h // stride
            if kind == "basic":
                body = [("conv", f"{name}.conv1", current, planes, 3, stride, h),
                        ("bn", f"{name}.bn1", planes, h_out),
                        ("conv", f"{name}.conv2", planes, planes, 3, 1, h_out),
                        ("bn", f"{name}.bn2", planes, h_out)]
            else:
                inner = planes * width // 64
                body = [("conv", f"{name}.conv1", current, inner, 1, 1, h),
                        ("bn", f"{name}.bn1", inner, h),
                        ("conv", f"{name}.conv2", inner, inner, 3, stride, h),
                        ("bn", f"{name}.bn2", inner, h_out),
                        ("conv", f"{name}.conv3", inner, out, 1, 1, h_out),
                        ("bn", f"{name}.bn3", out, h_out)]
            shortcut = []
            if stride != 1 or current != out:
                shortcut = [("pool", f"{name}.downsample.pool", stride),
                            ("conv", f"{name}.downsample.conv", current, out, 1, 1, h_out),
                            ("bn", f"{name}.downsample.norm", out, h_out)]
            plan.append((name, {"body": body, "shortcut": shortcut}))
            current, h = out, h_out
        planes *= 2
    plan.append(("head", [("fc", "fc", current, classes)]))
    return plan


def layers(plan):
    """Every layer of ``plan`` in order, flat."""
    for name, group in plan:
        if isinstance(group, dict):
            yield from group["body"]
            yield from group["shortcut"]
        else:
            yield from group


def parameter_shapes(plan) -> dict:
    """``{name: (shape, kind)}`` of every parameter (:func:`.layers.parameter_shapes`)."""
    return common.parameter_shapes(layers(plan))


def initial_stats(plan, device) -> dict:
    """Running statistics before the first step: mean 0, variance 1."""
    return common.initial_stats(layers(plan), device)


def _run(seq, x, params, stats, update_stats, f, relu_last):
    for i, layer in enumerate(seq):
        if layer[0] == "conv":
            _, name, _, _, k, stride, _ = layer
            x = f.conv(x, params[f"{name}.weight"], stride, k // 2)
        elif layer[0] == "bn":
            name = layer[1]
            x = f.act(f.norm(x, f.act(params[f"{name}.weight"]),
                             f.act(params[f"{name}.bias"]), stats, name, update_stats))
            # every BN of a body but the last is followed by a ReLU
            if relu_last or i < len(seq) - 1:
                x = F.relu(x)
        elif layer[0] == "pool":
            stride = layer[2]
            if stride != 1:
                x = f.act(F.avg_pool2d(x, stride, stride))
    return x


def forward(plan, params: dict, stats: dict, x: torch.Tensor, update_stats: bool = True,
            conv=None, linear=None, act=None, norm=None) -> torch.Tensor:
    """Logits of the NCHW float images ``x``. ``conv(x, w, stride,
    padding)`` and ``linear(x, w, b)`` default to ``F.conv2d`` and
    ``F.linear``, ``act``, which a lower precision applies to every
    activation a layer puts out and to the BN parameters, to none, and
    ``norm`` to :func:`.layers.batch_norm`; a lower precision passes its
    own (:mod:`.precision`)."""
    f = common.Functions(conv, linear, act, norm)
    for name, group in plan:
        if name == "stem":
            x = _run(group, x, params, stats, update_stats, f, relu_last=True)
        elif name == "head":
            _, fc, _, _ = group[0]
            x = f.linear(f.act(x.mean(dim=(2, 3))), params[f"{fc}.weight"],
                         params[f"{fc}.bias"])
        else:
            body = _run(group["body"], x, params, stats, update_stats, f, relu_last=False)
            short = (_run(group["shortcut"], x, params, stats, update_stats, f,
                          relu_last=False) if group["shortcut"] else x)
            x = F.relu(f.act(body + short))
    return x


def tiny(config: dict) -> dict:
    """The CPU's cut: width 4, and depth 50 for a deeper bottleneck ResNet,
    which has every kind of block that depth 101 and 152 have."""
    return dict(config, **{"model.width": 4, "model.depth": min(int(config["model.depth"]), 50)})
