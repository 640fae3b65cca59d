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

import math

import torch
import torch.nn.functional as F

DEPTHS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}
EXPANSION = {"basic": 1, "bottleneck": 4}
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def architecture(depth: int, width: int, channels: int, classes: int, pixels: int):
    """The layers in order: ``("conv", name, cin, cout, k, stride, h_in)``,
    ``("bn", name, c, h)``, ``("pool", name, stride)`` and ``("fc", name,
    cin, cout)``, grouped by block: ``[("stem", [...]), (block name,
    {"body": [...], "shortcut": [...]}), ..., ("head", [...])]``."""
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
    """``{name: (shape, kind)}`` of every parameter, ``kind`` one of
    ``conv`` (fan-out ``cout * k * k``), ``bn_weight``, ``bn_bias``,
    ``fc_weight``, ``fc_bias``."""
    shapes = {}
    for layer in layers(plan):
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


def initial_stats(plan, device) -> dict:
    """Running statistics before the first step: mean 0, variance 1."""
    stats = {}
    for layer in layers(plan):
        if layer[0] == "bn":
            c = layer[2]
            stats[f"{layer[1]}.running_mean"] = torch.zeros(c, device=device)
            stats[f"{layer[1]}.running_var"] = torch.ones(c, device=device)
    return stats


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


class _Functions:
    def __init__(self, conv, linear, act, norm):
        self.conv = conv or (lambda x, w, stride, padding: F.conv2d(x, w, None, stride, padding))
        self.linear = linear or F.linear
        self.act = act or (lambda t: t)
        self.norm = norm or batch_norm


def forward(plan, params: dict, stats: dict, x: torch.Tensor, update_stats: bool = True,
            conv=None, linear=None, act=None, norm=None) -> torch.Tensor:
    """Logits of the NCHW float images ``x``. ``conv(x, w, stride,
    padding)`` and ``linear(x, w, b)`` default to ``F.conv2d`` and
    ``F.linear``, ``act``, which a lower precision applies to every
    activation a layer puts out and to the BN parameters, to none, and
    ``norm`` to :func:`batch_norm`; a lower precision passes its own
    (:mod:`.precision`)."""
    f = _Functions(conv, linear, act, norm)
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
