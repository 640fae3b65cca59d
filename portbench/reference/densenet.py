"""DenseNet-BC in plain PyTorch, written from the published description.

Huang et al. 2017, "Densely Connected Convolutional Networks"
(arXiv:1608.06993): dense blocks in which every layer takes the
concatenation of all feature maps before it and adds ``growth`` channels;
the bottleneck form (BC) of a layer is BatchNorm, ReLU, a 1x1 convolution
to ``bn_size * growth`` channels, BatchNorm, ReLU and a 3x3 convolution to
``growth``; a transition between blocks halves the channels (compression
0.5) with a 1x1 convolution and the side with a 2x2 average pool; global
average pool and one linear layer. Depths 121, 169 and 201 have growth 32,
a 64-channel stem and blocks of (6, 12, 24, 16), (6, 12, 32, 32) and (6,
12, 48, 32) layers; depth 161 growth 48, a 96-channel stem and (6, 12, 36,
24) (the paper's ImageNet table).

Departures from the paper, as the upstream project builds it:

* four blocks at every depth, also on CIFAR, where the paper's CIFAR nets
  have three;
* the ``CIFAR`` stem is one 3x3 convolution at stride 1 with neither
  BatchNorm nor ReLU nor pool after it; ``imagenet`` (or ``standard``) is
  the paper's 7x7 convolution at stride 2, BatchNorm, ReLU and a 3x3 max
  pool at stride 2 (padding 1); ``efficient`` replaces the 7x7 with three
  3x3 convolutions (half the stem's channels at stride 2, half, all), each
  with its BatchNorm and ReLU, before the same max pool;
* a transition is BatchNorm, ReLU, the 1x1 convolution and the pool (the
  paper names no ReLU there), and BatchNorm and ReLU come before the final
  pool;
* no dropout (``model.drop_rate`` 0; the reference refuses another);
* the initial weights are the benchmark's draws (:func:`.layers.init_std`).

``model.memory_efficient`` recomputes a layer's body in the backward and
changes no number, so the reference does not read it. BatchNorm is
:func:`.layers.batch_norm`. Convolutions have no bias.

Nothing here imports the program under test: parameters are a dict of
tensors under the names this module gives them, which are the port's,
activations NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as common
from .layers import init_std  # noqa: F401 (the family's draws)

# depth: (growth, layers a block, stem channels)
DEPTHS = {121: (32, (6, 12, 24, 16), 64), 161: (48, (6, 12, 36, 24), 96),
          169: (32, (6, 12, 32, 32), 64), 201: (32, (6, 12, 48, 32), 64)}
STEMS = ("CIFAR", "imagenet", "standard", "efficient")
BUILT = {"model.convolution": "Standard", "model.nonlin_fn": "ReLU",
         "model.normalization": "BatchNorm2d", "model.drop_rate": 0}


def _stem(kind: str, channels: int, init: int, h: int) -> list:
    if kind == "CIFAR":
        return [("conv", "stem_conv0", channels, init, 3, 1, h)]
    if kind in ("imagenet", "standard"):
        convs = [(channels, init, 7, 2)]
    else:
        convs = [(channels, init // 2, 3, 2), (init // 2, init // 2, 3, 1),
                 (init // 2, init, 3, 1)]
    out = []
    for i, (cin, cout, k, stride) in enumerate(convs):
        out += [("conv", f"stem_conv{i}", cin, cout, k, stride, h),
                ("bn", f"stem_norm{i}", cout, h // stride)]
        h //= stride
    return out + [("pool", "stem_pool", 2)]


def architecture(config: dict):
    """The layers of ``config``'s DenseNet (``model.depth``,
    ``model.bn_size``, ``model.stem``, ``data.channels``, ``data.classes``,
    ``data.pixels``) in order: ``("conv", name, cin, cout, k, stride,
    h_in)``, ``("bn", name, c, h)``, ``("pool", name, stride)`` (the stem's
    3x3 max pool, a transition's 2x2 average pool) and ``("fc", name, cin,
    cout)``, grouped as ``[(kind, name, [...]), ...]`` with ``kind`` one of
    ``stem``, ``dense``, ``transition`` and ``head``."""
    common.require(config, BUILT)
    depth, stem = int(config["model.depth"]), config["model.stem"]
    if depth not in DEPTHS:
        raise ValueError(f"the reference has no DenseNet of depth {depth}; it has {sorted(DEPTHS)}")
    if stem not in STEMS:
        raise ValueError(f"the reference has no DenseNet stem {stem!r}; it has {STEMS}")
    growth, blocks, init = DEPTHS[depth]
    width = int(config["model.bn_size"]) * growth
    h = int(config["data.pixels"])
    seq = _stem(stem, int(config["data.channels"]), init, h)
    plan = [("stem", "stem", seq)]
    h //= 4 if stem != "CIFAR" else 1
    current = init
    for b, count in enumerate(blocks, start=1):
        for i in range(1, count + 1):
            name = f"block{b}_layer{i}"
            plan.append(("dense", name, [("bn", f"{name}.norm1", current, h),
                                         ("conv", f"{name}.conv1", current, width, 1, 1, h),
                                         ("bn", f"{name}.norm2", width, h),
                                         ("conv", f"{name}.conv2", width, growth, 3, 1, h)]))
            current += growth
        if b < len(blocks):
            name = f"transition{b}"
            plan.append(("transition", name, [("bn", f"{name}_norm", current, h),
                                              ("conv", f"{name}_conv", current, current // 2,
                                               1, 1, h),
                                              ("pool", f"{name}_pool", 2)]))
            current //= 2
            h //= 2
    plan.append(("head", "head", [("bn", "final_norm", current, h),
                                  ("fc", "classifier", current, int(config["data.classes"]))]))
    return plan


def layers(plan):
    """Every layer of ``plan`` in order, flat."""
    for _, _, seq in plan:
        yield from seq


def parameter_shapes(plan) -> dict:
    """``{name: (shape, kind)}`` of every parameter (:func:`.layers.parameter_shapes`)."""
    return common.parameter_shapes(layers(plan))


def initial_stats(plan, device) -> dict:
    """Running statistics before the first step: mean 0, variance 1."""
    return common.initial_stats(layers(plan), device)


def _run(kind, seq, x, params, stats, update_stats, f):
    """A group's layers in order; every BatchNorm is followed by a ReLU."""
    for layer in seq:
        if layer[0] == "conv":
            _, name, _, _, k, stride, _ = layer
            x = f.conv(x, params[f"{name}.weight"], stride, k // 2)
        elif layer[0] == "bn":
            name = layer[1]
            x = F.relu(f.act(f.norm(x, f.act(params[f"{name}.weight"]),
                                    f.act(params[f"{name}.bias"]), stats, name, update_stats)))
        elif layer[0] == "pool":
            x = f.act(F.max_pool2d(x, 3, 2, 1) if kind == "stem" else F.avg_pool2d(x, 2, 2))
        elif layer[0] == "fc":
            _, name, _, _ = layer
            x = f.linear(f.act(x.mean(dim=(2, 3))), params[f"{name}.weight"],
                         params[f"{name}.bias"])
    return x


def forward(plan, params: dict, stats: dict, x: torch.Tensor, update_stats: bool = True,
            conv=None, linear=None, act=None, norm=None) -> torch.Tensor:
    """Logits of the NCHW float images ``x``; ``conv``, ``linear``, ``act``
    and ``norm`` as :class:`.layers.Functions` takes them (a lower precision
    passes its own, :mod:`.precision`)."""
    f = common.Functions(conv, linear, act, norm)
    for kind, _, seq in plan:
        out = _run(kind, seq, x, params, stats, update_stats, f)
        x = torch.cat([x, out], dim=1) if kind == "dense" else out
    return x


def tiny(config: dict) -> dict:
    """The CPU's cut: a bottleneck of one growth's width (``model.bn_size``
    1). Depth 121 is the least the family has, and keeps every kind of
    block."""
    return dict(config, **{"model.bn_size": 1})
