"""Model factory (``fullbatchtraining_tpu/models/models.py``).

``construct_model`` builds the module of a ``config/model`` group (ResNet,
DenseNet, VGG, NFNet, PyramidNet or the linear debugging model) with its
weights drawn from a ``torch.Generator`` seeded with ``seed``, by the JAX
package's distributions (its bits cannot match: threefry vs Philox).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .densenets import DenseNet, densenet_depths_to_config
from .layers import Linear
from .nfnets import NFNet
from .pyramidnets import PyramidNet
from .resnets import ResNet, resnet_depths_to_config
from .vgg import VGG


class LinearDebugModel(nn.Module):
    """The first 100 features of the flattened NHWC image, then ``fc``
    (flax ``Dense`` defaults: lecun-normal weight, zero bias); debugging only."""

    def __init__(self, classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.fc = Linear(100, classes)
        with torch.no_grad():
            # lecun normal: truncated normal of variance 1/fan_in
            nn.init.trunc_normal_(self.fc.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
            self.fc.weight.mul_(0.1 / 0.87962566103423978)
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.reshape(x.shape[0], -1)[:, :100])


def construct_model(cfg_model, channels: int, classes: int, seed: int = 0,
                    pixels: int = 32) -> nn.Module:
    """The model of ``cfg_model`` (a ``config/model`` group), on the CPU in
    float32 (or the default device of the caller's ``torch.device``
    context); the trainer moves it to its device and dtype. ``pixels``, the
    images' side, sizes VGG's flattening heads."""
    name = cfg_model.name.lower()
    generator = torch.Generator().manual_seed(int(seed))
    if "resnet" in name:
        block_type, layers = resnet_depths_to_config(cfg_model.depth)
        return ResNet(
            block_type=block_type,
            layers=layers,
            channels=channels,
            classes=classes,
            stem=cfg_model.stem,
            convolution_type=cfg_model.convolution,
            nonlin=cfg_model.nonlin_fn,
            norm=cfg_model.normalization,
            downsample=cfg_model.downsample,
            width_per_group=cfg_model.width,
            zero_init_residual="skip_residual" in str(cfg_model.initialization)
            or "skip-residual" in str(cfg_model.initialization),
            generator=generator,
        )
    if "densenet" in name:
        growth_rate, block_config, num_init_features = densenet_depths_to_config(cfg_model.depth)
        return DenseNet(
            growth_rate=growth_rate,
            block_config=block_config,
            num_init_features=num_init_features,
            bn_size=cfg_model.bn_size,
            drop_rate=cfg_model.drop_rate,
            channels=channels,
            classes=classes,
            memory_efficient=cfg_model.memory_efficient,
            norm=cfg_model.normalization,
            nonlin=cfg_model.nonlin_fn,
            stem=cfg_model.stem,
            convolution_type=cfg_model.convolution,
            generator=generator,
        )
    if "vgg" in name:
        return VGG(
            vgg_name=cfg_model.name,
            channels=channels,
            classes=classes,
            norm=cfg_model.get("normalization", "BatchNorm2d"),
            nonlin=cfg_model.get("nonlin_fn", "ReLU"),
            head=cfg_model.get("head", "CIFAR"),
            convolution_type=cfg_model.get("convolution", "Standard"),
            drop_rate=cfg_model.get("drop_rate", 0.0),
            classical_weight_init=cfg_model.get("classical_weight_init", True),
            pixels=pixels,
            generator=generator,
        )
    if "linear" in name:
        return LinearDebugModel(classes=classes, generator=generator)
    if "nfnet" in name:
        return NFNet(
            channels=channels,
            classes=classes,
            variant=cfg_model.variant,
            stochdepth_rate=cfg_model.stochdepth_rate,
            alpha=cfg_model.alpha,
            se_ratio=cfg_model.se_ratio,
            activation=cfg_model.nonlin,
            stem=cfg_model.stem,
            use_dropout=cfg_model.use_dropout,
            generator=generator,
        )
    if "pyramidnet" in name:
        return PyramidNet(
            depth=cfg_model.depth,
            alpha=cfg_model.alpha,
            channels=channels,
            classes=classes,
            bottleneck=cfg_model.bottleneck,
            generator=generator,
        )
    raise ValueError(f"Unknown model {cfg_model.name}.")


def estimate_activation_bytes(model: nn.Module, pixels: int, channels: int,
                              compute_dtype=torch.float32) -> int:
    """Per-sample activation bytes of one train-mode forward, estimated as
    the JAX package estimates them (its ``models.estimate_activation_bytes``):
    the elements of every module's output, the model's own included, over a
    probe batch of 2 at ``pixels x pixels x channels``, divided by 2, at
    ``compute_dtype``'s item size. The output of a norm with a
    ``jax_inner`` module (``BatchNorm2d``, ``GroupNorm2d``,
    ``LayerNorm2d``) counts twice: its JAX counterpart wraps that inner
    module, whose output the JAX trace counts as well, so both packages
    arrive at the same number. A module the JAX package wraps in ``nn.remat``
    (a memory-efficient dense layer, ``remat``) adds the one element of the
    wrapper's int32 scalar, which the JAX trace counts too. The probe
    runs on the ``meta`` device (forward hooks count the outputs), so
    nothing is allocated or computed and the model's own weights and
    running stats are untouched."""
    elems = 0

    def count(module, args, output):
        nonlocal elems
        times = 2 if getattr(module, "jax_inner", None) else 1
        elems += bool(getattr(module, "remat", False))
        for out in output if isinstance(output, (tuple, list)) else (output,):
            if isinstance(out, torch.Tensor):
                elems += times * out.numel()

    probe = 2
    state = {name: torch.empty_like(t, device="meta")
             for name, t in [*model.named_parameters(), *model.named_buffers()]}
    hooks = [m.register_forward_hook(count) for m in model.modules()]
    training = model.training
    try:
        model.train()
        with torch.no_grad():
            functional_call(model, state,
                            (torch.empty((probe, pixels, pixels, channels), device="meta"),))
    finally:
        model.train(training)
        for hook in hooks:
            hook.remove()
    return elems * torch.empty((), dtype=compute_dtype).element_size() // probe
