"""Model factory (``fullbatchtraining_tpu/models/models.py``, ResNet branch).

``construct_model`` builds the module with its weights drawn from a
``torch.Generator`` seeded with ``seed``: kaiming-normal fan-out convs,
torch-default ``fc``, BN scale 1 (0 for zero-init-residual) and bias 0, the
JAX package's distributions (its bits cannot match: threefry vs Philox).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .layers import BatchNorm2d
from .resnets import ResNet, resnet_depths_to_config


def construct_model(cfg_model, channels: int, classes: int, seed: int = 0) -> nn.Module:
    """The model of ``cfg_model`` (a ``config/model`` group), on the CPU in
    float32; the trainer moves it to its device and dtype."""
    name = cfg_model.name.lower()
    if "resnet" not in name:
        raise NotImplementedError(
            f"model {cfg_model.name!r} is not ported yet "
            "(ROADMAP.md, 'Other model families and norms')")
    block_type, layers = resnet_depths_to_config(cfg_model.depth)
    generator = torch.Generator().manual_seed(int(seed))
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


def estimate_activation_bytes(model: nn.Module, pixels: int, channels: int,
                              compute_dtype=torch.float32) -> int:
    """Per-sample activation bytes of one train-mode forward, estimated as
    the JAX package estimates them (its ``models.estimate_activation_bytes``):
    the elements of every module's output, the model's own included, over a
    probe batch of 2 at ``pixels x pixels x channels``, divided by 2, at
    ``compute_dtype``'s item size. A BatchNorm's output counts twice: the
    JAX package's BatchNorm2d wraps an inner module whose output its trace
    counts as well, so both packages arrive at the same number. The probe
    runs on the ``meta`` device (forward hooks count the outputs), so
    nothing is allocated or computed and the model's own weights and
    running stats are untouched."""
    elems = 0

    def count(module, args, output):
        nonlocal elems
        times = 2 if isinstance(module, BatchNorm2d) else 1
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
