"""Model factory (``fullbatchtraining_tpu/models/models.py``, ResNet branch).

``construct_model`` builds the module with its weights drawn from a
``torch.Generator`` seeded with ``seed``: kaiming-normal fan-out convs,
torch-default ``fc``, BN scale 1 (0 for zero-init-residual) and bias 0, the
JAX package's distributions (its bits cannot match: threefry vs Philox).
"""

from __future__ import annotations

import torch
from torch import nn

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
