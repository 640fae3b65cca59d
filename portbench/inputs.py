"""The inputs of a run, made on the device from ``--seed``: synthetic images
and labels in the data set's shapes, and the initial weights. The same seed
gives the same tensors; the program and the reference are each handed them.
"""

from __future__ import annotations

import torch

from .cells import family

_STREAMS = {"data": 0, "weights": 1}


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * len(_STREAMS) + _STREAMS[stream]) % 2**63)


def images_and_labels(config: dict, seed: int, device):
    """``data.size`` uint8 NHWC images and int64 labels, uniform over the
    classes. Each image is the mean of its class's template and noise, both
    uniform over 0-255, so the labels can be learnt and a step's gradient
    is more than noise."""
    g = generator(seed, "data", device)
    n, side = int(config["data.size"]), int(config["data.pixels"])
    classes = int(config["data.classes"])
    shape = (side, side, int(config["data.channels"]))
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    templates = torch.randint(0, 256, (classes, *shape), generator=g, device=device,
                              dtype=torch.uint8)
    noise = torch.randint(0, 256, (n, *shape), generator=g, device=device, dtype=torch.uint8)
    images = ((templates[labels].to(torch.int16) + noise + 1) // 2).to(torch.uint8)
    return images, labels


def weights(config: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` of every parameter, from one draw of
    normals split into the leaves in the model family's order, each scaled
    by its family's ``init_std``."""
    reference = family(config)
    shapes = reference.parameter_shapes(reference.architecture(config))
    total = sum(torch.Size(shape).numel() for shape, _ in shapes.values())
    draws = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, (shape, kind) in shapes.items():
        size = torch.Size(shape).numel()
        mean, std = reference.init_std(shape, kind)
        out[name] = draws[at:at + size].view(shape) * std + mean
        at += size
    return out
