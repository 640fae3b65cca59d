"""Batched augmentations on the device (``fullbatchtraining_tpu/data/augmentations.py``).

Images stay uint8 NHWC on the device; ``normalize`` turns them into the
compute dtype after augmentation. The random crop + horizontal flip is an
indexed gather on uint8 (the JAX package's one-hot matmul form is a trick
for the TPU's matrix unit). Its draws and its application are separate
functions, so a test can feed it the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def normalize(images: torch.Tensor, mean, std, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> ``(x/255 - mean)/std``, every step in ``dtype``."""
    x = images.to(dtype) / 255.0
    mean = torch.as_tensor(mean, dtype=dtype, device=images.device)
    std = torch.as_tensor(std, dtype=dtype, device=images.device)
    return (x - mean) / std


def draw_crop_flip(b: int, generator: torch.Generator, *, height: int, width: int,
                   size: int, padding: int, flip_p: float):
    """Per-image offsets ``oy``, ``ox`` in ``[0, H + 2p - size]`` and flip
    flags (True with probability ``flip_p``), on ``generator``'s device."""
    device = generator.device
    oy = torch.randint(0, height + 2 * padding - size + 1, (b,), generator=generator,
                       device=device)
    ox = torch.randint(0, width + 2 * padding - size + 1, (b,), generator=generator,
                       device=device)
    flip = torch.rand((b,), generator=generator, device=device) < flip_p
    return oy, ox, flip


def crop_flip(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, flip: torch.Tensor,
              size: int, padding: int) -> torch.Tensor:
    """Zero-pad by ``padding``, cut the ``size x size`` window at ``(oy, ox)``
    of each image, and reverse its columns where ``flip`` is set."""
    padded = F.pad(images, (0, 0, padding, padding, padding, padding))
    span = torch.arange(size, device=images.device)
    rows = oy[:, None] + span[None, :]
    cols = torch.where(flip[:, None], ox[:, None] + (size - 1 - span)[None, :],
                       ox[:, None] + span[None, :])
    batch = torch.arange(images.shape[0], device=images.device)
    return padded[batch[:, None, None], rows[:, :, None], cols[:, None, :]]


def crop_spec(arg) -> tuple[int, int]:
    """(size, padding) from a RandomCrop config entry ([size, pad] or size)."""
    if isinstance(arg, (list, tuple)):
        size, pad = arg
    else:
        size, pad = arg, 0
    return int(size), int(pad)


POLICY_KEYS = ("RandAugment", "AutoAugment", "AugMix")


def augmented_hw(aug_cfg, h: int, w: int) -> tuple[int, int]:
    """Output spatial dims after the configured augmentations (policy ops
    preserve size; size ops apply in config order)."""
    for name, arg in dict(aug_cfg or {}).items():
        if name == "RandomCrop":
            h = w = crop_spec(arg)[0]
        elif name in ("RandomResizedCrop", "CenterCrop", "Resize"):
            h = w = int(arg)
    return h, w


def _crop_flip_op(size, pad: int, flip_p: float) -> Callable:
    """Random crop (``size`` None: none) and horizontal flip, from one
    generator's draws."""

    def augment(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, h, w, _ = images.shape
        crop = size if size is not None else h
        oy, ox, flip = draw_crop_flip(b, generator, height=h, width=w, size=crop,
                                      padding=pad, flip_p=flip_p)
        if size is None:  # flip only: no crop, no padding
            oy, ox = torch.zeros_like(oy), torch.zeros_like(ox)
        return crop_flip(images, oy, ox, flip, crop, pad)

    return augment


def make_augment_fn(aug_cfg) -> Callable:
    """``fn(images_u8, generator) -> images_u8`` for ``data.augmentations_train``.

    Ops apply in config order. RandomCrop and RandomHorizontalFlip alone, the
    CIFAR recipe, take one crop+flip gather. The policy augmentations run
    only in a baked store (``data/baked.py``), as in the JAX package."""
    aug_cfg = dict(aug_cfg or {})
    ops = []
    for name, arg in aug_cfg.items():
        if name == "RandomCrop":
            ops.append(_crop_flip_op(*crop_spec(arg), 0.0))
        elif name == "RandomHorizontalFlip":
            ops.append(_crop_flip_op(None, 0, float(arg)))
        elif name == "CenterCrop":
            ops.append(lambda x, g, s=int(arg): center_crop(x, s))
        elif name in ("RandomResizedCrop", "Resize"):
            raise NotImplementedError(
                f"augmentation {name!r} is not ported yet "
                "(ROADMAP.md, 'Streamed epochs and other datasets')")
        else:
            raise ValueError(f"Unsupported augmentation {name} (policy augmentations "
                             "run only in a baked store: data.db.augmentations_train).")
    if set(aug_cfg) == {"RandomCrop", "RandomHorizontalFlip"}:
        return _crop_flip_op(*crop_spec(aug_cfg["RandomCrop"]),
                             float(aug_cfg["RandomHorizontalFlip"]))

    def augment(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        for op in ops:
            images = op(images, generator)
        return images

    return augment


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    h, w = images.shape[1:3]
    top, left = (h - size) // 2, (w - size) // 2
    return images[:, top:top + size, left:left + size, :]


def make_eval_transform(aug_cfg) -> Callable:
    """Deterministic validation transform (CenterCrop)."""
    ops = []
    for name, arg in dict(aug_cfg or {}).items():
        if name != "CenterCrop":
            raise NotImplementedError(
                f"eval augmentation {name!r} is not ported yet "
                "(ROADMAP.md, 'Streamed epochs and other datasets')")
        ops.append(lambda x, s=int(arg): center_crop(x, s))

    def transform(images):
        for op in ops:
            images = op(images)
        return images

    return transform
