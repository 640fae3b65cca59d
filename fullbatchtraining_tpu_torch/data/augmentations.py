"""Batched augmentations on the device (``fullbatchtraining_tpu/data/augmentations.py``).

Images stay uint8 NHWC on the device; ``normalize`` turns them into the
compute dtype after augmentation. The random crop + horizontal flip is an
indexed gather on uint8 (the JAX package's one-hot matmul form is a trick
for the TPU's matrix unit). ``Resize`` and ``RandomResizedCrop`` resample
with :func:`scale_and_translate`, the function of ``jax.image``'s linear
``scale_and_translate`` (a triangle kernel, widened when downscaling), and
return float32, as the JAX package's do. Every random augmentation's draws
and its application are separate functions, so a test can feed it the JAX
package's draws.
"""

from __future__ import annotations

import math
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


def scale_and_translate(images: torch.Tensor, size: int, scale: torch.Tensor,
                        translate: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` images resampled to ``[B, size, size, C]`` float32:
    output pixel ``(i, j)`` of image ``b`` samples the input at
    ``((i + 0.5 - translate[b, 0]) / scale[b, 0] - 0.5, (j + 0.5 -
    translate[b, 1]) / scale[b, 1] - 0.5)`` with the linear kernel, as
    ``jax.image.scale_and_translate(..., method="linear", antialias=True)``.
    ``scale`` and ``translate`` are ``[B, 2]`` (rows, columns). The per-image
    separable weights ``[B, size, H]`` and ``[B, size, W]`` contract with two
    batched products in float32."""
    x = images.to(torch.float32)
    rows = _weight_mat(x.shape[1], size, scale[:, 0], translate[:, 0])
    cols = _weight_mat(x.shape[2], size, scale[:, 1], translate[:, 1])
    x = torch.einsum("boh,bhwc->bowc", rows, x)
    return torch.einsum("bpw,bowc->bopc", cols, x)


def _weight_mat(n_in: int, n_out: int, scale: torch.Tensor, translate: torch.Tensor):
    """``[B, n_out, n_in]`` float32 weights of one axis, the formula of
    ``jax._src.image.scale.compute_weight_mat`` per image: the triangle
    kernel over distances divided by ``max(1 / scale, 1)``, each output's
    weights normalised to sum 1 (0 where they sum to almost 0), and 0 for
    an output whose sample lies outside ``[-0.5, n_in - 0.5]``. Computed in
    float64: in float32 a sample position near 200 is only good to 1.5e-5
    of a pixel, which moves an output by up to 4e-3 on the 0-255 scale."""
    dev = scale.device
    scale, translate = scale.to(torch.float64), translate.to(torch.float64)
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=torch.float64, device=dev) + 0.5) * inv_scale
              - translate[:, None] * inv_scale - 0.5)                       # [B, n_out]
    dist = (sample[:, :, None] - torch.arange(n_in, dtype=torch.float64, device=dev)).abs()
    weights = torch.clamp(1 - dist / kernel_scale[:, :, None], min=0)    # [B, n_out, n_in]
    total = weights.sum(2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights)).to(torch.float32)


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, size, size, C]`` float32, bilinear and
    antialiased when downscaling: ``jax.image.resize(..., "bilinear")``. An
    axis already at ``size`` is left as it is."""
    b, h, w, _ = images.shape
    x = images.to(torch.float32)
    zero = torch.zeros((b,), dtype=torch.float64, device=images.device)
    if h != size:
        x = torch.einsum("boh,bhwc->bowc", _weight_mat(h, size, zero + size / h, zero), x)
    if w != size:
        x = torch.einsum("bpw,bowc->bopc", _weight_mat(w, size, zero + size / w, zero), x)
    return x


def draw_resized_crop(b: int, generator: torch.Generator, *, height: int, width: int,
                      scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Per-image boxes ``(ch, cw, oy, ox)`` (float32) of a random resized
    crop, by direct sampling as the JAX package draws them: area uniform in
    ``scale * H * W``, log aspect uniform in ``log(ratio)``, the box's sides
    clipped to ``[1, H]`` and ``[1, W]``, its corner uniform over what
    remains. (torchvision's ten-try rejection loop draws another
    distribution.)"""
    device = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((b,), generator=generator, device=device)

    area = uniform(scale[0], scale[1]) * (height * width)
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, float(width))
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, float(height))
    oy = torch.rand((b,), generator=generator, device=device) * (height - ch)
    ox = torch.rand((b,), generator=generator, device=device) * (width - cw)
    return ch, cw, oy, ox


def resized_crop(images: torch.Tensor, size: int, ch, cw, oy, ox) -> torch.Tensor:
    """Box ``(ch, cw)`` at ``(oy, ox)`` of each image resampled to ``size x
    size`` float32 (JAX ``random_resized_crop`` past its draws). The scales
    ``size / ch`` and ``size / cw`` and the offsets are taken in the boxes'
    dtype, as JAX takes them."""
    scale = torch.stack([size / ch, size / cw], 1)
    return scale_and_translate(images, size, scale, torch.stack([-oy, -ox], 1) * scale)


def _resized_crop_op(size: int) -> Callable:
    def augment(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        b, h, w, _ = images.shape
        return resized_crop(images, size, *draw_resized_crop(b, generator, height=h, width=w))

    return augment


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
        elif name == "RandomResizedCrop":
            ops.append(_resized_crop_op(int(arg)))
        elif name == "Resize":
            ops.append(lambda x, g, s=int(arg): resize(x, s))
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
    """Deterministic validation transform (CenterCrop and Resize, in config
    order)."""
    ops = []
    for name, arg in dict(aug_cfg or {}).items():
        if name == "CenterCrop":
            ops.append(lambda x, s=int(arg): center_crop(x, s))
        elif name == "Resize":
            ops.append(lambda x, s=int(arg): resize(x, s))
        else:
            raise ValueError(f"Unsupported eval augmentation {name}.")

    def transform(images):
        for op in ops:
            images = op(images)
        return images

    return transform
