"""The port's ``Resize`` and ``RandomResizedCrop`` against the JAX package's.

Both resample with ``jax.image.scale_and_translate``'s linear kernel (the
port's own copy of its weights, two batched products) and return float32.
Tolerances on the 0-255 scale: ``resize`` 1e-4 absolute (float32 sums in
another order), the crop 1e-3 (per-image scales and offsets). The random
draws cannot match (threefry against Philox), so the crop and the ImageNet
yaml's train transform are fed the boxes and flips that JAX draws from the
same key; the eval transform is deterministic.

The port computes the sample positions in float64. The JAX functions take
them in float32 by default, where a position near 200 pixels is good to
1.5e-5 of a pixel, which moves an output of these random images (neighbours
up to 255 apart) by up to 8e-3. So the reference is the JAX function run
under ``jax.enable_x64``: positions in float64, images and products still
float32. The crops of 16-32 pixels are also held against JAX in float32,
whose positions are good enough there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import augmentations as jax_aug
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import augmentations as aug

RESIZE_TOL = 1e-4
CROP_TOL = 1e-3


def _images(b, h, w=None, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w or h, 3), dtype=np.uint8)


def jax_boxes(key, b, h, w, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """The boxes ``fullbatchtraining_tpu.data.augmentations.random_resized_crop``
    draws from ``key``: its own calls, as torch tensors ``(ch, cw, oy, ox)``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = jax.random.uniform(k1, (b,), minval=scale[0], maxval=scale[1]) * (h * w)
    log_ratio = jax.random.uniform(k2, (b,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))
    aspect = jnp.exp(log_ratio)
    cw = jnp.clip(jnp.sqrt(area * aspect), 1.0, w)
    ch = jnp.clip(jnp.sqrt(area / aspect), 1.0, h)
    oy = jax.random.uniform(k3, (b,)) * (h - ch)
    ox = jax.random.uniform(k4, (b,)) * (w - cw)
    return tuple(torch.from_numpy(np.array(v)) for v in (ch, cw, oy, ox))


@pytest.mark.parametrize("h,w,size", [(24, 24, 32), (32, 32, 20), (37, 37, 32), (30, 45, 36),
                                      (16, 16, 16), (224, 224, 256), (257, 257, 256)],
                         ids=str)
def test_resize_matches_jax(h, w, size):
    """Up (no antialias to do), down (the kernel widened), ragged, the
    identity, and the ImageNet shapes: synthetic 224 and the 257 of the
    JPEG cache, both to ``Resize 256``."""
    x = _images(4 if h < 100 else 2, h, w)
    with jax.enable_x64(True):
        ref = np.asarray(jax_aug.resize(jnp.asarray(x), size))
    ours = aug.resize(torch.from_numpy(x), size)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=RESIZE_TOL)


CROPS = [(40, 32, "x64"), (24, 32, "x64"), (64, 64, "x64"), (224, 224, "x64"),
         (257, 224, "x64"), (40, 32, "float32"), (24, 32, "float32"), (16, 16, "float32")]


@pytest.mark.parametrize("h,size,positions", CROPS, ids=str)
def test_random_resized_crop_matches_jax_on_its_boxes(h, size, positions):
    x = _images(6 if h < 100 else 3, h, seed=h)
    with jax.enable_x64(True) if positions == "x64" else contextlib.nullcontext():
        key = jax.random.key(h)
        ref = np.asarray(jax_aug.random_resized_crop(jnp.asarray(x), key, size))
        boxes = jax_boxes(key, len(x), h, h)
    ours = aug.resized_crop(torch.from_numpy(x), size, *boxes)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=CROP_TOL)


def test_scale_and_translate_matches_jax_at_edges():
    """Boxes at the border, a 1-pixel box and samples outside the image
    (zero weights there)."""
    x = _images(4, 20, 28, seed=3).astype(np.float32)
    scale = np.array([[0.5, 1.0], [3.0, 0.7], [32.0, 32.0], [1.3, 2.2]])
    translate = np.array([[0.0, -2.0], [-40.0, 5.0], [-300.0, -600.0], [4.5, -1.25]])
    ours = aug.scale_and_translate(torch.from_numpy(x), 16, torch.from_numpy(scale),
                                   torch.from_numpy(translate))
    for b in range(4):
        with jax.enable_x64(True):
            ref = jax.image.scale_and_translate(jnp.asarray(x[b]), (16, 16, 3), (0, 1),
                                                jnp.asarray(scale[b]), jnp.asarray(translate[b]),
                                                "linear")
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(ref), rtol=0, atol=CROP_TOL)


def test_draw_resized_crop_keeps_boxes_inside():
    """The port's own draws: boxes inside the image, areas and aspects in
    their ranges before the clip."""
    g = torch.Generator().manual_seed(0)
    ch, cw, oy, ox = aug.draw_resized_crop(4096, g, height=48, width=64)
    assert bool((ch >= 1).all() and (ch <= 48).all() and (cw >= 1).all() and (cw <= 64).all())
    assert bool((oy >= 0).all() and (oy + ch <= 48 + 1e-4).all())
    assert bool((ox >= 0).all() and (ox + cw <= 64 + 1e-4).all())
    unclipped = (ch < 48) & (cw < 64) & (ch > 1) & (cw > 1)
    area = (ch * cw)[unclipped] / (48 * 64)
    assert 0.08 - 1e-5 <= area.min().item() and area.max().item() <= 1 + 1e-5
    aspect = (cw / ch)[unclipped]
    assert 0.75 - 1e-5 <= aspect.min().item() and aspect.max().item() <= 4 / 3 + 1e-5


def test_imagenet_transforms_match_jax(config_dir, monkeypatch):
    """``make_augment_fn`` (RandomResizedCrop 224, flip 0.5) fed the JAX
    draws of one key, and ``make_eval_transform`` (Resize 256, CenterCrop
    224) of the ImageNet yaml, against the JAX package's on 257-pixel
    cache images: float32 throughout, as the JAX functions return."""
    cfg = load_config(config_dir, overrides=["data=ImageNet"])
    jcfg = jax_load_config(config_dir, overrides=["data=ImageNet"])
    x = _images(3, 257, seed=7)
    with jax.enable_x64(True):
        key = jax.random.key(11)
        ref = np.asarray(jax_aug.make_augment_fn(jcfg.data.augmentations_train)(
            jnp.asarray(x), key))
        # _compose folds the op's index into the key: 0 the crop, 1 the flip
        boxes = jax_boxes(jax.random.fold_in(key, 0), 3, 257, 257)
        flip = torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(key, 1), 0.5, (3, 1, 1, 1)))).reshape(3)
    assert 0 < int(flip.sum()) < 3       # the key flips some, not all
    monkeypatch.setattr(aug, "draw_resized_crop", lambda b, g, **k: boxes)
    monkeypatch.setattr(aug, "draw_crop_flip",
                        lambda b, g, **k: (torch.zeros(b, dtype=torch.long),
                                           torch.zeros(b, dtype=torch.long), flip))
    ours = aug.make_augment_fn(cfg.data.augmentations_train)(torch.from_numpy(x),
                                                             torch.Generator())
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=CROP_TOL)

    ref = np.asarray(jax_aug.make_eval_transform(jcfg.data.augmentations_val)(jnp.asarray(x)))
    ours = aug.make_eval_transform(cfg.data.augmentations_val)(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=RESIZE_TOL)
