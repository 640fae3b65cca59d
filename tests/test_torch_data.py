"""The port's data path against the JAX package's: datasets, normalisation,
crop+flip, epoch layout. All of it is exact (integers, or one IEEE rounding
per op on both sides), so the comparisons are equalities."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.data import augmentations as jaug
from fullbatchtraining_tpu.data import datasets as jdatasets
from fullbatchtraining_tpu.data import pipeline as jpipeline
from fullbatchtraining_tpu_torch.data import augmentations as aug
from fullbatchtraining_tpu_torch.data import datasets, pipeline


@pytest.fixture
def cache_dirs(tmp_path, monkeypatch):
    """Separate synthetic caches under ``tmp_path``: the port's through its
    temporary directory, the JAX package's by redirecting its fixed root."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "torch"))
    (tmp_path / "torch").mkdir()
    real_path = jdatasets.Path
    monkeypatch.setattr(jdatasets, "Path", lambda p, *rest: (
        real_path(tmp_path / "jax") if str(p) == "/tmp/fbt_synthetic" else real_path(p, *rest)))
    return tmp_path / "torch" / "fbt_synthetic", tmp_path / "jax"


def test_synthetic_is_byte_identical(cache_dirs):
    """Both packages generate the same bytes, each into its own cache; the
    port's cached copy loads back unchanged."""
    args = ("TorchParitySynthetic", 97, 8, 3, 10, 5)
    name = "TorchParitySynthetic_97_8_3_10_5.npz"
    (jtx, jty), (jvx, jvy) = jdatasets._synthetic(*args)
    assert (cache_dirs[1] / name).exists()
    fresh = datasets._synthetic(*args)
    assert (cache_dirs[0] / name).exists()
    cached = datasets._synthetic(*args)
    for (tx, ty), (vx, vy) in (fresh, cached):
        for ours, ref in ((tx, jtx), (ty, jty), (vx, jvx), (vy, jvy)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)


def test_construct_datasets_matches(config_dir, cache_dirs):
    cfg = load_config(config_dir, overrides=["data.size=40", "data.path=/tmp/__torch_nodata__"])
    jtrain, jvalid = jdatasets.construct_datasets(cfg.data, can_download=False)
    train, valid = datasets.construct_datasets(cfg.data)
    for ours, ref in ((train, jtrain), (valid, jvalid)):
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        assert ours.labels.dtype == ref.labels.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
def test_normalize_matches(dtype):
    images = np.random.default_rng(0).integers(0, 256, (4, 6, 6, 3), dtype=np.uint8)
    mean, std = [0.49, 0.48, 0.45], [0.25, 0.24, 0.26]
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jaug.normalize(jnp.asarray(images), mean, std, getattr(jnp, dtype)))
    ours = aug.normalize(torch.from_numpy(images), mean, std, getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ours.to(torch.float64).numpy(), ref.astype(np.float64))


@pytest.mark.parametrize("flip_p", [0.5, 0.0])
def test_crop_flip_with_jax_draws_matches(flip_p):
    """Feed the port's crop_flip the exact draws of random_crop_flip_mxu
    (augmentations.py:101-104) and compare the images."""
    b, size, pad = 64, 32, 4
    images = np.random.default_rng(1).integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    key = jax.random.key(3)
    ref = np.asarray(jaug.random_crop_flip_mxu(jnp.asarray(images), key, size, pad, flip_p))
    ky, kx, kf = jax.random.split(key, 3)
    span = size + 2 * pad - size + 1
    oy = np.array(jax.random.randint(ky, (b,), 0, span))
    ox = np.array(jax.random.randint(kx, (b,), 0, span))
    flip = (np.array(jax.random.bernoulli(kf, flip_p, (b,))) if flip_p > 0
            else np.zeros(b, bool))
    ours = aug.crop_flip(torch.from_numpy(images), torch.from_numpy(oy), torch.from_numpy(ox),
                         torch.from_numpy(flip), size, pad)
    assert ours.dtype == torch.uint8 and ours.shape == (b, size, size, 3)
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.float32).astype(np.uint8))
    if flip_p:
        assert 0 < flip.sum() < b


def test_own_draws_cover_their_range():
    gen = torch.Generator().manual_seed(0)
    oy, ox, flip = aug.draw_crop_flip(2048, gen, height=32, width=32, size=32, padding=4,
                                      flip_p=0.5)
    for off in (oy, ox):
        assert off.min().item() == 0 and off.max().item() == 8
    assert 0 < flip.sum().item() < 2048
    augment = aug.make_augment_fn({"RandomCrop": [32, 4], "RandomHorizontalFlip": 0.5})
    images = torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8, generator=gen)
    out = augment(images, gen)
    assert out.shape == images.shape and out.dtype == torch.uint8


def test_eval_center_crop_matches():
    images = np.random.default_rng(2).integers(0, 256, (2, 9, 9, 3), dtype=np.uint8)
    ref = np.asarray(jaug.make_eval_transform({"CenterCrop": 5})(jnp.asarray(images)))
    ours = aug.make_eval_transform({"CenterCrop": 5})(torch.from_numpy(images))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("total,batch,sub,dryrun", [
    (50_000, 2048, 2048, False), (50_000, 128, 128, False), (32, 16, 8, False),
    (100, 48, 10, False), (20, 128, 16, False), (64, 16, 8, True)])
def test_epoch_layout_matches(total, batch, sub, dryrun):
    ref = jpipeline.epoch_layout(total, batch, sub, 1, dryrun=dryrun)
    assert pipeline.epoch_layout(total, batch, sub, 1, dryrun=dryrun) == ref
    images = np.arange(total * 2, dtype=np.uint8).reshape(total, 2, 1, 1)
    labels = np.arange(total)
    for ours, r in zip(pipeline.layout_epoch(images, labels, *ref, 1),
                       jpipeline.layout_epoch(images, labels, *ref, 1)):
        np.testing.assert_array_equal(ours, r)


@pytest.mark.parametrize("cfg", [
    {"RandomCrop": [28, 2], "CenterCrop": 24},
    {"CenterCrop": 28, "RandAugment": "rand-m9-n2"},
    {"RandomResizedCrop": 24, "RandomHorizontalFlip": 0.5},
    {"AugMix": "augmix-m3", "Resize": 40},
    {}])
def test_augmented_hw_matches(cfg):
    assert aug.augmented_hw(cfg, 32, 32) == jaug.augmented_hw(cfg, 32, 32)


def test_center_crop_composes_in_config_order():
    """CenterCrop, a RandomCrop that can only take the whole image, and a
    certain flip, applied in config order: deterministic, so equal to the
    JAX package's composition."""
    images = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    cfg = {"CenterCrop": 28, "RandomCrop": [28, 0], "RandomHorizontalFlip": 1.0}
    ref = np.asarray(jaug.make_augment_fn(cfg)(jnp.asarray(images), jax.random.key(0)))
    ours = aug.make_augment_fn(cfg)(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert ours.shape == (4, 28, 28, 3)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("key", ["RandAugment", "AutoAugment", "AugMix"])
def test_policy_key_outside_a_bake_raises(key):
    """A policy augmentation runs only in a baked store: in
    ``data.augmentations_train`` both packages refuse it."""
    with pytest.raises(ValueError, match=key):
        jaug.make_augment_fn({key: "v0"})
    with pytest.raises(ValueError, match=key):
        aug.make_augment_fn({key: "v0"})
