"""The port's TinyImageNet and ImageFolder loaders against the JAX package's.

Tiny JPEG trees written with PIL under ``tmp_path``: a TinyImageNet tree of
3 wnids (some images not 64x64, so the resize runs) and an ImageFolder tree
of 3 classes with entries that are not images. The JAX loaders run on
their PIL path (their libjpeg engine is switched off in the test), so both
packages decode with the same library and must agree bit for bit. Each
package reuses the cache the other wrote, a dryrun decodes at most 256
files a split into its own cache, and a half-extracted tree reads as
absent.
"""

import numpy as np
import pytest

import fullbatchtraining_tpu.data.native as jax_native
from fullbatchtraining_tpu.data import datasets as jax_datasets
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import datasets

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

WNIDS = ["n02", "n01", "n03"]     # sorted order gives the labels
SIZES = [(64, 64), (40, 30), (30, 48), (70, 66)]


@pytest.fixture(autouse=True)
def jax_on_pil(monkeypatch):
    """The JAX loaders' PIL path: their native engine declines every file."""
    monkeypatch.setattr(jax_native, "decode_resize_jpeg_batch", lambda *a, **k: None)


def _image(rng, size):
    return Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))


def _tiny_tree(base, per_wnid=4, val=5, annotations=True):
    rng = np.random.default_rng(0)
    folder = base / "tiny-imagenet-200"
    (folder / "val" / "images").mkdir(parents=True)
    (folder / "wnids.txt").write_text("\n".join(WNIDS) + "\n")
    for wnid in WNIDS:
        images = folder / "train" / wnid / "images"
        images.mkdir(parents=True)
        for i in range(per_wnid):
            _image(rng, SIZES[i % len(SIZES)]).save(images / f"{wnid}_{i}.JPEG", quality=90)
    lines = []
    for i in range(val):
        _image(rng, SIZES[i % len(SIZES)]).save(folder / "val" / "images" / f"val_{i}.JPEG")
        lines.append(f"val_{i}.JPEG\t{WNIDS[i % 3]}\t0\t0\t63\t63")
    if annotations:
        (folder / "val" / "val_annotations.txt").write_text("\n".join(lines) + "\n")
    return folder


def _imagefolder_tree(base, per_class=(4, 2), odd=True):
    """``train``/``val`` of 3 classes, with a README, a hidden file and a
    sub-directory that the loaders must skip."""
    rng = np.random.default_rng(1)
    for split, count in zip(("train", "val"), per_class):
        (base / split / "README.txt").parent.mkdir(parents=True, exist_ok=True)
        (base / split / "README.txt").write_text("not a class")
        for c, cls in enumerate(("c_b", "c_a", "c_c")):
            folder = base / split / cls
            (folder / "nested").mkdir(parents=True)
            (folder / ".DS_Store").write_bytes(b"\0")
            (folder / "notes.txt").write_text("not an image")
            for i in range(count):
                size = (37 + 5 * i + c, 29 + 3 * i) if odd else (12, 12)
                _image(rng, size).save(folder / f"{i:03d}.jpg", quality=85)
            _image(rng, (33, 41)).save(folder / "extra.PNG")
    return base


def _assert_split_equal(ours, ref):
    assert ours[0].dtype == np.uint8 and ours[0].shape == ref[0].shape
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[1].dtype == np.int32


def test_tiny_imagenet_matches_jax_and_shares_its_cache(tmp_path, monkeypatch):
    """Bitwise the JAX decode; then the JAX loader reads the port's cache
    without decoding, and the port reads the JAX package's."""
    _tiny_tree(tmp_path / "a")
    _tiny_tree(tmp_path / "b")
    ours = datasets._load_tiny_imagenet(tmp_path / "a")
    ref = jax_datasets._load_tiny_imagenet(tmp_path / "b")
    for o, r in zip(ours, ref):
        _assert_split_equal(o, r)
    assert ours[0][0].shape == (12, 64, 64, 3) and ours[1][0].shape == (5, 64, 64, 3)
    np.testing.assert_array_equal(ours[0][1], np.repeat([0, 1, 2], 4))   # wnids sorted
    cache = tmp_path / "a" / "tiny-imagenet-200" / "_fbt_cache"
    assert sorted(p.name for p in cache.iterdir()) == [
        "train_images.npy", "train_labels.npy", "val_images.npy", "val_labels.npy"]

    def no_decode(*args, **kwargs):
        raise AssertionError("decoded although the cache is complete")

    monkeypatch.setattr(jax_native, "decode_resize_jpeg_batch", no_decode)
    monkeypatch.setattr(datasets, "_pil", no_decode)
    for o, r in zip(jax_datasets._load_tiny_imagenet(tmp_path / "a"), ours):
        _assert_split_equal(o, r)
    for o, r in zip(datasets._load_tiny_imagenet(tmp_path / "b"), ref):
        assert isinstance(o[0], np.memmap)
        _assert_split_equal(o, r)


@pytest.mark.parametrize("pixels", [16, 40])
def test_imagefolder_matches_jax_and_shares_its_cache(pixels, tmp_path, monkeypatch):
    """Shorter side to ``int(pixels * 1.15)`` and a centre crop: down from
    the odd sizes at 16, up at 40; bitwise the JAX decode, non-image entries
    skipped, and each package reuses the other's cache."""
    _imagefolder_tree(tmp_path / "a")
    _imagefolder_tree(tmp_path / "b")
    ours = datasets._load_imagefolder(tmp_path / "a", pixels, "ImageNet")
    ref = jax_datasets._load_imagefolder(tmp_path / "b", pixels, "ImageNet")
    side = int(pixels * 1.15)
    assert ours[0][0].shape == (15, side, side, 3) and ours[1][0].shape == (9, side, side, 3)
    np.testing.assert_array_equal(ours[0][1], np.repeat([0, 1, 2], 5))   # c_a, c_b, c_c
    for o, r in zip(ours, ref):
        _assert_split_equal(o, r)
    assert (tmp_path / "a" / f"_fbt_cache_ImageNet_{pixels}" / "val_labels.npy").exists()

    def no_decode(*args, **kwargs):
        raise AssertionError("decoded although the cache is complete")

    monkeypatch.setattr(jax_native, "decode_resize_jpeg_batch", no_decode)
    monkeypatch.setattr(datasets, "_pil", no_decode)
    for o, r in zip(jax_datasets._load_imagefolder(tmp_path / "a", pixels, "ImageNet"), ours):
        _assert_split_equal(o, r)
    for o, r in zip(datasets._load_imagefolder(tmp_path / "b", pixels, "ImageNet"), ref):
        _assert_split_equal(o, r)


def test_imagefolder_dryrun_decodes_256_files_into_its_own_cache(tmp_path):
    """A dryrun without the full cache decodes the first 256 files a split
    (by class, in order) into ``_fbt_cache_{tag}_{pixels}_dryrun``, as the
    JAX package does; a complete full cache is read instead."""
    _imagefolder_tree(tmp_path / "a", per_class=(95, 1), odd=False)
    _imagefolder_tree(tmp_path / "b", per_class=(95, 1), odd=False)
    ours = datasets._load_imagefolder(tmp_path / "a", 8, "t", dryrun=True)
    ref = jax_datasets._load_imagefolder(tmp_path / "b", 8, "t", dryrun=True)
    assert len(ours[0][0]) == 256 and len(ours[1][0]) == 6
    np.testing.assert_array_equal(np.bincount(ours[0][1]), [96, 96, 64])
    for o, r in zip(ours, ref):
        _assert_split_equal(o, r)
    assert (tmp_path / "a" / "_fbt_cache_t_8_dryrun" / "train_labels.npy").exists()
    assert not (tmp_path / "a" / "_fbt_cache_t_8").exists()
    full = datasets._load_imagefolder(tmp_path / "a", 8, "t")
    assert len(full[0][0]) == 3 * 96
    again = datasets._load_imagefolder(tmp_path / "a", 8, "t", dryrun=True)
    _assert_split_equal(again[0], full[0])


def test_half_extracted_trees_read_as_absent(tmp_path, config_dir):
    """No val annotations (TinyImageNet) or no ``train/`` (ImageFolder): the
    loaders return None, as the JAX package's do; ``construct_datasets``
    then takes the synthetic stand-in, or raises without the fallback."""
    _tiny_tree(tmp_path, annotations=False)
    assert datasets._load_tiny_imagenet(tmp_path) is None
    assert jax_datasets._load_tiny_imagenet(tmp_path) is None
    (tmp_path / "val").mkdir()
    assert datasets._load_imagefolder(tmp_path, 16, "ImageNet") is None
    assert jax_datasets._load_imagefolder(tmp_path, 16, "ImageNet") is None
    for name in ("TinyImageNet", "ImageNet"):
        cfg = load_config(config_dir, overrides=[f"data={name}", f"data.path={tmp_path}",
                                                 "data.size=32"])
        train, valid = datasets.construct_datasets(cfg.data, dryrun=True)
        assert train.images.shape == (32, cfg.data.pixels, cfg.data.pixels, 3)
        cfg.data.synthetic_fallback = False
        with pytest.raises(FileNotFoundError):
            datasets.construct_datasets(cfg.data)


@pytest.mark.parametrize("name", ["TinyImageNet", "ImageNet"])
def test_construct_datasets_reads_the_trees(name, tmp_path, config_dir):
    """``construct_datasets`` of the yaml, ``data.path`` at a tree: the
    port's arrays are the JAX package's, ``data.size`` cuts the train set."""
    from fullbatchtraining_tpu.config import load_config as jax_load_config

    if name == "TinyImageNet":
        _tiny_tree(tmp_path)
    else:
        _imagefolder_tree(tmp_path)
    overrides = [f"data={name}", f"data.path={tmp_path}", "data.size=10"]
    cfg = load_config(config_dir, overrides=overrides)
    train, valid = datasets.construct_datasets(cfg.data, dryrun=name == "ImageNet")
    ref_train, ref_valid = jax_datasets.construct_datasets(
        jax_load_config(config_dir, overrides=overrides).data, dryrun=name == "ImageNet",
        can_download=False)
    assert len(train) == 10 and train.classes == cfg.data.classes
    for ours, ref in ((train, ref_train), (valid, ref_valid)):
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)


# --------------------------------------------------------------------------
# CIFAR-100's python pickles
# --------------------------------------------------------------------------

def _cifar100_pickles(base, sizes=(("train", 12), ("test", 5))):
    """Tiny ``cifar-100-python/{train,test}`` pickles in the upstream layout:
    bytes keys, ``data`` rows of 3072 uint8 (channel planes, then rows),
    ``fine_labels`` (100 classes) and ``coarse_labels`` (20 superclasses).
    Returns ``{split: entry}``."""
    import pickle

    rng = np.random.default_rng(4)
    folder = base / "cifar-100-python"
    folder.mkdir(parents=True)
    entries = {}
    for split, n in sizes:
        entries[split] = {
            b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
            b"fine_labels": [int(v) for v in rng.integers(0, 100, n)],
            b"coarse_labels": [int(v) for v in rng.integers(0, 20, n)],
            b"filenames": [f"img_{split}_{i}.png".encode() for i in range(n)],
            b"batch_label": f"{split} batch".encode()}
        with open(folder / split, "wb") as handle:
            pickle.dump(entries[split], handle)
    return entries


def test_cifar100_pickles_match_jax(tmp_path):
    """``_load_cifar_pickles`` of both packages on the same pickles: the
    same images, NHWC from the channel planes, and the fine labels (the
    100-class level; the coarse superclasses are not the labels)."""
    entries = _cifar100_pickles(tmp_path)
    ours = datasets._load_cifar_pickles(tmp_path, "CIFAR100")
    theirs = jax_datasets._load_cifar_pickles(tmp_path, "CIFAR100")
    for (images, labels), (ref_images, ref_labels), split in zip(ours, theirs,
                                                                  ("train", "test")):
        entry = entries[split]
        np.testing.assert_array_equal(images, ref_images)
        np.testing.assert_array_equal(labels, ref_labels)
        assert images.dtype == np.uint8 and images.shape == (len(labels), 32, 32, 3)
        planes = entry[b"data"].reshape(-1, 3, 32, 32)
        np.testing.assert_array_equal(images[:, 5, 7, 2], planes[:, 2, 5, 7])
        np.testing.assert_array_equal(labels, entry[b"fine_labels"])
        assert list(labels) != entry[b"coarse_labels"]
    assert datasets._load_cifar_pickles(tmp_path / "absent", "CIFAR100") is None


def test_cifar100_datasets_match_jax(tmp_path, config_dir):
    """``data=CIFAR100`` with ``data.path`` at the pickles: both packages'
    ``construct_datasets`` give the same train and validation sets, cut to
    ``data.size``, 100 classes."""
    _cifar100_pickles(tmp_path)
    cfg = load_config(config_dir, overrides=["data=CIFAR100", f"data.path={tmp_path}",
                                             "data.size=10"])
    train, valid = datasets.construct_datasets(cfg.data)
    jtrain, jvalid = jax_datasets.construct_datasets(cfg.data, can_download=False)
    for ours, ref, n in ((train, jtrain, 10), (valid, jvalid, 5)):
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        assert len(ours) == n and ours.classes == ref.classes == 100
