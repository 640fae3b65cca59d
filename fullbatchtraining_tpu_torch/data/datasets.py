"""Raw datasets as host numpy arrays (uint8 NHWC images, int32 labels).

The port's own copy of ``fullbatchtraining_tpu/data/datasets.py``: the
CIFAR python-pickle loader, the TinyImageNet tree and the ImageFolder tree
(ImageNet), and the deterministic synthetic stand-in used when the raw
files are absent and ``data.synthetic_fallback`` is set. ``_synthetic``
makes the same bytes as the JAX package's (the same numpy calls), so both
packages train on identical data; its cache lives under the process's
temporary directory (``TMPDIR``). There is no download: place the files
under ``data.path``.

The two image trees decode once, with PIL, into uint8 ``.npy`` files beside
the tree that later runs open as memmaps; the layout and names are the JAX
package's, so either package reuses the other's decode. PIL is also the
JAX package's own decoder where its libjpeg engine is absent, and the one
whose bytes it falls back to.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

# torchvision datasets/folder.py IMG_EXTENSIONS
_IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp"}
_TINY_SIDE = 64        # TinyImageNet images are 64x64
_DRYRUN_FILES = 256    # files a split a dryrun decodes into its own cache


class ArrayDataset:
    """images uint8 NHWC, labels int32; the universal host representation."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, classes: int):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be uint8 NHWC, got {images.dtype} {images.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.classes = classes

    def __len__(self):
        return len(self.images)

    def subset(self, indices) -> "ArrayDataset":
        return ArrayDataset(self.images[indices], self.labels[indices], self.classes)


def _load_cifar_pickles(base: Path, name: str) -> tuple | None:
    """CIFAR-10/100 from the standard python-version pickle batches."""
    if name == "CIFAR10":
        folder = base / "cifar-10-batches-py"
        train_files = [folder / f"data_batch_{i}" for i in range(1, 6)]
        test_files = [folder / "test_batch"]
        label_key = b"labels"
    else:
        folder = base / "cifar-100-python"
        train_files = [folder / "train"]
        test_files = [folder / "test"]
        label_key = b"fine_labels"
    if not all(f.exists() for f in train_files + test_files):
        return None

    def read(files):
        imgs, labels = [], []
        for f in files:
            with open(f, "rb") as handle:
                entry = pickle.load(handle, encoding="bytes")
            imgs.append(entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.extend(entry[label_key])
        return np.concatenate(imgs).astype(np.uint8), np.asarray(labels)

    return read(train_files), read(test_files)


def _synthetic(name: str, size: int, pixels: int, channels: int, classes: int,
               seed: int = 0) -> tuple:
    """Deterministic learnable synthetic data: per-class mean patterns + noise.

    Cached to disk after first generation - gaussian sampling of 50k images on
    a single host core costs minutes, loading the cache costs milliseconds.
    """
    cache = (Path(tempfile.gettempdir()) / "fbt_synthetic"
             / f"{name}_{size}_{pixels}_{channels}_{classes}_{seed}.npz")
    if cache.exists():
        import zipfile
        try:
            data = np.load(cache)
            return ((data["tx"], data["ty"]), (data["vx"], data["vy"]))
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            log.warning("Corrupt synthetic cache %s - regenerating.", cache)
            cache.unlink(missing_ok=True)

    rng = np.random.default_rng(seed)
    patterns = rng.uniform(0, 255, (classes, pixels, pixels, channels)).astype(np.float32)

    def make(n, split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, classes, n)
        images = np.empty((n, pixels, pixels, channels), np.uint8)
        step = 4096
        for start in range(0, n, step):  # chunked: bounds peak memory on small hosts
            idx = labels[start:start + step]
            noise = r.standard_normal((len(idx), pixels, pixels, channels),
                                      dtype=np.float32)
            block = patterns[idx] + 48.0 * noise
            np.clip(block, 0, 255, out=block)
            images[start:start + step] = block.astype(np.uint8)
        return images, labels

    train, valid = make(size, seed + 1), make(max(classes, min(size // 5, 10_000)), seed + 2)
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        # pid-unique temp + atomic rename: a kill mid-write must never leave
        # a corrupt cache at the final path
        tmp = cache.with_suffix(f".{os.getpid()}.part")
        with open(tmp, "wb") as handle:
            np.savez(handle, tx=train[0], ty=train[1], vx=valid[0], vy=valid[1])
        tmp.replace(cache)
    except OSError:
        pass
    return train, valid


def _decode_split(img_file: Path, lbl_file: Path, files, labels, side: int, read,
                  chunk: int, what: str):
    """``(images, labels)`` of one split: the cached ``.npy`` pair where the
    label file, written last, marks it complete (images as a read-only
    memmap); else every file of ``files`` through ``read(path) -> [side,
    side, 3] uint8`` into a new ``img_file``, then the labels."""
    if lbl_file.exists() and img_file.exists():
        return np.load(img_file, mmap_mode="r"), np.load(lbl_file)
    img_file.parent.mkdir(parents=True, exist_ok=True)
    images = np.lib.format.open_memmap(img_file, mode="w+", dtype=np.uint8,
                                       shape=(len(files), side, side, 3))
    for start in range(0, len(files), chunk):
        for i, path in enumerate(files[start:start + chunk]):
            images[start + i] = read(path)
        if start % 51_200 == 0:
            log.info("Decoded %d/%d %s images", start, len(files), what)
    images.flush()
    labels = np.asarray(labels, np.int32)
    np.save(lbl_file, labels)
    return images, labels


def _pil():
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("decoding an image tree needs Pillow, which is not installed") from err
    return Image


def _load_tiny_imagenet(base: Path) -> tuple | None:
    """TinyImageNet from ``<base>/tiny-imagenet-200``: ``wnids.txt`` sorted
    gives the labels, ``train/<wnid>/images/*.JPEG`` sorted and the
    ``val/val_annotations.txt`` list give the files, each decoded to RGB
    (resized bilinearly to 64x64 where it is not) into
    ``_fbt_cache/{split}_images.npy``. None where the manifest or the
    annotations are missing: the tree is absent or half extracted."""
    folder = base / "tiny-imagenet-200"
    manifest = folder / "wnids.txt"
    annotations = folder / "val" / "val_annotations.txt"
    if not (manifest.exists() and annotations.exists()):
        return None
    cache = folder / "_fbt_cache"

    def read(path):
        image = _pil().open(path).convert("RGB")
        if image.size != (_TINY_SIDE, _TINY_SIDE):
            image = image.resize((_TINY_SIDE, _TINY_SIDE), _pil().BILINEAR)
        return np.asarray(image, np.uint8)

    wnids = sorted(manifest.read_text().split())
    label_of = {w: i for i, w in enumerate(wnids)}
    train_files, train_labels = [], []
    for wnid in wnids:
        for path in sorted((folder / "train" / wnid / "images").glob("*.JPEG")):
            train_files.append(path)
            train_labels.append(label_of[wnid])
    val_files, val_labels = [], []
    for line in annotations.read_text().strip().splitlines():
        name, wnid = line.split("\t")[:2]
        val_files.append(folder / "val" / "images" / name)
        val_labels.append(label_of[wnid])
    return tuple(_decode_split(cache / f"{tag}_images.npy", cache / f"{tag}_labels.npy", files,
                               labels, _TINY_SIDE, read, 1024, tag)
                 for tag, files, labels in (("train", train_files, train_labels),
                                            ("val", val_files, val_labels)))


def _load_imagefolder(base: Path, pixels: int, cache_tag: str,
                      dryrun: bool = False) -> tuple | None:
    """An ImageFolder tree (``train/<class>/*``, ``val/<class>/*``; classes
    sorted, files sorted, only image files), each image resized bilinearly
    so its shorter side is ``int(pixels * 1.15)`` (room for the random
    crops) and centre-cropped square, into
    ``_fbt_cache_{cache_tag}_{pixels}/{split}_images.npy``. A dryrun without
    both full splits cached decodes the first 256 files a split into the
    separate ``..._dryrun`` cache. None where ``train/`` is missing."""
    if not (base / "train").exists():
        return None
    cache = base / f"_fbt_cache_{cache_tag}_{pixels}"
    limit = None
    if dryrun and not all((cache / f"{s}_labels.npy").exists() for s in ("train", "val")):
        cache = base / f"_fbt_cache_{cache_tag}_{pixels}_dryrun"
        limit = _DRYRUN_FILES
    side = int(pixels * 1.15)

    def read(path):
        image = _pil().open(path).convert("RGB")
        scale = side / min(image.size)
        image = image.resize((max(side, round(image.width * scale)),
                              max(side, round(image.height * scale))), _pil().BILINEAR)
        left, top = (image.width - side) // 2, (image.height - side) // 2
        return np.asarray(image.crop((left, top, left + side, top + side)), np.uint8)

    def split(name):
        img_file, lbl_file = cache / f"{name}_images.npy", cache / f"{name}_labels.npy"
        files, labels = [], []
        if not (lbl_file.exists() and img_file.exists()):  # a hit walks no directory
            folder = base / name
            for label, cls in enumerate(sorted(d.name for d in folder.iterdir() if d.is_dir())):
                for path in sorted((folder / cls).iterdir()):
                    if path.suffix.lower() in _IMG_EXTENSIONS and path.is_file():
                        files.append(path)
                        labels.append(label)
                if limit is not None and len(files) >= limit:
                    break
            if limit is not None:
                files, labels = files[:limit], labels[:limit]
        return _decode_split(img_file, lbl_file, files, labels, side, read, 512, name)

    return split("train"), split("val")


def construct_datasets(cfg_data, dryrun: bool = False) -> tuple[ArrayDataset, ArrayDataset]:
    """Build (train, valid) ArrayDatasets per the data config group: CIFAR
    pickles, the TinyImageNet tree or, for ImageNet, an ImageFolder tree
    under ``data.path``; where none is there, the synthetic stand-in or
    ``FileNotFoundError``."""
    name = cfg_data.name
    base = Path(os.path.expanduser(str(cfg_data.path)))
    if name in ("CIFAR10", "CIFAR100"):
        loaded = _load_cifar_pickles(base, name)
    elif name == "TinyImageNet":
        loaded = _load_tiny_imagenet(base)
    elif name == "ImageNet":
        loaded = _load_imagefolder(base, cfg_data.pixels, name, dryrun=dryrun)
    else:
        loaded = None
    if loaded is None:
        if not cfg_data.get("synthetic_fallback", False):
            raise FileNotFoundError(
                f"Dataset {name} not found under {base} and synthetic_fallback is off.")
        log.warning("Dataset %s not found under %s - using deterministic synthetic data.",
                    name, base)
        size = int(cfg_data.size) if not dryrun else min(int(cfg_data.size), 256)
        loaded = _synthetic(name, size, cfg_data.pixels, cfg_data.channels, cfg_data.classes)

    (train_x, train_y), (valid_x, valid_y) = loaded
    train = ArrayDataset(train_x, train_y, cfg_data.classes)
    valid = ArrayDataset(valid_x, valid_y, cfg_data.classes)

    requested = int(cfg_data.size)
    if requested < len(train):
        train = train.subset(np.arange(requested))
    return train, valid
