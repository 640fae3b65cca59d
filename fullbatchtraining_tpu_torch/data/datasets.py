"""Raw datasets as host numpy arrays (uint8 NHWC images, int32 labels).

The port's own copy of the CIFAR parts of
``fullbatchtraining_tpu/data/datasets.py``: the python-pickle loader and the
deterministic synthetic stand-in used when the raw files are absent and
``data.synthetic_fallback`` is set. ``_synthetic`` makes the same bytes as
the JAX package's (the same numpy calls), so both packages train on
identical data; its cache lives under the process's temporary directory
(``TMPDIR``). There is no download: place the CIFAR batches under
``data.path``.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)


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


def construct_datasets(cfg_data, dryrun: bool = False) -> tuple[ArrayDataset, ArrayDataset]:
    """Build (train, valid) ArrayDatasets per the data config group."""
    name = cfg_data.name
    if name not in ("CIFAR10", "CIFAR100"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md, 'Streamed epochs and other datasets')")
    base = Path(os.path.expanduser(str(cfg_data.path)))
    loaded = _load_cifar_pickles(base, name)
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
