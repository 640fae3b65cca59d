"""Data bundle, epoch layout and epoch order (``fullbatchtraining_tpu/data/pipeline.py``,
``training/training.py:_epoch_order``).

The training set lives as one uint8 array; an optimizer step consumes it as
``num_blocks x chunks x sub_batch`` samples (drop-last), in order or, with
``hyp.shuffle``, in the step's :func:`epoch_order`. The trainer keeps it
resident on the device, or, where :func:`stream_plan` says the laid-out
epoch is above ``impl.hbm_epoch_max_bytes``, in host memory, and streams it
to the device in segments of whole blocks. With ``data.db`` the set is the baked store's
``rounds x size`` images (``data/baked.py``), whose augmentations are fixed
at bake time; a semi-stochastic step reads one of its rounds. With ``W``
ranks a global block is ``W`` per-rank blocks, and rank ``r`` trains on
``[:, r]`` of the step's rows laid out ``(blocks, W, chunks, sub)``
(:func:`rank_rows`).
"""

from __future__ import annotations

import atexit
import dataclasses
from typing import Callable

import numpy as np

from ..parallel import World, current_world
from .augmentations import make_augment_fn, make_eval_transform
from .baked import BakedDataset, bake_dataset
from .datasets import ArrayDataset, construct_datasets


@dataclasses.dataclass
class DataBundle:
    """Everything the training layer needs about the data."""

    train: ArrayDataset
    valid: ArrayDataset
    augment: Callable          # fn(images_u8, generator) -> augmented images
    eval_transform: Callable   # fn(images) -> images (deterministic)
    mean: np.ndarray
    std: np.ndarray
    normalize: bool
    classes: int
    channels: int
    pixels: int
    batch_size: int            # block size
    name: str
    baked: BakedDataset | None = None
    augmentations_active: bool = True

    @property
    def size(self):
        return len(self.train)


def construct_databundle(cfg_data, cfg_impl=None, cfg_hyp=None, dryrun: bool = False,
                         seed: int = 0, device="cuda", world: World | None = None) -> DataBundle:
    """Datasets + augmentation fns + layout constants for one data config.

    With ``data.db`` the store is baked (seeded by ``seed``, its non-policy
    augmentations on ``device``; by rank 0 of ``world``, the default process
    group's by default) or reused, and the training set becomes its flat
    ``rounds x size`` images, with no augmentation at train time. A
    temporary store goes when rank 0's process exits.
    ``cfg_impl`` and ``cfg_hyp`` are accepted for call-site symmetry with
    the JAX package; this function reads neither. Whether the epoch and the
    validation set stay on the device or stream from the host, and how
    they are shuffled, is decided by the trainer, which reads both
    (:func:`stream_plan`)."""
    world = world if world is not None else current_world()
    train, valid = construct_datasets(cfg_data, dryrun=dryrun)
    baked = None
    use_db = cfg_data.db.name is not None
    if use_db:
        baked = BakedDataset(bake_dataset(train, cfg_data, cfg_data.db, seed=seed,
                                          device=device, world=world))
        if cfg_data.db.get("temporary_database", False) and world.rank == 0:
            atexit.register(baked.cleanup)  # the store goes when the process exits
        train = baked.flat()
    return DataBundle(
        train=train,
        valid=valid,
        augment=make_augment_fn(None if use_db else cfg_data.augmentations_train),
        eval_transform=make_eval_transform(cfg_data.augmentations_val),
        mean=np.asarray(cfg_data.mean, np.float32),
        std=np.asarray(cfg_data.std, np.float32),
        normalize=bool(cfg_data.normalize),
        classes=cfg_data.classes,
        channels=cfg_data.channels,
        pixels=cfg_data.pixels,
        batch_size=int(cfg_data.batch_size),
        name=cfg_data.name,
        baked=baked,
        augmentations_active=bool(cfg_data.augmentations_train) and not use_db,
    )


def epoch_layout(total: int, batch_size: int, sub_batch: int, num_devices: int = 1,
                 dryrun: bool = False):
    """(num_blocks, chunks_per_block, sub_batch) with drop_last; the block is
    clamped to the dataset size so data.size-subset runs keep working."""
    if total >= num_devices:
        batch_size = min(batch_size, max(total // num_devices, 1))
    sub = min(sub_batch, batch_size)
    if batch_size % sub != 0:
        divisors = [d for d in range(sub, 0, -1) if batch_size % d == 0]
        sub = divisors[0]
    global_block = batch_size * num_devices
    num_blocks = total // global_block
    if num_blocks == 0:
        raise ValueError(
            f"Dataset of {total} samples cannot fill one block of {global_block} "
            f"({num_devices} devices x batch {batch_size}). Reduce data.batch_size.")
    if dryrun:
        num_blocks = 1
    return num_blocks, batch_size // sub, sub


def stream_plan(num_blocks: int, chunks: int, sub: int, num_devices: int, per_item_bytes: int,
                cfg_impl):
    """``(streamed, seg_blocks, epoch_bytes)`` for an epoch laid out
    ``(blocks, devices, chunks, sub)`` of ``per_item_bytes`` an item: above
    ``impl.hbm_epoch_max_bytes`` it stays in host memory and streams in
    segments of ``seg_blocks`` blocks (``impl.stream_segment_blocks``, or
    0 for as many as fit a quarter of the budget, at least one); else it is
    resident, one segment of every block. The JAX package's function, as it
    is."""
    epoch_bytes = num_blocks * num_devices * chunks * sub * per_item_bytes
    hbm_budget = int(cfg_impl.get("hbm_epoch_max_bytes", 8 << 30))
    if epoch_bytes <= hbm_budget:
        return False, num_blocks, epoch_bytes
    block_bytes = num_devices * chunks * sub * per_item_bytes
    seg_auto = max(1, (hbm_budget // 4) // max(block_bytes, 1))
    seg_cfg = int(cfg_impl.get("stream_segment_blocks", 0) or 0)
    return True, min(num_blocks, seg_cfg or seg_auto), epoch_bytes


def rank_rows(order, num_blocks: int, chunks: int, sub: int, num_devices: int = 1,
              rank: int = 0) -> np.ndarray:
    """The entries of ``order`` that rank ``rank`` trains on, in order:
    ``[:, rank]`` of its first ``num_blocks * num_devices * chunks * sub``
    laid out as ``(blocks, devices, chunks * sub)`` (:func:`layout_epoch`)."""
    per = chunks * sub
    head = np.asarray(order)[:num_blocks * num_devices * per]
    return head.reshape(num_blocks, num_devices, per)[:, rank].reshape(-1)


def layout_epoch(images, labels, num_blocks: int, chunks: int, sub: int, num_devices: int = 1):
    """Reshape arrays to (blocks, devices, chunks, sub, ...), order-preserving."""
    total = num_blocks * num_devices * chunks * sub
    images = images[:total].reshape(num_blocks, num_devices, chunks, sub, *images.shape[1:])
    labels = labels[:total].reshape(num_blocks, num_devices, chunks, sub)
    return images, labels


def epoch_order(seed, step: int, n: int, with_replacement: bool = False) -> np.ndarray:
    """The sample order of step ``step`` for ``hyp.shuffle=True``: a
    permutation of ``n`` (or ``n`` draws with replacement, for
    ``hyp.sample_with_replacement``) from numpy's ``default_rng(seed *
    1_000_003 + step)``, the JAX package's generator, so both draw the same
    order."""
    rng = np.random.default_rng((seed if seed is not None else 0) * 1_000_003 + step)
    if with_replacement:
        return rng.integers(0, n, n)
    return rng.permutation(n)
