"""The baked N x store: ``rounds`` augmented epochs of the training set in
one memory-mapped file (``fullbatchtraining_tpu/data/baked.py``).

A store is a directory holding ``images.npy``, a uint8 array of shape
``(rounds, size, H, W, C)`` opened as a memmap, ``labels.npy`` of shape
``(rounds, size)`` and ``meta.json``, written last. Its directory name and
tag are the JAX package's (:func:`_db_dir`), so either package finds and
reuses a store the other baked. Options (``config/data/db/baked.yaml``):
``rounds``, ``first_round_clean`` (round 0 is the raw data),
``shuffle_while_writing`` (each round in its own order),
``rebuild_existing_database`` and ``temporary_database``.

The bake follows the JAX package's ``_bake_jax``: the config's
augmentations apply in config order; the policy ones (RandAugment,
AutoAugment, AugMix) on the host through :mod:`.policy_augment`, each run
of the others on the device through :func:`.augmentations.make_augment_fn`.
A crop/flip store therefore matches the JAX package's in distribution
(torch's generator draws, not JAX's), and a policy-only store matches it
byte for byte. With several ranks, rank 0 bakes and every rank waits at a
barrier, then reads the store: ``data.db.path`` must be a filesystem the
ranks share.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import logging
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..parallel import World, barrier, broadcast, current_world
from ..utils import resolve_device
from .augmentations import POLICY_KEYS, augmented_hw, make_augment_fn
from .datasets import ArrayDataset

log = logging.getLogger(__name__)

_BAKE_BATCH = 1024


def _db_dir(cfg_db, cfg_data, size: int, aug_cfg, tmp_token=None) -> Path:
    """The store's directory: ``<path>/<name>_<size>_rounds<N>_<tag>``, the
    tag a sha1 of every config value that changes the baked bytes (the
    ordered aug list, ``clean``, ``shuffle``, the version ``"v": 3`` and,
    with a policy key, the policy geometry). The run seed and the bake
    engine are not keyed, as in the JAX package. A temporary store gets the
    suffix ``_tmp<pid>``, so the exit cleanup removes only its own."""
    base = Path(os.path.expanduser(str(cfg_db.path)))
    spec = {"aug": [[k, v] for k, v in dict(aug_cfg or {}).items()],
            "clean": bool(cfg_db.first_round_clean),
            "shuffle": bool(cfg_db.shuffle_while_writing),
            "v": 3}
    if any(k in POLICY_KEYS for k in dict(aug_cfg or {})):
        # fill color and translate_const come from the data config
        spec["policy_geom"] = [cfg_data.get("pixels"), cfg_data.get("mean")]
    spec = json.dumps(spec, sort_keys=True, default=str)
    tag = hashlib.sha1(spec.encode()).hexdigest()[:8]
    name = f"{cfg_data.name}_{size}_rounds{cfg_db.rounds}_{tag}"
    if cfg_db.get("temporary_database", False):
        name += f"_tmp{tmp_token if tmp_token is not None else os.getpid()}"
    return base / name


def bake_dataset(train: ArrayDataset, cfg_data, cfg_db, seed: int = 0,
                 device="cuda", world: World | None = None) -> Path:
    """Bake the store for ``train`` unless it exists (or rebuild it with
    ``rebuild_existing_database``); returns its directory. The non-policy
    augmentations run on ``device``. A file lock keeps two jobs from
    writing one store; the second finds ``meta.json`` and reuses it.

    With several ranks in ``world`` (the default process group's by
    default), rank 0 bakes and every rank waits at a barrier; a temporary
    store takes rank 0's pid as its suffix on every rank. A rank that finds
    no ``meta.json`` after the barrier raises."""
    world = world if world is not None else current_world()
    if world.size == 1:
        return _bake_locked(train, cfg_data, cfg_db, seed, device)
    token = (broadcast(world, os.getpid()) if cfg_db.get("temporary_database", False)
             else None)
    out_dir = _db_dir(cfg_db, cfg_data, len(train), cfg_db.augmentations_train, token)
    if world.rank == 0:
        _bake_locked(train, cfg_data, cfg_db, seed, device, token)
    barrier(world)
    if not (out_dir / "meta.json").exists():
        raise RuntimeError(f"baked store {out_dir} is missing on rank {world.rank} after rank "
                           "0's bake: data.db.path must be a filesystem every rank shares")
    return out_dir


def _bake_locked(train: ArrayDataset, cfg_data, cfg_db, seed: int, device,
                 tmp_token=None) -> Path:
    rounds = int(cfg_db.rounds)
    # an explicit null means a clean replicated store, not the data group's
    # augmentations
    aug_cfg = cfg_db.augmentations_train
    out_dir = _db_dir(cfg_db, cfg_data, len(train), aug_cfg, tmp_token)
    meta_file = out_dir / "meta.json"
    if meta_file.exists() and not cfg_db.rebuild_existing_database:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".bake.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if meta_file.exists() and not cfg_db.rebuild_existing_database:
                return out_dir  # another job finished the bake while we waited
            meta_file.unlink(missing_ok=True)  # no stale marker mid-bake
            n, src_h, src_w, c = train.images.shape
            h, w = augmented_hw(aug_cfg, src_h, src_w)
            if cfg_db.first_round_clean and (h > src_h or w > src_w):
                raise ValueError(
                    f"first_round_clean cannot be satisfied for a size-increasing bake "
                    f"({src_h}x{src_w} -> {h}x{w}): the clean round has no pixels for the "
                    "larger store shape. Disable data.db.first_round_clean or drop the "
                    "upscaling transform.")
            images = np.lib.format.open_memmap(out_dir / "images.npy", mode="w+",
                                               dtype=np.uint8, shape=(rounds, n, h, w, c))
            labels = np.empty((rounds, n), np.int32)
            _bake_rounds(train, aug_cfg, cfg_db, seed, images, labels, cfg_data,
                         resolve_device(device))
            images.flush()
            np.save(out_dir / "labels.npy", labels)
            meta = {
                "name": cfg_data.name, "rounds": rounds, "size": n,
                "shape": [h, w, c], "classes": int(train.classes),
                "first_round_clean": bool(cfg_db.first_round_clean),
                "shuffle_while_writing": bool(cfg_db.shuffle_while_writing),
            }
            meta_file.write_text(json.dumps(meta))
            return out_dir
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _policy_seed(seed: int, r: int, start: int, si: int) -> int:
    """Seed of one (round, batch start, segment): SeedSequence mixing, so no
    two triples share a stream (a sum would collide whenever the set size is
    not a multiple of the batch)."""
    return int(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, r, start, si]).generate_state(1)[0])


def train_mean(train) -> tuple:
    """Cheap per-channel mean in [0, 1] for policy fill colors."""
    sample = train.images[:: max(len(train.images) // 256, 1)]
    return tuple((sample.reshape(-1, sample.shape[-1]).mean(0) / 255.0).tolist())


def _bake_rounds(train, aug_cfg, cfg_db, seed, images, labels, cfg_data, device):
    """Fill ``images`` and ``labels`` round by round, in batches of
    ``_BAKE_BATCH``. Consecutive non-policy keys form one device segment,
    each policy key a host segment; segment ``si`` of the batch at
    ``start`` of round ``r`` draws from ``_policy_seed(seed, r, start, si)``."""
    segments, pending = [], {}

    def flush():
        if pending:
            segments.append(("device", make_augment_fn(dict(pending))))
            pending.clear()

    for k, v in dict(aug_cfg or {}).items():
        if k in POLICY_KEYS:
            flush()
            segments.append(("policy", k, v))
        else:
            pending[k] = v
    flush()
    has_policy = any(seg[0] == "policy" for seg in segments)
    n = len(train.images)
    th, tw = images.shape[2], images.shape[3]
    rng = np.random.default_rng(seed)
    # policy fill color and translate_const come from the data config, not
    # from the stored image size
    fill_mean = (tuple(cfg_data.mean) if cfg_data.get("mean") is not None
                 else train_mean(train)) if has_policy else None
    policy_size = int(cfg_data.get("pixels") or train.images.shape[1])
    for r in range(images.shape[0]):
        order = rng.permutation(n) if cfg_db.shuffle_while_writing else np.arange(n)
        clean = r == 0 and bool(cfg_db.first_round_clean)
        for start in range(0, n, _BAKE_BATCH):
            idx = order[start:start + _BAKE_BATCH]
            batch = train.images[idx]
            if clean and batch.shape[1:3] != (th, tw):
                # a size-changing bake keeps its clean round as the center crop
                top, left = (batch.shape[1] - th) // 2, (batch.shape[2] - tw) // 2
                batch = batch[:, top:top + th, left:left + tw]
            if not clean:
                for si, seg in enumerate(segments):
                    if seg[0] == "policy":
                        from .policy_augment import apply_policy_batch

                        batch = apply_policy_batch(
                            _on_host(batch), seg[1], seg[2], fill_mean,
                            seed=_policy_seed(seed, r, start, si), img_size=policy_size)
                    else:
                        gen = torch.Generator(device=device).manual_seed(
                            _policy_seed(seed, r, start, si))
                        batch = seg[1](torch.as_tensor(batch, device=device), gen)
            images[r, start:start + len(idx)] = _on_host(batch)
            labels[r, start:start + len(idx)] = train.labels[idx]
        log.info("Baked augmentation round %d/%d", r + 1, images.shape[0])


def _on_host(batch):
    """A batch as a numpy array: a device segment leaves a tensor."""
    return batch.cpu().numpy() if torch.is_tensor(batch) else batch


class BakedDataset:
    """Memory-mapped view over the baked rounds."""

    def __init__(self, db_dir: Path):
        self.dir = Path(db_dir)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        self.images = np.load(self.dir / "images.npy", mmap_mode="r")
        self.labels = np.load(self.dir / "labels.npy")
        self.rounds = self.meta["rounds"]
        self.classes = self.meta["classes"]

    def round(self, r: int) -> ArrayDataset:
        """Round ``r % rounds``: the set that a semi-stochastic step reads."""
        r = int(r) % self.rounds
        return ArrayDataset(np.asarray(self.images[r]), self.labels[r], self.classes)

    def flat(self) -> ArrayDataset:
        """All rounds as one ``rounds * size`` set, the full-batch epoch; a
        lazy memmap view, so nothing is read before it is sliced."""
        n = self.meta["size"]
        imgs = self.images.reshape(self.rounds * n, *self.meta["shape"])
        return ArrayDataset(imgs, self.labels.reshape(-1), self.classes)

    def cleanup(self):
        shutil.rmtree(self.dir, ignore_errors=True)
