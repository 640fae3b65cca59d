"""The loss surface's store (``fullbatchtraining_tpu/visualization/database.py``).

A store is a path ``<original_cwd>/checkpoints/<name>_<ignore>_<norm>_losses``
with two files beside it:

* ``<store>.directions.pt``: ``torch.save`` of ``{"params", "x_direction",
  "y_direction"}``, each a list of CPU tensors in the model's
  ``parameters()`` order: the state the surface is taken around and its two
  directions. It is written to a pid-unique temporary file and renamed into
  place, so a killed writer never leaves a torn sidecar, and loads with
  ``torch.load(weights_only=True)``.
* ``<store>.results.jsonl``: one JSON row a line, the JAX package's format
  and name, so either package's :func:`load_surface`, plotting and LMDB
  surface import read the other's rows. A result row holds ``position``,
  ``train_loss``, ``train_acc`` and ``full_loss``; a claim row
  ``position``, ``"claim": true`` and its time ``ts``. Rows are keyed by
  the position written ``%.6f,%.6f``; a result shadows any claim, a newer
  claim an older one, and a torn line (a job killed mid-append) is skipped.

The JAX package keeps its directions in ``<store>.directions.msgpack`` (flax
msgpack). Its results are rows along its own directions, so a store whose
results file sits beside that sidecar with no port sidecar is refused
(:meth:`SurfaceStore.refuse_foreign`): finishing it here would mix two
surfaces.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)


def surface_path(cfg_impl, cfg_viz, original_cwd) -> Path:
    base_name = cfg_viz.database_name or cfg_impl.checkpoint.name or "debug_db_"
    full = os.path.splitext(str(base_name))[0] + f"_{cfg_viz.ignore_layers}_{cfg_viz.norm}_losses"
    return Path(original_cwd) / "checkpoints" / full


class SurfaceStore:
    """Directions and per-position results, with claims for jobs that share
    a surface and resume of an interrupted one."""

    def __init__(self, path: Path):
        self.path = Path(path)
        # name concatenation: with_suffix would cut a dotted store name
        self.meta_file = self.path.parent / (self.path.name + ".directions.pt")
        self.jax_meta_file = self.path.parent / (self.path.name + ".directions.msgpack")
        self.results_file = self.path.parent / (self.path.name + ".results.jsonl")

    def exists(self) -> bool:
        return self.meta_file.exists()

    def remove(self) -> None:
        self.meta_file.unlink(missing_ok=True)
        self.results_file.unlink(missing_ok=True)

    def refuse_foreign(self) -> None:
        """Raise where results lie along the JAX package's directions."""
        if not self.exists() and self.jax_meta_file.exists() and self.results_file.exists():
            raise ValueError(
                f"{self.results_file} holds a surface along the directions of "
                f"{self.jax_meta_file}, which the JAX package wrote; this package draws its "
                "own, so it would finish that surface along others. Crunch it with the JAX "
                "package, or set viz.rebuild_existing_database=True or another "
                "viz.database_name.")

    def create(self, params, x_direction, y_direction) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)

        def host(tensors):
            return [t.detach().cpu() for t in tensors]

        payload = {"params": host(params), "x_direction": host(x_direction),
                   "y_direction": host(y_direction)}
        tmp = self.meta_file.with_name(f"{self.meta_file.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        tmp.replace(self.meta_file)

    def load(self):
        """``(params, x_direction, y_direction)``, lists of CPU tensors."""
        payload = torch.load(self.meta_file, map_location="cpu", weights_only=True)
        return payload["params"], payload["x_direction"], payload["y_direction"]

    def verify_model(self, params):
        """The stored ``(params, dx, dy)`` where the stored params are
        ``params`` bit for bit (same count, shapes and dtypes), else None: a
        snapshot of another state or another architecture under the same
        name does not match."""
        try:
            loaded = self.load()
        except Exception as err:   # a torn, foreign or unpicklable payload
            log.warning("Stored surface snapshot at %s cannot be read (%s).", self.meta_file, err)
            return None
        stored = loaded[0]
        if len(stored) != len(params) or len(loaded[1]) != len(params):
            return None
        for a, b in zip(stored, params):
            b = b.detach().cpu()
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                return None
        return loaded

    @staticmethod
    def _key(position) -> str:
        return f"{float(position[0]):.6f},{float(position[1]):.6f}"

    def results(self) -> dict:
        out = {}
        if not self.results_file.exists():
            return out
        for line in self.results_file.read_text().splitlines():
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                log.warning("Skipping corrupt results line in %s", self.results_file.name)
                continue
            key = self._key(row["position"])
            existing = out.get(key)
            if row.get("claim"):
                # claims never shadow results; newer claims refresh older
                if existing is None or (existing.get("claim")
                                        and row.get("ts", 0) >= existing.get("ts", 0)):
                    out[key] = row
            else:
                out[key] = row
        return out

    def record(self, position, **values) -> None:
        row = {"position": [float(position[0]), float(position[1])], **values}
        with open(self.results_file, "a") as handle:
            handle.write(json.dumps(row) + "\n")

    def claim(self, positions) -> None:
        """Mark ``positions`` as in progress, so cooperating jobs skip them
        until the claim is older than their ``ttl``."""
        now = time.time()
        with open(self.results_file, "a") as handle:
            for position in positions:
                row = {"position": [float(position[0]), float(position[1])], "claim": True,
                       "ts": now}
                handle.write(json.dumps(row) + "\n")

    def pending(self, positions, ttl: float = 3600.0) -> list:
        """The positions with no result and no claim younger than ``ttl`` s."""
        now = time.time()
        done = self.results()
        out = []
        for position in positions:
            row = done.get(self._key(position))
            if row is None or (row.get("claim") and now - row.get("ts", 0) > ttl):
                out.append(position)
        return out


def load_surface(db_path, positions) -> dict:
    """``train_loss``, ``train_acc`` and ``full_loss`` at ``positions`` as
    float64 arrays, NaN where a position has no result."""
    store = SurfaceStore(Path(db_path))
    results = store.results()
    landscape = {key: np.full(len(positions), np.nan)
                 for key in ("train_loss", "train_acc", "full_loss")}
    for idx, position in enumerate(positions):
        row = results.get(store._key(position))
        if row is not None:
            for key in landscape:
                landscape[key][idx] = row.get(key, np.nan)
    return landscape
