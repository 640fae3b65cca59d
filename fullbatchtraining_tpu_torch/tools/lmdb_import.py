"""Import the upstream project's LMDB files, with no ``lmdb`` dependency.

The upstream project keeps two kinds of single-file LMDB databases:

* datasets: ascii index keys to raw uint8 image rows, plus pickled
  ``__keys__``, ``__labels__``, ``__len__`` and ``__shape__``;
* loss surfaces: ``pickle.dumps([position])`` keys to pickled metric dicts,
  plus the ``model_state_dict``, ``x_direction`` and ``y_direction`` blobs.

This tool reads them with :mod:`..data.lmdb_reader` and writes this
package's stores: a baked-store directory (``images.npy``, ``labels.npy``,
``meta.json``; :class:`~..data.baked.BakedDataset` opens it) or the rows of
a loss surface's results file (:class:`~..visualization.database.SurfaceStore`).
Values are unpickled with the standard pickler, which runs code by design:
import only files you made yourself.

    python -m fullbatchtraining_tpu_torch.tools.lmdb_import dataset SRC.lmdb OUT_DIR \\
        [--rounds N] [--channels-first|--channels-last] [--name X] [--classes K]
    python -m fullbatchtraining_tpu_torch.tools.lmdb_import surface SRC.lmdb OUT_STORE_PATH

``--rounds``: the upstream store writes ``rounds`` augmented epochs as one
flat key range; pass its ``data.db.rounds`` to get the ``(rounds, n, H, W,
C)`` layout back.
"""

import argparse
import json
import pickle
import sys
from pathlib import Path

import numpy as np

from ..data.lmdb_reader import MdbFile


def import_dataset(src, out_dir, rounds=1, channels_first=None, name=None,
                   classes=None) -> Path:
    """A dataset LMDB as a baked-store directory ``out_dir``."""
    src, out_dir = Path(src), Path(out_dir)
    with MdbFile(src) as db:
        meta_blobs = {k: db.get(k.encode()) for k in
                      ("__len__", "__keys__", "__labels__", "__shape__")}
        missing = [k for k, v in meta_blobs.items() if v is None]
        if missing:
            raise ValueError(f"{src}: not a dataset LMDB of the upstream project (missing "
                             f"{missing})")
        length = int(pickle.loads(meta_blobs["__len__"]))
        keys = pickle.loads(meta_blobs["__keys__"])
        labels = np.asarray(pickle.loads(meta_blobs["__labels__"]), dtype=np.int32)
        shape = [int(s) for s in pickle.loads(meta_blobs["__shape__"])]
        if channels_first is None:
            # the upstream file name says the layout (_CHW or HWC); else a
            # shape that starts with 1 or 3 channels is CHW
            channels_first = ("_CHW" in src.name if ("_CHW" in src.name or "HWC" in src.name)
                              else shape[0] in (1, 3))
        if length % rounds:
            raise ValueError(f"{length} entries do not split into {rounds} rounds")
        n = length // rounds
        h, w, c = ((shape[1], shape[2], shape[0]) if channels_first
                   else (shape[0], shape[1], shape[2]))

        out_dir.mkdir(parents=True, exist_ok=True)
        images = np.lib.format.open_memmap(out_dir / "images.npy", mode="w+", dtype=np.uint8,
                                           shape=(rounds, n, h, w, c))
        for i, key in enumerate(keys):
            raw = db.get(key if isinstance(key, bytes) else str(key).encode())
            if raw is None:
                raise ValueError(f"{src}: key {key!r} listed in __keys__ but absent")
            row = np.frombuffer(raw, np.uint8).reshape(shape)
            if channels_first:
                row = row.transpose(1, 2, 0)
            images[i // n, i % n] = row
        images.flush()
        np.save(out_dir / "labels.npy", labels.reshape(rounds, n))
        meta = {
            "name": name or src.name.split("_")[0],
            "rounds": int(rounds), "size": int(n), "shape": [h, w, c],
            "classes": int(classes if classes is not None else labels.max() + 1),
            "first_round_clean": "_first_clean" in src.name,
            "shuffle_while_writing": "_shuffled" in src.name,
            "imported_from": str(src),
        }
        (out_dir / "meta.json").write_text(json.dumps(meta))
    return out_dir


def import_surface(src, out_store) -> int:
    """A surface LMDB's positions as result rows of the store at
    ``out_store``; returns how many. The direction and model blobs are
    skipped; a position whose value does not decode is reported and
    dropped."""
    from ..visualization.database import SurfaceStore

    store = SurfaceStore(Path(out_store))
    store.results_file.parent.mkdir(parents=True, exist_ok=True)
    count = dropped = 0
    with MdbFile(Path(src)) as db:
        for key, value in db.items():
            try:
                parsed = pickle.loads(key)
            except Exception:
                continue  # model_state_dict, x_direction, y_direction
            if not (isinstance(parsed, list) and len(parsed) == 1):
                continue
            pos = np.atleast_1d(np.asarray(parsed[0], dtype=float))
            position = (float(pos[0]), float(pos[1]) if pos.size > 1 else 0.0)
            try:
                payload = pickle.loads(value)
            except Exception:
                print(f"WARNING: dropping position {position}: undecodable payload "
                      "(truncated or corrupt database?)", file=sys.stderr)
                dropped += 1
                continue
            if not isinstance(payload, dict):
                print(f"WARNING: dropping position {position}: payload is "
                      f"{type(payload).__name__}, expected dict", file=sys.stderr)
                dropped += 1
                continue
            values = {}
            for k, v in payload.items():
                try:
                    values[str(k)] = float(v)
                except (TypeError, ValueError):
                    pass
            store.record(position, **values)
            count += 1
    if dropped:
        print(f"WARNING: {dropped} position(s) dropped - the imported surface is INCOMPLETE",
              file=sys.stderr)
    return count


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    d = sub.add_parser("dataset")
    d.add_argument("src")
    d.add_argument("out_dir")
    d.add_argument("--rounds", type=int, default=1)
    layout = d.add_mutually_exclusive_group()
    layout.add_argument("--channels-first", dest="cf", action="store_true", default=None)
    layout.add_argument("--channels-last", dest="cf", action="store_false")
    d.add_argument("--name")
    d.add_argument("--classes", type=int)
    s = sub.add_parser("surface")
    s.add_argument("src")
    s.add_argument("out_store")
    args = ap.parse_args()
    if args.mode == "dataset":
        out = import_dataset(args.src, args.out_dir, rounds=args.rounds, channels_first=args.cf,
                             name=args.name, classes=args.classes)
        print(f"imported dataset store: {out}")
    else:
        n = import_surface(args.src, args.out_store)
        print(f"imported {n} surface positions into {args.out_store}")


if __name__ == "__main__":
    main()
