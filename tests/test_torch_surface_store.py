"""The port's surface store, plots and LMDB import against the JAX package's.

* ``SurfaceStore``: claims, their TTL and results over claims (as
  ``tests/test_crunch.py`` checks the JAX store), torn results lines, the
  atomic ``.directions.pt`` sidecar (a torn one reads as no match), another
  architecture's snapshot, and the refusal of a results file along the JAX
  package's directions.
* ``load_surface`` of rows the JAX store wrote equals the JAX
  ``load_surface``; both plots draw.
* LMDB: the port's ``MdbFile`` on files of ``tests/test_lmdb_reader.py``'s
  writer gives the JAX reader's items and errors; ``import_dataset`` writes
  the JAX tool's files byte for byte, and the port's baked store opens them;
  ``import_surface`` gives the JAX tool's rows.
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.data.lmdb_reader import CorruptDatabaseError as JaxCorrupt
from fullbatchtraining_tpu.data.lmdb_reader import MdbFile as JaxMdbFile
from fullbatchtraining_tpu.visualization import database as jax_database
from fullbatchtraining_tpu_torch.data.baked import BakedDataset
from fullbatchtraining_tpu_torch.data.lmdb_reader import CorruptDatabaseError, MdbFile
from fullbatchtraining_tpu_torch.tools import lmdb_import
from fullbatchtraining_tpu_torch.visualization import (SurfaceStore, crunch, load_surface,
                                                       plot_1d_loss_err_row)
from fullbatchtraining_tpu_torch.visualization.plotting import plot_2d_contour
from tools import lmdb_import as jax_lmdb_import

from test_lmdb_reader import PSIZE, _reference_dataset_lmdb, write_mdb
from test_torch_crunch import port_setup
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

POSITIONS = [(0.0, 0.0), (0.5, 0.0), (1.0, 0.0)]


def test_claims_ttl_and_results(tmp_path):
    store = SurfaceStore(tmp_path / "shared")
    store.claim(POSITIONS[:1])
    assert store.pending(POSITIONS) == POSITIONS[1:]
    # a result shadows the claim
    store.record(POSITIONS[0], train_loss=1.0, train_acc=0.5, full_loss=1.1)
    assert store.results()["0.000000,0.000000"]["train_loss"] == 1.0
    store.claim(POSITIONS[:1])
    assert not store.results()["0.000000,0.000000"].get("claim")
    # a stale claim is retaken, a fresh one is not
    store.claim(POSITIONS[1:2])
    assert store.pending(POSITIONS[1:2], ttl=-1.0) == POSITIONS[1:2]
    assert store.pending(POSITIONS[1:2], ttl=3600.0) == []
    # a newer claim refreshes an older one
    rows = store.results_file.read_text().splitlines()
    old = json.loads(rows[-1])
    old["ts"] -= 100.0
    store.results_file.write_text("\n".join([*rows, json.dumps(old)]) + "\n")
    assert store.results()["0.500000,0.000000"]["ts"] > old["ts"]


def test_torn_results_line_is_skipped(tmp_path, caplog):
    store = SurfaceStore(tmp_path / "torn")
    store.record(POSITIONS[0], train_loss=1.0, train_acc=0.5, full_loss=1.1)
    with open(store.results_file, "a") as handle:
        handle.write('{"position": [0.5, 0.0], "train_lo\n')   # a row cut short
    store.record(POSITIONS[2], train_loss=3.0, train_acc=0.25, full_loss=3.3)
    assert set(store.results()) == {"0.000000,0.000000", "1.000000,0.000000"}
    assert "corrupt results line" in caplog.text
    assert store.pending(POSITIONS) == [POSITIONS[1]]


def test_sidecar_is_atomic_and_matches_bitwise(tmp_path):
    store = SurfaceStore(tmp_path / "s")
    params = [torch.ones(2, 2), torch.zeros(3)]
    store.create(params, params, params)
    assert store.meta_file.name == "s.directions.pt" and not list(tmp_path.glob("*.tmp"))
    loaded = store.verify_model(params)
    assert loaded is not None and all(torch.equal(a, b) for a, b in zip(loaded[1], params))
    # one ulp off, another dtype: not the stored state
    assert store.verify_model([torch.nextafter(params[0], torch.tensor(2.0)), params[1]]) is None
    assert store.verify_model([params[0].double(), params[1]]) is None
    # a torn sidecar reads as no match, not a traceback
    store.meta_file.write_bytes(store.meta_file.read_bytes()[:40])
    assert store.verify_model(params) is None


def test_snapshot_of_another_architecture_does_not_match(tmp_path):
    store = SurfaceStore(tmp_path / "s")
    small = [torch.ones(2, 2)]
    store.create(small, small, small)
    assert store.verify_model([torch.ones(2, 2), torch.zeros(3)]) is None   # another tree
    assert store.verify_model([torch.ones(4, 4)]) is None                   # another shape


def test_refuses_results_along_the_jax_directions(config_dir, tmp_path):
    """A results file beside the JAX package's ``.directions.msgpack`` and no
    port sidecar: the crunch raises, naming both files; with
    ``viz.rebuild_existing_database`` it starts afresh."""
    overrides = ["hyp=fb1", "model=linear", "data.path=/tmp/__torch_nodata__", "data.size=32",
                 "data.batch_size=8", "seed=0", "viz=1d", "viz.coordinates.x.num=3",
                 "impl.checkpoint.name=shared"]
    trainer, state, cfg = port_setup(overrides, tmp_path, config_dir, randomize=False)
    path = jax_database.surface_path(cfg.impl, cfg.viz, tmp_path)
    jax_store = jax_database.SurfaceStore(path)
    tree = {"w": jnp.ones((2, 2))}
    jax_store.create(tree, tree, tree)
    jax_store.record((-1.0, 0.0), train_loss=1.0, train_acc=0.5, full_loss=1.0)
    with pytest.raises(ValueError) as err:
        crunch(trainer, state)
    assert str(jax_store.results_file) in str(err.value)
    assert str(jax_store.meta_file) in str(err.value)
    cfg.viz.rebuild_existing_database = True
    store, positions = crunch(trainer, state)
    assert store.exists() and len(store.results()) == len(positions) == 3


def test_load_surface_of_jax_rows(tmp_path):
    jax_store = jax_database.SurfaceStore(tmp_path / "jax_rows")
    jax_store.record(POSITIONS[0], train_loss=1.5, train_acc=0.25, full_loss=1.75)
    jax_store.claim(POSITIONS[1:2])
    jax_store.record(POSITIONS[2], train_loss=2.5, train_acc=0.5)
    ours = load_surface(jax_store.path, POSITIONS)
    ref = jax_database.load_surface(jax_store.path, POSITIONS)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])
    assert np.isnan(ours["train_loss"][1]) and np.isnan(ours["full_loss"][2])
    assert SurfaceStore(jax_store.path).results() == jax_store.results()


def test_plots(tmp_path):
    xs = np.linspace(-1, 1, 3)
    one = SurfaceStore(tmp_path / "one")
    two = SurfaceStore(tmp_path / "two")
    positions_1d = [(float(x), 0.0) for x in xs]
    positions_2d = [(float(x), float(y)) for x in xs for y in xs]
    for i, position in enumerate(positions_1d):
        one.record(position, train_loss=1.0 + i, train_acc=0.1 * i, full_loss=2.0 + i)
    for i, position in enumerate(positions_2d):
        two.record(position, train_loss=1.0 + i, train_acc=0.05 * i, full_loss=2.0 + i)
    fig, landscape = plot_1d_loss_err_row(str(tmp_path), ["one"], ["surface"], xs, positions_1d)
    fig.savefig(tmp_path / "row.png")
    np.testing.assert_array_equal(landscape["train_loss"], [1.0, 2.0, 3.0])
    fig, landscape = plot_2d_contour(two.path, xs, xs)
    fig.savefig(tmp_path / "contour.png")
    np.testing.assert_array_equal(landscape["train_loss"], np.arange(1.0, 10.0))
    assert all((tmp_path / f).stat().st_size > 0 for f in ("row.png", "contour.png"))


def _lmdb_files(tmp_path):
    rng = np.random.default_rng(0)
    small = {b"alpha": b"1", b"beta": b"two", b"__len__": pickle.dumps(3)}
    tree = {f"{i}".encode(): rng.integers(0, 256, size=200, dtype=np.uint8).tobytes()
            for i in range(64)}
    tree[b"bigrow"] = rng.integers(0, 256, size=3 * 32 * 32, dtype=np.uint8).tobytes()
    tree[b"hugerow"] = rng.integers(0, 256, size=3 * PSIZE + 17, dtype=np.uint8).tobytes()
    files = {}
    for name, mapping in (("small", small), ("tree", tree), ("empty", {})):
        files[name] = tmp_path / f"{name}.lmdb"
        write_mdb(files[name], mapping)
    return files


def test_mdb_reader_gives_the_jax_readers_items(tmp_path):
    for name, file in _lmdb_files(tmp_path).items():
        with MdbFile(file) as ours, JaxMdbFile(file) as ref:
            assert list(ours.items()) == list(ref.items()), name
            assert len(ours) == len(ref) and ours.psize == ref.psize
            for key, value in ref.items():
                assert ours.get(key) == value
            assert ours.get(b"missing") is None
    bad = tmp_path / "bad.lmdb"
    bad.write_bytes(b"\0" * 8192)
    for reader, error in ((MdbFile, CorruptDatabaseError), (JaxMdbFile, JaxCorrupt)):
        with pytest.raises(error):
            reader(bad)


@pytest.mark.parametrize("layout", ["hwc", "chw-rounds"])
def test_import_dataset_writes_the_jax_tools_files(layout, tmp_path):
    rng = np.random.default_rng(1)
    if layout == "hwc":
        images = rng.integers(0, 256, size=(10, 8, 8, 3), dtype=np.uint8)
        name, kwargs = "CIFAR10_train_10_ToTensorHWC.lmdb", {"rounds": 1}
    else:
        images = rng.integers(0, 256, size=(6, 3, 8, 8), dtype=np.uint8)
        name, kwargs = "CIFAR10_train_3_ToTensorR2_CHW.lmdb", {"rounds": 2,
                                                               "channels_first": True}
    labels = rng.integers(0, 4, size=len(images))
    src = tmp_path / name
    _reference_dataset_lmdb(src, images, labels)
    lmdb_import.import_dataset(src, tmp_path / "ours", **kwargs)
    jax_lmdb_import.import_dataset(src, tmp_path / "ref", **kwargs)
    for file in ("images.npy", "labels.npy", "meta.json"):
        assert (tmp_path / "ours" / file).read_bytes() == (tmp_path / "ref" / file).read_bytes()
    store = BakedDataset(tmp_path / "ours")
    hwc = images if layout == "hwc" else images.transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(np.asarray(store.flat().images), hwc)
    np.testing.assert_array_equal(store.flat().labels, labels.astype(np.int32))
    assert store.rounds == kwargs["rounds"]


def test_import_surface_gives_the_jax_tools_rows(tmp_path):
    mapping = {pickle.dumps([pos]): pickle.dumps({"train_loss": 1.0 + i, "train_acc": 0.5,
                                                  "full_loss": 2.0 + i, "note": "x"})
               for i, pos in enumerate([(-1.0,), (0.0,), (1.0, 0.5)])}
    mapping[b"model_state_dict"] = pickle.dumps({"ignored": 0})
    mapping[pickle.dumps([(2.0,)])] = b"\x80not a pickle"
    src = tmp_path / "surface.lmdb"
    write_mdb(src, mapping)
    assert lmdb_import.import_surface(src, tmp_path / "ours") == 3
    assert jax_lmdb_import.import_surface(src, tmp_path / "ref") == 3
    ours = SurfaceStore(tmp_path / "ours")
    ref = jax_database.SurfaceStore(tmp_path / "ref")
    assert ours.results_file.read_bytes() == ref.results_file.read_bytes()
    assert ours.results() == ref.results() and len(ours.results()) == 3
