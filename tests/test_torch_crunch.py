"""The port's loss surface (``fullbatchtraining_tpu_torch/visualization/crunch.py``)
against the JAX package's ``crunch``, on the CPU.

Both run a ResNet-18 at ``model.width=4`` (so the eval-mode BatchNorm,
``ops.bn.BNEval``, is on the path) in float64 on the same weights
(``convert.export_jax_variables``) and the same directions: the JAX
crunch's, read from its store and handed to the port's store
(``convert.params_from_jax``). The JAX scan's float32 carry cannot take the
float64 losses of an x64 run (a carry dtype mismatch), so the test widens
the carry it is handed to float64; the port keeps the float32 carry, hence
1e-6 relative on ``train_loss`` and ``full_loss``. ``train_acc`` is a count
and agrees exactly.

Also: the streamed surface is the resident one bit for bit, a second call
computes nothing and leaves the results file as it was, the
``acc_strength`` and other-state refusals, and two gloo ranks of the CLI
against one process (1e-6).
"""

import sys

import jax
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import make_train_functions
from fullbatchtraining_tpu.visualization import crunch as jax_crunch
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, params_from_jax
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.parallel import streaming
from fullbatchtraining_tpu_torch.training.training import Trainer, TrainState
from fullbatchtraining_tpu_torch.visualization import crunch, database

from test_torch_distributed import free_port, spawn_ranks
from test_torch_families import randomize_
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

# the module, which the package's ``crunch`` function shadows as an attribute
crunch_module = sys.modules[crunch.__module__]
RTOL = 1e-6
FIELDS = ("train_loss", "train_acc", "full_loss")
# 4 blocks of 8 images, float64, weight decay from hyp=fb1
BASE = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
        "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
        "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
        "hyp.warmup=0", "seed=0", "data.size=32", "data.batch_size=8", "hyp.sub_batch=8",
        "impl.checkpoint.name=surface"]
CASES = {
    "1d": ["viz=1d", "viz.coordinates.x.num=3", "viz.vmap_positions=2"],
    "2d": ["viz=2d", "viz.coordinates.x.num=3", "viz.coordinates.y.num=3",
           "viz.vmap_positions=4"],
    "block-strength": ["viz=1d", "viz.coordinates.x.num=3", "viz.vmap_positions=3",
                       "hyp.grad_reg.block_strength=0.5"],
}


def port_setup(overrides, cwd, config_dir, randomize=True):
    """``(trainer, state, cfg)`` of the port at the seeded weights (with
    random norm parameters and running stats), the store under ``cwd``."""
    cfg = load_config(config_dir, overrides=overrides)
    cfg.original_cwd = str(cwd)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
    if randomize:
        randomize_(model.to(torch.float64))
    trainer = Trainer(model, bundle, cfg, torch.device("cpu"))
    return trainer, TrainState(step=0, model=model, optimizer=None), cfg


def jax_surface(overrides, variables, cwd, config_dir, monkeypatch):
    """The JAX ``crunch`` on ``variables`` with its store under ``cwd``:
    ``(results, dx, dy)``, the directions as flax trees."""
    module = sys.modules[jax_crunch.__module__]
    put_global = module.put_global
    monkeypatch.setattr(module, "put_global", lambda array, sharding: put_global(
        array.astype(np.float64) if array.dtype == np.float32 else array, sharding))
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        cfg.original_cwd = str(cwd)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        fns = make_train_functions(model, bundle, mesh, cfg)
        state = fns.init_state(variables)
        store, _ = jax_crunch(model, bundle, mesh, cfg, fns, state)
        _, dx, dy = jax.device_get(store.load(state.params))
    return store.results(), dx, dy


@pytest.mark.parametrize("case", list(CASES))
def test_surface_matches_jax(case, config_dir, tmp_path, monkeypatch):
    overrides = BASE + CASES[case]
    trainer, state, cfg = port_setup(overrides, tmp_path / "port", config_dir)
    variables = export_jax_variables(trainer.model)
    ref, dx, dy = jax_surface(overrides, variables, tmp_path / "jax", config_dir, monkeypatch)

    store = database.SurfaceStore(database.surface_path(cfg.impl, cfg.viz, cfg.original_cwd))
    store.create(trainer.params, params_from_jax(trainer.model, dx),
                 params_from_jax(trainer.model, dy))
    store, positions = crunch(trainer, state)
    ours = store.results()

    assert len(positions) == {"1d": 3, "2d": 9, "block-strength": 3}[case]
    assert set(ours) == set(ref) == {store._key(p) for p in positions}
    for key in ref:
        assert ours[key]["train_acc"] == ref[key]["train_acc"], key
        for field in ("train_loss", "full_loss"):
            np.testing.assert_allclose(ours[key][field], ref[key][field], rtol=RTOL,
                                       err_msg=f"{key} {field}")
        if case == "block-strength":
            assert ours[key]["full_loss"] > ours[key]["train_loss"]


def test_streamed_surface_is_the_resident_one_bitwise(config_dir, tmp_path):
    """A budget below one block streams a segment a block; every value,
    the gradient-norm sums included, is the resident run's bit for bit."""
    runs = []
    for name, extra in (("resident", []), ("streamed", ["impl.hbm_epoch_max_bytes=1"])):
        trainer, state, _ = port_setup(BASE + CASES["block-strength"] + extra, tmp_path / name,
                                       config_dir)
        streaming.reset_counts()
        store, _ = crunch(trainer, state)
        runs.append((store.results(), streaming.counts["segments"]))
    (resident, none), (streamed, segments) = runs
    assert none == 0 and segments == 4   # one block a segment, once for the group
    assert resident.keys() == streamed.keys()
    for key in resident:
        assert all(resident[key][f] == streamed[key][f] for f in FIELDS), key


def test_second_call_computes_nothing(config_dir, tmp_path, monkeypatch):
    trainer, state, _ = port_setup(BASE + CASES["1d"], tmp_path, config_dir)
    store, positions = crunch(trainer, state)
    before = store.results_file.read_bytes()
    calls = []
    real = crunch_module.surface_sums
    monkeypatch.setattr(crunch_module, "surface_sums",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again, _ = crunch(trainer, state)
    assert not calls
    assert again.results_file.read_bytes() == before
    assert len(again.results()) == len(positions)


def test_refuses_acc_strength(config_dir, tmp_path):
    trainer, state, _ = port_setup(BASE + CASES["1d"] + ["hyp.grad_reg.block_strength=0.5",
                                                         "hyp.grad_reg.acc_strength=0.1"],
                                   tmp_path, config_dir)
    with pytest.raises(ValueError, match="acc_strength"):
        crunch(trainer, state)


def test_refuses_a_store_of_another_state(config_dir, tmp_path):
    trainer, state, _ = port_setup(BASE + CASES["1d"], tmp_path, config_dir)
    crunch(trainer, state)
    other, other_state, _ = port_setup(BASE + CASES["1d"], tmp_path, config_dir, randomize=False)
    with pytest.raises(ValueError, match="different model"):
        crunch(other, other_state)


def test_two_ranks_equal_one_process(tmp_path):
    """The CLI as two gloo ranks (rank 0 draws the directions and records,
    each rank sweeps its blocks, one all_reduce a group) against one
    process, float32: every row within 1e-6."""
    overrides = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
                 "data.size=32", "data.batch_size=8", "seed=0", "viz=1d",
                 "viz.coordinates.x.num=3", "viz.vmap_positions=2",
                 "hyp.grad_reg.block_strength=0.5", "viz.database_name=surface",
                 "+impl.device=cpu"]
    module = "fullbatchtraining_tpu_torch.crunch_loss_landscape"
    rows = {}
    for name, world in (("one", 1), ("two", 2)):
        cwd = tmp_path / name
        cwd.mkdir()
        port = free_port()
        dist = (["impl/setup=distributed", f"impl.setup.url=127.0.0.1:{port}",
                 f"impl.setup.world_size={world}"] if world > 1 else [])
        spawn_ranks(lambda r, cwd=cwd, dist=dist, world=world: [
            sys.executable, "-m", module, *overrides, *dist,
            *([f"impl.setup.rank={r}"] if world > 1 else []), f"base_dir={cwd / 'out'}"],
            cwd, world)
        store = database.SurfaceStore(cwd / "checkpoints" / "surface_biasbn_filter_losses")
        rows[name] = store.results()
        assert store.results_file.read_text().count('"claim"') == 3   # rank 0 alone claims
    assert rows["one"].keys() == rows["two"].keys() and len(rows["one"]) == 3
    for key, row in rows["one"].items():
        assert row["train_acc"] == rows["two"][key]["train_acc"], key
        for field in ("train_loss", "full_loss"):
            np.testing.assert_allclose(rows["two"][key][field], row[field], rtol=RTOL,
                                       err_msg=f"{key} {field}")
