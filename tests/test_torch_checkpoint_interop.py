"""Checkpoint interop between the port and the JAX package: a JAX checkpoint
resumes in the port, and a port state written as a JAX checkpoint resumes in
the JAX ``train()`` (``tests/test_torch_checkpoint.py`` sets up the runs); the
train states of the stat-free NFNet and of a DenseNet round-trip."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import fullbatchtraining_tpu.models.models as jax_models
import fullbatchtraining_tpu.training.training as jax_training
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.utils import load_checkpoint as jax_load_checkpoint
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_train_state, load_jax_train_state
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import TrainState, make_optimizer, train
from fullbatchtraining_tpu_torch.training.utils import CheckpointWriter
from test_torch_checkpoint import (BASE, _assert_states_match_jax, _assert_stats_close,
                                   _jax_run, _jax_variables, _port_run)
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)


def test_jax_checkpoint_resumes_in_the_port(config_dir, tmp_path, monkeypatch):
    """The JAX run saves every step; its step-1 file resumes in the port."""
    monkeypatch.chdir(tmp_path)
    model, bundle, variables = _jax_variables(config_dir)
    save = jax_training.save_checkpoint

    def save_and_keep(state, cfg, file=None):
        out = save(state, cfg, file)
        shutil.copy(out, tmp_path / f"jax_step{int(state.step)}.ckpt")
        return out

    monkeypatch.setattr(jax_training, "save_checkpoint", save_and_keep)
    jcfg, ref, ref_stats = _jax_run(config_dir, tmp_path, monkeypatch, model, bundle,
                                    variables, 3, name="jax.ckpt")
    with jax.enable_x64(True):
        restored, step = jax_load_checkpoint(ref, jcfg, max_steps=3,
                                             file=tmp_path / "jax_step1.ckpt")
        tree = serialization.to_state_dict(jax.device_get(restored))
    assert step == 1

    cfg = load_config(config_dir, overrides=BASE + ["hyp.steps=3",
                                                    "impl.checkpoint.name=from_jax.ckpt"])
    cfg.original_cwd = str(tmp_path)
    tbundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    tmodel = construct_model(cfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    state = TrainState(step=0, model=tmodel, optimizer=make_optimizer(tmodel, cfg.hyp),
                       ema_model=construct_model(cfg.model, tbundle.channels,
                                                 tbundle.classes).to(torch.float64))
    load_jax_train_state(state, tree)
    assert state.step == 1
    CheckpointWriter(tmp_path / "checkpoints" / "from_jax.ckpt").save(state)

    fresh = construct_model(cfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    resumed, stats = train(fresh, tbundle, cfg, device="cpu")
    assert resumed.step == 3
    _assert_states_match_jax(resumed, ref)
    _assert_stats_close(stats, {k: v[1:] for k, v in ref_stats.items()})


def test_port_state_resumes_in_jax(config_dir, tmp_path, monkeypatch):
    """The port's step-1 state, written as a JAX checkpoint, resumes in the
    JAX train() and ends where the port's 3-step run does."""
    monkeypatch.chdir(tmp_path)
    model, bundle, variables = _jax_variables(config_dir)
    _, first, _ = _port_run(config_dir, tmp_path, variables, 1)
    _, straight, stats_straight = _port_run(config_dir, tmp_path, variables, 3)

    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=BASE + ["hyp.steps=3"])
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        template = jax_training.make_train_functions(model, bundle, mesh, cfg).init_state(
            variables)
        exported = {**export_jax_train_state(first), "extra": None}
        (tmp_path / "checkpoints").mkdir(exist_ok=True)
        (tmp_path / "checkpoints" / "from_port.ckpt").write_bytes(
            serialization.to_bytes(serialization.from_state_dict(template, exported)))
    assert int(exported["opt_state"]["count"]) == 1
    _, ref, ref_stats = _jax_run(config_dir, tmp_path, monkeypatch, model, bundle, variables,
                                 3, name="from_port.ckpt")
    _assert_states_match_jax(straight, ref)
    _assert_stats_close({k: v[1:] for k, v in stats_straight.items()}, ref_stats)


@pytest.mark.parametrize("family", ["nfnet", "densenet"])
def test_family_train_state_round_trips(family, config_dir, monkeypatch):
    """A JAX ``TrainState`` of an NFNet (no ``batch_stats``) and of a DenseNet,
    after one step of momentum, loads into the port and exports back leaf
    for leaf unchanged."""
    import fullbatchtraining_tpu.models.nfnets as jax_nfnets
    import fullbatchtraining_tpu_torch.models.models as port_models
    from fullbatchtraining_tpu_torch.models import nfnets

    for module in (jax_nfnets, nfnets):
        monkeypatch.setattr(module, "nfnet_params", {"F0": {
            "width": [256], "depth": [1], "train_imsize": 32, "test_imsize": 32,
            "drop_rate": 0.2}})
    for module in (jax_models, port_models):
        monkeypatch.setattr(module, "densenet_depths_to_config", lambda depth: (4, (2, 2), 8))
    overrides = [o for o in BASE if not o.startswith("model")] + [
        {"nfnet": "model=nfn", "densenet": "model=densenet121"}[family]]
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(0), bundle.pixels, bundle.channels, dtype=jnp.float64))
        template = jax_training.make_train_functions(model, bundle, mesh, cfg).init_state(
            variables)
        tree = serialization.to_state_dict(jax.device_get(template))
    # a step's worth of momentum, so the optimizer's buffers are not all zero
    rng = np.random.default_rng(0)
    tree["opt_state"]["momentum"] = jax.tree.map(lambda a: rng.standard_normal(np.shape(a)),
                                                 tree["opt_state"]["momentum"])
    tree["opt_state"]["count"] = np.int32(1)
    tree["step"] = np.int32(1)
    assert bool(tree["batch_stats"]) == (family == "densenet")

    tcfg = load_config(config_dir, overrides=overrides)
    tmodel = construct_model(tcfg.model, 3, 10).to(torch.float64)
    state = TrainState(step=0, model=tmodel, optimizer=make_optimizer(tmodel, tcfg.hyp),
                       ema_model=construct_model(tcfg.model, 3, 10).to(torch.float64))
    load_jax_train_state(state, tree)
    out = export_jax_train_state(state)
    flat = dict(jax.tree_util.tree_leaves_with_path(out))
    ref = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert {jax.tree_util.keystr(k) for k in flat} == {jax.tree_util.keystr(k) for k in ref}
    for path, leaf in ref.items():
        np.testing.assert_array_equal(flat[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
