"""Checkpoint interop between the port and the JAX package: a JAX checkpoint
resumes in the port, and a port state written as a JAX checkpoint resumes in
the JAX ``train()`` (``tests/test_torch_checkpoint.py`` sets up the runs)."""

import shutil

import jax
import numpy as np
import torch
from flax import serialization

import fullbatchtraining_tpu.training.training as jax_training
from fullbatchtraining_tpu.config import load_config as jax_load_config
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
