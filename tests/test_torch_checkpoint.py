"""Checkpoints of the port: resume, interop with the JAX package's, async saves.

The runs are ``hyp=base_sgd`` (stochastic, shuffled, Nesterov momentum) with
the EMA model on, ResNet-18 (width 4) in float64 on 32 synthetic images
without augmentation, as in ``tests/test_torch_training_stochastic.py``.
``hyp.scheduler=none``: a run cut short is a run with fewer ``hyp.steps``,
and a cosine schedule depends on ``hyp.steps``.

* A port run resumed from its own checkpoint equals the uninterrupted run
  bitwise: each step's order and generator depend on ``(seed, step)`` only.
* A JAX checkpoint, read with the JAX ``load_checkpoint``, resumes in the port,
  and a port state written as a JAX checkpoint resumes in the JAX
  ``train()``; each matches the other package's uninterrupted run at rtol
  1e-8 (float64, as the parity tests of ``train()``). These two each pay for
  a JAX compile and live in ``tests/test_torch_checkpoint_interop.py``,
  which shares this file's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
import fullbatchtraining_tpu.training.training as jax_training
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import (export_jax_sgd_state, export_jax_train_state,
                                                 export_jax_variables, load_jax_variables)
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import train
from fullbatchtraining_tpu_torch.training.utils import CheckpointWriter

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-8

BASE = [
    "model=resnet18", "model.width=4", "hyp=base_sgd", "data.size=32",
    "data.path=/tmp/__torch_nodata__", "data.batch_size=8", "hyp.sub_batch=4",
    "hyp.warmup=0", "hyp.scheduler=none", "hyp.evaluate_ema=True",
    "hyp.eval_ema_momentum=0.5", "impl.validate_every_nth_step=1",
    "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    "seed=0", "name=torch_checkpoint",
]


def _jax_variables(config_dir):
    """The JAX model and float64 variables, as in tests/test_torch_training.py."""
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=BASE)
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(cfg.seed), bundle.pixels, bundle.channels,
            dtype=jnp.float64))
    return model, bundle, variables


def _port_run(config_dir, tmp_path, variables, steps, name=None, extra=()):
    cfg = load_config(config_dir, overrides=BASE + [f"hyp.steps={steps}", *extra] + (
        [f"impl.checkpoint.name={name}"] if name else []))
    cfg.original_cwd = str(tmp_path)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = construct_model(cfg.model, bundle.channels, bundle.classes).to(torch.float64)
    load_jax_variables(model, variables)
    state, stats = train(model, bundle, cfg, device="cpu")
    return cfg, state, stats


def _jax_run(config_dir, tmp_path, monkeypatch, model, bundle, variables, steps, name=None):
    overrides = BASE + [f"hyp.steps={steps}"] + (
        [f"impl.checkpoint.name={name}", "impl.checkpoint.save_every_nth_step=1"] if name else [])
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        cfg.original_cwd = str(tmp_path)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        state, stats = jax_training.train(model, bundle, mesh, cfg)
        return cfg, jax.device_get(state), stats


def _assert_trees_close(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_close(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-12,
                                       err_msg=f"{path}/{key}")


def _assert_states_match_jax(state, ref):
    ours = export_jax_train_state(state)
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        _assert_trees_close(ours[key], getattr(ref, key), key)
    _assert_trees_close(ours["opt_state"]["momentum"], ref.opt_state.momentum, "momentum")
    assert int(ours["step"]) == int(ref.step)


def _assert_stats_close(ours, ref):
    keys = set(ref) - {"train_time"}
    assert keys == set(ours) - {"train_time"}
    for key in sorted(keys):
        np.testing.assert_allclose(ours[key], ref[key], rtol=RTOL, atol=1e-12, err_msg=key)


def _tensors(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    return {k: v for key, sub in items for k, v in _tensors(sub, f"{path}/{key}").items()}


def _assert_payloads_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key


def _payload(state):
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "ema_model": state.ema_model.state_dict()}


def test_resume_is_bitwise_equal(config_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    variables = _jax_variables(config_dir)[2]
    _, straight, stats_straight = _port_run(config_dir, tmp_path, variables, 3)
    _port_run(config_dir, tmp_path, variables, 1, name="resume.ckpt")
    assert (tmp_path / "checkpoints" / "resume.ckpt").exists()
    _, resumed, stats_resumed = _port_run(config_dir, tmp_path, variables, 3, name="resume.ckpt")
    assert resumed.step == straight.step == 3
    assert any("momentum_buffer" in s for s in resumed.optimizer.state.values())
    _assert_payloads_equal(_payload(resumed), _payload(straight))
    for key, values in stats_resumed.items():
        if key != "train_time":
            assert values == stats_straight[key][1:], key


def test_checkpoint_at_max_steps_raises(config_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    variables = _jax_variables(config_dir)[2]
    _port_run(config_dir, tmp_path, variables, 1, name="done.ckpt")
    with pytest.raises(ValueError, match="Maximum step size reached"):
        _port_run(config_dir, tmp_path, variables, 1, name="done.ckpt")


def test_async_save_matches_sync(config_dir, tmp_path, monkeypatch):
    """The async writer's file holds the state as it was at save(), though the
    params and momentum buffers change in place right after; and train()
    with async_save leaves its last checkpoint on disk when it returns."""
    monkeypatch.chdir(tmp_path)
    variables = _jax_variables(config_dir)[2]
    _, state, _ = _port_run(config_dir, tmp_path, variables, 1)
    CheckpointWriter(tmp_path / "sync.ckpt").save(state)
    writer = CheckpointWriter(tmp_path / "async.ckpt", async_save=True)
    writer.save(state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
            state.optimizer.state[p]["momentum_buffer"].mul_(2.0)
    writer.close()
    sync = torch.load(tmp_path / "sync.ckpt", weights_only=True)
    asynchronous = torch.load(tmp_path / "async.ckpt", weights_only=True)
    assert sync["step"] == asynchronous["step"] == 1
    _assert_payloads_equal(asynchronous, sync)
    assert not torch.equal(asynchronous["model"]["fc.weight"], state.model.fc.weight.detach())

    _, final, _ = _port_run(config_dir, tmp_path, variables, 2, name="async_train.ckpt",
                            extra=["impl.checkpoint.async_save=True"])
    saved = torch.load(tmp_path / "checkpoints" / "async_train.ckpt", weights_only=True)
    assert saved["step"] == 2
    _assert_payloads_equal({k: saved[k] for k in ("model", "optimizer", "ema_model")},
                           _payload(final))
    momentum = export_jax_sgd_state(final.model, final.optimizer)
    assert int(momentum["count"]) == 1
    assert export_jax_variables(final.model)["params"].keys() == momentum["momentum"].keys()


ZOO = {
    # full-batch L-BFGS: its curvature memory rides in the checkpoint's "driver"
    "lbfgs": ["hyp.train_stochastic=False", "hyp/optim=lbfgs"],
    # stochastic AdamW: exp_avg, exp_avg_sq and step in the optimizer's state
    "adamw": ["hyp/optim=adam"],
}


@pytest.mark.parametrize("case", list(ZOO))
def test_zoo_resume_is_bitwise_equal(case, config_dir, tmp_path, monkeypatch):
    """An L-BFGS run and an AdamW run resumed from a checkpoint equal the
    straight runs bitwise: params, running stats, EMA, optimizer state and
    the closure driver's state, and the stats of the steps after the resume."""
    monkeypatch.chdir(tmp_path)
    variables = _jax_variables(config_dir)[2]
    _, _, stats_straight = _port_run(config_dir, tmp_path, variables, 3, name="straight.ckpt",
                                     extra=ZOO[case])
    _port_run(config_dir, tmp_path, variables, 1, name="resume.ckpt", extra=ZOO[case])
    _, _, stats_resumed = _port_run(config_dir, tmp_path, variables, 3, name="resume.ckpt",
                                    extra=ZOO[case])
    straight, resumed = (torch.load(tmp_path / "checkpoints" / f"{name}.ckpt", weights_only=True)
                         for name in ("straight", "resume"))
    assert straight["step"] == resumed["step"] == 3
    _assert_payloads_equal(resumed, straight)
    if case == "lbfgs":
        assert straight["optimizer"] is None and len(straight["driver"]["s_hist"]) == 2
        scalars = {k: v for k, v in straight["driver"].items() if not isinstance(v, (list,
                                                                                   torch.Tensor))}
        assert scalars == {k: resumed["driver"][k] for k in scalars}
        assert scalars["n_iter"] == 3
    else:
        assert "driver" not in straight
        assert {float(s["step"]) for s in straight["optimizer"]["state"].values()} == {12.0}
    for key, values in stats_resumed.items():
        if key != "train_time":
            assert values == stats_straight[key][1:], key
