"""The port's per-step optimizer zoo against the JAX package's update
functions, with no model compile.

A width-4 ResNet-18 in float64 gives both sides the same params
(``convert.export_jax_variables``); 6 steps of gradients drawn by numpy from
a seed, each output unit at its own scale (10^-5 to 1, so that AGC clips some
units and not others) and each step at its own size (so that adaptive
clipping arms and fires), go through the JAX ``optim_interface``'s update
(``torch_adamw``, ``sgd_agc``, ``adaptive_clipped_sgd``, ``fista``,
``wrap_lars``) and through the port's optimizers. The fc bias gets a zero
gradient, the LARS guard's case. Params and optimizer state agree to rtol
1e-12 (float64, the same formulas with different summation orders), each
element relative to itself or to its leaf's largest magnitude, and each
state survives a round trip through ``convert.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.training import optimizers as joptim
from fullbatchtraining_tpu.training.opt import agc as jagc
from fullbatchtraining_tpu_torch.config import load_config as port_load_config
from fullbatchtraining_tpu_torch.convert import (export_jax_opt_state, export_jax_variables,
                                                 load_jax_opt_state, params_from_jax,
                                                 params_to_jax)
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import optimizers
from fullbatchtraining_tpu_torch.training.opt.agc import SGDAGC

RTOL = 1e-12
LRS = [0.1, 0.05, 0.2, 0.01, 0.1, 0.3]
STEP_SIZES = [1.0, 3.0, 0.5, 4.0, 1.0, 5.0]

CASES = {
    "adamw": ["hyp/optim=adam"],
    "adamw-amsgrad": ["hyp/optim=adam", "hyp.optim.amsgrad=True"],
    "agc": ["hyp/optim=gd_agc"],
    "agc-only-linear-wd": ["hyp/optim=gd_agc", "hyp.only_linear_layers_weight_decay=True"],
    "clip-1-l2": ["hyp/optim=gd_clip", "hyp.optim.interval=1", "hyp.optim.norm_type=2"],
    "clip-1-inf": ["hyp/optim=gd_clip", "hyp.optim.interval=1", "hyp.optim.norm_type=inf"],
    "clip-2-l2": ["hyp/optim=gd_clip", "hyp.optim.interval=2", "hyp.optim.norm_type=2"],
    "clip-2-inf": ["hyp/optim=gd_clip", "hyp.optim.interval=2", "hyp.optim.norm_type=inf"],
    "fista": ["hyp/optim=fista"],
    "lars-sgd": ["hyp/optim_modification=LARS"],
    "larc-sgd": ["hyp/optim_modification=LARC", "hyp.only_linear_layers_weight_decay=True"],
    "lars-adamw": ["hyp/optim=adam", "hyp/optim_modification=LARS"],
    "larc-adamw": ["hyp/optim=adam", "hyp/optim_modification=LARC"],
}


def _model():
    cfg = port_load_config("config", overrides=["model=resnet18", "model.width=4"])
    return construct_model(cfg.model, 3, 10, seed=0).to(torch.float64)


def _grads(params_tree, seed):
    """Per step a tree of gradients in the JAX layout."""
    rng = np.random.default_rng(seed)

    def draw(a, size):
        scale = 10.0 ** rng.uniform(-5, 0, size=a.shape[-1])
        return size * rng.standard_normal(a.shape) * scale

    steps = []
    for size in STEP_SIZES:
        tree = jax.tree.map(lambda a: draw(a, size), params_tree)
        tree["fc"]["bias"] = np.zeros_like(tree["fc"]["bias"])
        steps.append(tree)
    return steps


def _as_dict(state):
    if hasattr(state, "_asdict"):
        return {k: _as_dict(v) for k, v in state._asdict().items()}
    if isinstance(state, dict):
        return {k: _as_dict(v) for k, v in state.items()}
    return state if state is None else np.asarray(state)


def _sgd_counts_as_flags(state):
    """torch SGD keeps no count: an ``SGDState``'s count is compared as
    'updated yet' (``convert.export_jax_sgd_state`` writes 1 for it)."""
    if not isinstance(state, dict):
        return state
    state = {k: _sgd_counts_as_flags(v) for k, v in state.items()}
    if set(state) == {"momentum", "count"}:
        state["count"] = np.int32(min(int(state["count"]), 1))
    return state


def _assert_close(ours, ref, path=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
        for key in ref:
            _assert_close(ours[key], ref[key], f"{path}/{key}")
    elif ref is None:
        assert ours is None, path
    else:
        ref = np.asarray(ref)
        # elementwise rtol, plus rtol of the leaf's largest magnitude: an
        # element far below its leaf's scale keeps the leaf's absolute rounding
        atol = RTOL * float(np.max(np.abs(ref))) if ref.size else 0.0
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=RTOL, atol=atol, err_msg=path)


def _run_port(model, cfg, grads):
    opt = optimizers.make_optimizer(model, cfg.hyp)
    for tree, lr in zip(grads, LRS):
        for group in opt.param_groups:
            group["lr"] = lr
        for p, g in zip(model.parameters(), params_from_jax(model, tree)):
            p.grad = g
        opt.step()
    return opt


def _run_jax(params, cfg, grads):
    with jax.enable_x64(True):
        init, update, _, info = joptim.optim_interface(None, cfg.hyp)
        params = jax.tree.map(jnp.asarray, params)
        state = init(params)
        for tree, lr in zip(grads, LRS):
            params, state = update(jax.tree.map(jnp.asarray, tree), state, params, lr)
        return jax.device_get(params), _as_dict(jax.device_get(state)), info


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax(case, config_dir):
    overrides = ["hyp=fb1"] + CASES[case]
    cfg = load_config(config_dir, overrides=overrides)
    model = _model()
    start = export_jax_variables(model)["params"]
    grads = _grads(start, seed=sorted(CASES).index(case))

    ref_params, ref_state, info = _run_jax(start, cfg, grads)
    tcfg = port_load_config(config_dir, overrides=overrides)
    opt = _run_port(model, tcfg, grads)
    assert optimizers.optim_interface(model, tcfg.hyp)[1] == info

    _assert_close(export_jax_variables(model)["params"], ref_params, "params")
    state = export_jax_opt_state(model, opt)
    _assert_close(state, _sgd_counts_as_flags(ref_state), "opt_state")

    # the JAX state, loaded into a fresh port optimizer, exports as itself
    fresh = optimizers.make_optimizer(model, tcfg.hyp)
    load_jax_opt_state(model, fresh, ref_state)
    _assert_close(export_jax_opt_state(model, fresh), _sgd_counts_as_flags(ref_state),
                  "round trip")


@pytest.mark.parametrize("only_linear", [False, True])
def test_agc_exempt_and_weight_decay_sets_match_jax(only_linear, config_dir):
    """The unclipped params (the classifier) and the weight-decay groups are
    the JAX package's, matched on JAX paths."""
    cfg = port_load_config(config_dir, overrides=[
        "hyp=fb1", "hyp/optim=gd_agc", f"hyp.only_linear_layers_weight_decay={only_linear}"])
    model = _model()
    opt = optimizers.make_optimizer(model, cfg.hyp)
    assert isinstance(opt, SGDAGC)
    tree = export_jax_variables(model)["params"]
    paths, _ = jagc._path_trees(tree)
    exempt = {s for s in paths if s.strip("[]'\" ").startswith(("linear", "fc", "classifier"))}
    names = dict(zip(map(id, model.parameters()), optimizers.jax_param_paths(model)))
    assert {names[id(p)] for p, clip in opt.clipped if not clip} == exempt == {
        "['fc']['kernel']", "['fc']['bias']"}
    no_wd = {names[id(p)] for g in opt.param_groups if g["weight_decay"] == 0 for p in g["params"]}
    expected = {s for s in paths if jagc._AGC_WD_EXEMPT.search(s)} if only_linear else set()
    assert no_wd == expected
    if only_linear:
        assert no_wd and all("bias" in s or "gain" in s for s in no_wd)


def test_param_list_round_trip():
    model = _model()
    tree = export_jax_variables(model)["params"]
    tensors = params_from_jax(model, tree)
    for p, t in zip(model.parameters(), tensors):
        assert torch.equal(p.detach(), t)
    _assert_close(params_to_jax(model, tensors), tree)

