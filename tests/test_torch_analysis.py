"""The port's analysis (``fullbatchtraining_tpu_torch/analysis/``) against the
JAX package's, in float64 on the CPU.

* Welford ``init``/``update``/``merge``/``finalize``, counts 0 and 1
  included, at 1e-12.
* Random directions under every norm, fed the JAX raw draws (converted to
  OIHW), at 1e-12; the ``biasbn`` zeros; the flatness walk's NaN stop and its
  ``max_steps`` warning.
* ``analyze`` against the JAX ``analyze`` called directly (as
  ``tests/test_analysis.py`` calls it), on the same weights, running stats,
  momentum and data, for the ``linear`` model and a ResNet-18 at width 4:
  every ``analysis_*`` entry at 1e-10 (the linear model's flatness walk fed
  the JAX draws).
* The sweep streamed from the host, bitwise the resident one.
* The pre-step gradient pass moves nothing: ``analysis=limited`` trains to
  the same params and running stats as ``analysis=none``, bitwise.
* ``train()`` with ``analysis=full`` and ``hyp.stop_at_full_training_accuracy``
  against the JAX ``train()``, at 1e-8: both stop at the same step, before
  ``hyp.steps``, with the same entries; and two gloo ranks of the CLI
  against the JAX ``train()`` on a 2-device mesh, at 1e-8.
"""

import logging
import os
import subprocess
import sys
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.analysis import directions as jax_directions
from fullbatchtraining_tpu.analysis import welford as jax_welford
from fullbatchtraining_tpu.analysis.analysis import analyze as jax_analyze
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.optimizers import SGDState
from fullbatchtraining_tpu.training.training import make_train_functions
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.analysis import analysis, directions, welford
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import (export_jax_variables, flat_from_jax,
                                                 load_jax_sgd_state, load_jax_variables,
                                                 params_from_jax, params_to_jax)
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.parallel import streaming
from fullbatchtraining_tpu_torch.training import train
from fullbatchtraining_tpu_torch.training.training import TrainState, Trainer, make_optimizer

from test_torch_distributed import ROOT, read_table, run_cli
from test_torch_families import randomize_
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-12
ANALYZE_RTOL = 1e-10
TRAIN_RTOL = 1e-8
NORMS = ["filter", "layer", "entire", "weight", "dfilter", "dlayer"]

FP64 = ["hyp=fb1", "data.path=/tmp/__torch_nodata__", "data.augmentations_train=",
        "impl.dtype=float64", "impl.accumulation_dtype=float64", "impl.mixed_precision=False",
        "impl.block_grouping=1", "impl.eval_block_chunks=1", "hyp.warmup=0", "seed=0"]
FULL = ["analysis=full", "analysis.compute_gradient_SNR=True",
        "analysis.compute_gradient_noise_scale=True", "analysis.compute_flatness=True",
        "analysis.flatness_threshold=3.0", "analysis.flatness_step_size=0.5"]
MODELS = {
    # 4 blocks of 16 in chunks of 4: 16 per-batch norms
    "linear": ["model=linear", "data.size=64", "data.batch_size=16", "hyp.sub_batch=16",
               "analysis.internal_batch_size_chunks=4"],
    # 2 blocks of 16 in chunks of 8: 4 per-batch norms; no flatness walk
    # (the JAX package draws a direction op by op, which for ResNet-18's 62
    # tensors costs more than the rest of the case; the linear and train()
    # cases walk)
    "resnet18": ["model=resnet18", "model.width=4", "data.size=32", "data.batch_size=16",
                 "hyp.sub_batch=8", "analysis.internal_batch_size_chunks=2",
                 "analysis.compute_flatness=False"],
}


def _close(ours, ref, rtol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=1e-13,
                               err_msg=what)


# ---------------------------------------------------------------------------
# Welford
# ---------------------------------------------------------------------------

def _torch_state(vectors, dim):
    state = welford.welford_init(dim, torch.float64)
    for v in vectors:
        state = welford.welford_update(state, torch.from_numpy(v))
    return state


def _jax_state(vectors, dim):
    state = jax_welford.welford_init(dim, jnp.float64)
    for v in vectors:
        state = jax_welford.welford_update(state, jnp.asarray(v))
    return state


def _assert_states(ours, ref):
    for name, a, b in zip(welford.WelfordState._fields, ours, ref):
        assert a.dtype == (torch.float32 if name == "count" else torch.float64), name
        _close(a.numpy(), b, RTOL, name)


@pytest.mark.parametrize("split", [(0, 0), (0, 1), (1, 0), (1, 1), (0, 9), (1, 8), (4, 5)])
def test_welford_matches_jax(split):
    """Update, merge of two accumulations of ``split`` vectors, finalize:
    the guarded 0- and 1-vector states give zeros where they would divide by
    zero."""
    dim = 7
    vectors = np.random.default_rng(sum(split)).standard_normal((sum(split), dim))
    first, second = vectors[:split[0]], vectors[split[0]:]
    with jax.enable_x64(True):
        refs = [_jax_state(part, dim) for part in (first, second)]
        ref = jax.device_get(jax_welford.welford_merge(*refs))
        ref_final = jax.device_get(jax_welford.welford_finalize(ref))
        ref_first = jax.device_get(refs[0])
    ours = [_torch_state(part, dim) for part in (first, second)]
    _assert_states(ours[0], ref_first)
    merged = welford.welford_merge(*ours)
    _assert_states(merged, ref)
    final = welford.welford_finalize(merged)
    for name, a, b in zip(("mean", "var", "std", "norm", "sqnorm"), final, ref_final):
        _close(a.numpy(), b, RTOL, name)
        assert np.all(np.isfinite(a.numpy())), name
    if sum(split) < 2:
        assert not final[1].any()
    if split[0] and split[1]:
        # the merge of the parts is the whole sweep's state, but for the
        # merge's weights, ratios of the float32 counts (as in JAX)
        for a, b in zip(welford.welford_finalize(_torch_state(vectors, dim)), final):
            _close(a.numpy(), b.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# directions
# ---------------------------------------------------------------------------

@pytest.fixture()
def float64_draws(monkeypatch):
    """``jax.random.normal`` widened to float64 after its float32 draw, for
    the JAX directions: the filter norms of float32 draws differ in their
    last bits between the two packages' summation orders, those of the same
    draws in float64 only at 1e-16."""
    normal = jax.random.normal

    def widened(key, shape=(), dtype=jnp.float32):
        return normal(key, shape, dtype).astype(jnp.float64)

    monkeypatch.setattr(jax.random, "normal", widened)


def jax_raw_draws(tree, key):
    """The JAX ``create_random_direction``'s raw draws of ``tree`` from
    ``key``, as a tree of its layout."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, 2 * len(leaves))
    with jax.enable_x64(True):
        return jax.device_get(jax.tree.unflatten(treedef, [
            jax.random.normal(keys[i], leaf.shape, jnp.float32)
            for i, leaf in enumerate(leaves)]))


def feed_jax_draws(monkeypatch, model):
    """The port's random directions of ``model``'s params take the raw draws
    the JAX package takes from ``jax.random.key(seed)``, ``seed`` the
    generator's (the flatness walk seeds both with ``step + 777``)."""
    real = directions.create_random_direction

    def create(params, generator, *args, **kwargs):
        tree = params_to_jax(model, params)
        raw = params_from_jax(model, jax_raw_draws(tree, jax.random.key(
            generator.initial_seed())))
        return real(params, generator, *args, **kwargs, raw=raw)

    monkeypatch.setattr(directions, "create_random_direction", create)


def _small_model():
    """A conv (OIHW against HWIO), a BatchNorm and a dense layer (``(out, in)``
    against ``(in, out)``), float64, with random norm parameters."""
    from collections import OrderedDict

    from torch import nn

    from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d

    torch.manual_seed(0)
    return randomize_(nn.Sequential(OrderedDict(
        conv=nn.Conv2d(3, 6, 3), bn=BatchNorm2d(6), fc=nn.Linear(12, 5))).to(torch.float64))


@pytest.mark.parametrize("ignore", ["biasbn", ""])
@pytest.mark.parametrize("norm", NORMS)
def test_directions_match_jax(norm, ignore, float64_draws):
    """Every norm, fed the JAX raw draws: rank > 1 tensors at 1e-12; rank <=
    1 ones zero under ``biasbn``, else the norm's replacement (fresh draws,
    which match only in distribution: checked by what each keeps of the
    weights)."""
    model = _small_model()
    tree = export_jax_variables(model)["params"]
    key = jax.random.key(3)
    with jax.enable_x64(True):
        ref = jax.device_get(jax_directions.create_random_direction(
            jax.tree.map(jnp.asarray, tree), key, norm=norm, ignore=ignore))
    raw = params_from_jax(model, jax_raw_draws(tree, key))
    params = [p.detach() for p in model.parameters()]
    ours = directions.create_random_direction(params, torch.Generator().manual_seed(0), norm,
                                              ignore, raw=raw)
    ref = params_from_jax(model, ref)
    for d, r, w in zip(ours, ref, params):
        assert d.shape == w.shape and d.dtype == torch.float64
        if w.dim() > 1:
            _close(d.numpy(), r.numpy(), RTOL)
        elif ignore == "biasbn":
            assert not d.any()
        elif norm == "layer":   # ||fresh|| ||w|| / (||fresh|| + 1e-10)
            _close(d.norm().item(), w.norm().item(), 1e-9)
        elif norm != "entire":
            _close(d.abs().numpy(), w.abs().numpy(), RTOL)
    if norm == "filter":
        for d, w in zip(ours, params):
            if w.dim() > 1:
                _close(d.flatten(1).norm(dim=1).numpy(), w.flatten(1).norm(dim=1).numpy(), 1e-9)


def test_set_parameter_offset():
    base = [torch.zeros(3)]
    out = directions.set_parameter_offset(base, [torch.ones(3)], 0.5, [torch.full((3,), 2.0)],
                                          0.25)
    assert torch.equal(out[0], torch.ones(3))


def test_perturb2threshold_stops_on_nan_and_warns_at_max_steps(caplog):
    params = [torch.ones(4, 4)]
    calls = []

    def nan_after_two(p):
        calls.append(1)
        return torch.tensor(float("nan") if len(calls) > 2 else 0.0)

    value, counter = directions.perturb2threshold(params, nan_after_two,
                                                  torch.Generator().manual_seed(0),
                                                  step_size=0.1, threshold=1.0, max_steps=50)
    assert counter == 2 and len(calls) == 3 and value > 0
    with caplog.at_level(logging.WARNING):
        _, counter = directions.perturb2threshold(params, lambda p: torch.tensor(0.0),
                                                  torch.Generator().manual_seed(0),
                                                  max_steps=5)
    assert counter == 5 and "max_steps=5" in caplog.text


# ---------------------------------------------------------------------------
# analyze against the JAX analyze
# ---------------------------------------------------------------------------

def _port_setup(overrides, config_dir):
    """(trainer, state, variables, momentum tree) of the port, float64, with
    random norm parameters, running stats and SGD momentum."""
    cfg = load_config(config_dir, overrides=overrides)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
    randomize_(model.to(torch.float64))
    variables = export_jax_variables(model)
    trainer = Trainer(model, bundle, cfg, torch.device("cpu"))
    optimizer = make_optimizer(model, cfg.hyp)
    rng = np.random.default_rng(5)
    momentum = jax.tree.map(lambda a: rng.standard_normal(a.shape) * 0.01, variables["params"])
    load_jax_sgd_state(model, optimizer, {"momentum": momentum, "count": 1})
    return trainer, TrainState(step=0, model=model, optimizer=optimizer), variables, momentum


def _jax_analyze(overrides, config_dir, variables, momentum, devices=1):
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:devices]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        fns = make_train_functions(model, bundle, mesh, cfg)
        state = fns.init_state(variables)
        state = state.replace(opt_state=SGDState(
            momentum=jax.tree.map(jnp.asarray, momentum), count=jnp.ones((), jnp.int32)))
        stats = jax_analyze(model, bundle, mesh, cfg, fns, state, defaultdict(list))
        return bundle, dict(stats)


@pytest.mark.parametrize("model", list(MODELS))
def test_analyze_matches_jax(model, config_dir, monkeypatch, float64_draws):
    overrides = FP64 + FULL + MODELS[model]
    trainer, state, variables, momentum = _port_setup(overrides, config_dir)
    bundle, ref = _jax_analyze(overrides, config_dir, variables, momentum)
    np.testing.assert_array_equal(trainer.bundle.train.images, bundle.train.images)

    feed_jax_draws(monkeypatch, trainer.model)
    stats = analysis.analyze(trainer, state, defaultdict(list))

    assert set(stats) == set(ref)
    per_batch = sorted((k for k in ref if k.startswith("analysis_grad_norm_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
    assert len(per_batch) == {"linear": 16, "resnet18": 4}[model]
    assert {"analysis_param_norm", "analysis_grad_norm", "analysis_momentum_dist",
            "analysis_momentum_sim", "analysis_grad_SNR",
            "analysis_grad_noise_scale"} <= set(stats)
    for key in sorted(ref):
        assert len(stats[key]) == len(ref[key]) == 1, key
        _close(stats[key], ref[key], ANALYZE_RTOL, key)
    if model == "linear":
        assert 0 < stats["analysis_empirical_flatness"][0]


MOMENTUM_CASES = {"gd": [], "gd-agc": ["hyp/optim=gd_agc"],
                  "gd-lars": ["hyp/optim_modification=LARS"], "gd-clip": ["hyp/optim=gd_clip"],
                  "adam": ["hyp/optim=adam"], "fista": ["hyp/optim=fista"],
                  "lbfgs": ["hyp/optim=lbfgs"]}


@pytest.mark.parametrize("case", list(MOMENTUM_CASES))
def test_momentum_measures_where_jax_has_an_sgd_state(case, config_dir):
    """``analysis_momentum_*`` are recorded exactly for the optimizers whose
    JAX state is an ``SGDState`` with momentum: SGD and GD-AGC, under LARS
    too; not adaptive clipping, AdamW, FISTA or L-BFGS."""
    from fullbatchtraining_tpu.training.optimizers import optim_interface as jax_optim_interface

    overrides = (["model=linear", "data.path=/tmp/__torch_nodata__", "data.size=32",
                  "data.batch_size=16", "analysis=limited"] + MOMENTUM_CASES[case])
    cfg = jax_load_config(config_dir, overrides=overrides)
    init = jax_optim_interface(None, cfg.hyp)[0]
    jax_state = init({"w": jnp.zeros(3)})
    jax_records = isinstance(jax_state, SGDState) and jax_state.momentum is not None
    tcfg = load_config(config_dir, overrides=overrides)
    bundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    model = construct_model(tcfg.model, bundle.channels, bundle.classes, seed=0)
    trainer = Trainer(model, bundle, tcfg, torch.device("cpu"))
    state = TrainState(step=0, model=model, optimizer=make_optimizer(model, tcfg.hyp))
    stats = analysis.analyze(trainer, state, defaultdict(list))
    assert ("analysis_momentum_sim" in stats) == jax_records == (case in ("gd", "gd-agc",
                                                                          "gd-lars"))


def test_welford_mean_converts_from_jax(config_dir):
    """``convert.flat_from_jax`` carries a JAX ``ravel_pytree`` vector of the
    params (a Welford mean, say) to the port's flat order and layouts."""
    from jax.flatten_util import ravel_pytree

    trainer, _, variables, _ = _port_setup(FP64 + MODELS["resnet18"], config_dir)
    with jax.enable_x64(True):
        vec = np.asarray(ravel_pytree(variables["params"])[0])
    ours = torch.cat([p.detach().reshape(-1) for p in trainer.params])
    assert torch.equal(flat_from_jax(trainer.model, vec), ours)


def test_streamed_sweep_is_the_resident_one_bitwise(config_dir):
    runs = []
    for extra in ([], ["impl.hbm_epoch_max_bytes=1"]):
        trainer, state, _, _ = _port_setup(FP64 + FULL + MODELS["resnet18"] + extra
                                           + ["analysis.compute_flatness=False",
                                              "analysis.measure_grad_norm=False",
                                              "analysis.check_momentum=False"], config_dir)
        streaming.reset_counts()
        runs.append((analysis.analyze(trainer, state, defaultdict(list)),
                     streaming.counts["segments"]))
    (resident, none), (streamed, segments) = runs
    assert none == 0 and segments == 2   # one block a segment
    assert resident.keys() == streamed.keys()
    assert any(k.startswith("analysis_grad_norm_") for k in resident)
    for key in resident:
        assert resident[key] == streamed[key], key


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_pre_step_pass_moves_nothing(config_dir):
    """Two float32 steps with ``analysis=limited`` (a pre-step gradient pass
    before each) end with the params and running stats of two steps with
    ``analysis=none``, bitwise."""
    runs = []
    for mode in ("none", "limited"):
        cfg = load_config(config_dir, overrides=[
            "hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
            "data.size=32", "data.batch_size=16", "hyp.sub_batch=8", "hyp.steps=2",
            "hyp.warmup=0", "seed=0", f"analysis={mode}"])
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
        state, stats = train(model, bundle, cfg, device="cpu")
        runs.append((state.model.state_dict(), stats))
    (ref, ref_stats), (ours, stats) = runs
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert len(stats["analysis_grad_norm"]) == 2 and "analysis_grad_norm" not in ref_stats
    assert stats["train_loss"] == ref_stats["train_loss"]


# the linear model fits its 32 images at this rate in two steps: train_acc 1
# at step 3, its gradients still far from rounding
STOP = ["model=linear", "data.size=32", "data.batch_size=16", "hyp.sub_batch=8",
        "hyp.steps=6", "hyp.optim.lr=0.2", "hyp.stop_at_full_training_accuracy=1",
        "impl.validate_every_nth_step=1", "analysis.internal_batch_size_chunks=2",
        "name=analysis_parity"]


def test_train_with_analysis_matches_jax(config_dir, monkeypatch, float64_draws):
    overrides = FP64 + FULL + STOP
    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes, seed=0)
    variables = jax.tree.map(lambda a: a.astype(np.float64), export_jax_variables(tmodel))
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        jstate, ref = jax_train(model, bundle, mesh, cfg)
        ref_params = jax.device_get(jstate.params)
    load_jax_variables(tmodel, variables)
    feed_jax_draws(monkeypatch, tmodel)
    state, stats = train(tmodel, tbundle, tcfg, device="cpu")

    assert state.step == int(jstate.step) < tcfg.hyp.steps
    assert stats["train_acc"][-1] == 1.0
    assert set(stats) == set(ref)
    # analysis after the last step's validation and again at the stop
    assert len(stats["analysis_grad_SNR"]) == len(stats["train_loss"]) + 1
    for key in sorted(set(ref) - {"train_time"}):
        _close(stats[key], ref[key], TRAIN_RTOL, key)
    ours = export_jax_variables(state.model)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params):
        mine = ours
        for part in path:
            mine = mine[part.key]
        _close(mine, leaf, TRAIN_RTOL, jax.tree_util.keystr(path))


def test_two_ranks_match_jax_two_devices(config_dir, monkeypatch, tmp_path):
    """Two gloo ranks of the CLI (each sweeping its own rows, states merged in
    rank order) against the JAX ``train()`` on a 2-device mesh: rank 0's
    stats table, every ``analysis_*`` column included, at 1e-8; the
    per-batch norms in dataset order."""
    # the flatness walk's draws (Philox against threefry) cannot be fed to
    # the ranks' processes
    overrides = (FP64 + FULL + MODELS["linear"]
                 + ["analysis.compute_flatness=False", "hyp.steps=2",
                    "impl.validate_every_nth_step=1", "name=analysis_dist"])
    run_cli(overrides, tmp_path)
    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes, seed=tcfg.seed)
    variables = jax.tree.map(lambda a: a.astype(np.float64), export_jax_variables(tmodel))
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:2]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        _, ref = jax_train(model, bundle, mesh, cfg)
    stats = read_table(tmp_path / "out")
    keys = set(ref) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    assert sum(k.startswith("analysis_grad_norm_") for k in keys) == 16
    for key in sorted(keys):
        _close(stats[key], ref[key], TRAIN_RTOL, key)


CLI_KEYS = {
    "full": {"analysis_param_norm", "analysis_grad_norm", "analysis_momentum_dist",
             "analysis_momentum_sim", "analysis_grad_norm_0", "analysis_grad_mean_mean",
             "analysis_grad_mean_norm", "analysis_grad_std_mean", "analysis_grad_std_norm",
             "analysis_grad_SNR", "analysis_grad_noise_scale", "analysis_empirical_flatness"},
    "limited": {"analysis_param_norm", "analysis_grad_norm", "analysis_momentum_dist",
                "analysis_momentum_sim"},
    "final": {"analysis_param_norm", "analysis_grad_norm"},
}


@pytest.mark.parametrize("mode", list(CLI_KEYS))
def test_cli_writes_the_analysis_keys(mode, tmp_path):
    """``python -m fullbatchtraining_tpu_torch hyp=fb1 analysis=<mode>`` on the
    CPU (one step: a dryrun writes no table) writes each of the mode's
    ``analysis_*`` columns and no other."""
    extra = FULL[1:] if mode == "full" else []
    run = subprocess.run(
        [sys.executable, "-m", "fullbatchtraining_tpu_torch", "hyp=fb1", f"analysis={mode}",
         *extra, "model.width=4", "data.size=32", "data.batch_size=32", "hyp.steps=1",
         "data.path=/tmp/__torch_nodata__",
         "+impl.device=cpu", f"base_dir={tmp_path}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    table = read_table(tmp_path)
    assert {k for k in table if k.startswith("analysis_")} == CLI_KEYS[mode]
    assert all(np.isfinite(table[k]).all() for k in CLI_KEYS[mode])
