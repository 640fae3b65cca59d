"""The port's stochastic modes, shuffled epochs and SAM against the JAX package's ``train()``.

Both sides run ResNet-18 (width 4) in float64 from the same weights and the
same synthetic data, without augmentation (threefry and Philox draws can
never match), as in ``tests/test_torch_training.py``: 3 steps over 32 images
in 4 blocks of 8, each block 2 chunks of 4, with evaluation after each step.
``hyp.warmup=0``, so every step updates. A shuffled epoch is drawn by numpy
from ``(seed, step)`` on both sides, so both read the same order. The JAX side
runs on a 1-device mesh with ``impl.block_grouping=1``, one ``train()`` a
case. Each case pays for a JAX compile, so the cases are spread over this
file (the SGD baseline), ``tests/test_torch_training_sam.py`` and
``tests/test_torch_training_switch.py``, which share
:func:`check_stochastic_case`.

Params, BN running stats and every ``stats`` entry agree to rtol 1e-8, as in
the full-batch tests: float64 with different summation orders keeps about
1e-13 relative per op, and 12 SGD updates (or 3 steps) of a 20-BN-layer net
amplify that well below 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import _epoch_order as jax_epoch_order
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle, epoch_order
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import train

RTOL = 1e-8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's side of a parity test is many tiny
    torch ops, which several test workers with a thread per core each slow
    down some tenfold. The files that share this module's setup import the
    fixture too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

BASE = [
    "model=resnet18", "model.width=4", "data.size=32",
    "data.path=/tmp/__torch_nodata__", "data.batch_size=8", "hyp.sub_batch=4",
    "hyp.steps=3", "hyp.warmup=0", "impl.validate_every_nth_step=1",
    "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    "seed=0", "name=torch_stochastic_parity",
]
CASES = {
    # the SGD baseline as its yaml has it: stochastic, shuffled, momentum
    "base_sgd": ["hyp=base_sgd"],
    "with-replacement": ["hyp=base_sgd", "hyp.sample_with_replacement=True"],
    # the stochastic body's own clip (2-norm of hyp.grad_clip) after
    # hyp=gradreg's regularizer with no pre-pass
    "clip-gradreg": ["hyp=base_sgd", "hyp.grad_clip=0.25", "hyp.grad_reg.block_strength=0.5"],
}


def _assert_trees_close(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_close(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-12,
                                       err_msg=f"{path}/{key}")


def check_stochastic_case(extra, config_dir, monkeypatch):
    """Train ``BASE + extra`` in both packages, compare the results and return
    the port's stats."""
    overrides = BASE + list(extra)
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        # float64 variables for the JAX train(), as in tests/test_torch_training.py
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(cfg.seed), bundle.pixels, bundle.channels,
            dtype=jnp.float64))
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        state, ref_stats = jax_train(model, bundle, mesh, cfg)
        ref_params = jax.device_get(state.params)
        ref_bn = jax.device_get(state.batch_stats)
        ref_ema = jax.device_get(state.ema_params)

    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0)
    np.testing.assert_array_equal(tbundle.train.images, bundle.train.images)
    for step in range(3):
        np.testing.assert_array_equal(
            epoch_order(tcfg.seed, step, 32, bool(tcfg.hyp.sample_with_replacement)),
            jax_epoch_order(cfg, step, 32))
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    load_jax_variables(tmodel, variables)
    tstate, stats = train(tmodel, tbundle, tcfg, device="cpu")

    assert tstate.step == 3
    ours = export_jax_variables(tmodel)
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], ref_bn, "batch_stats")
    if ref_ema is not None:
        _assert_trees_close(export_jax_variables(tstate.ema_model)["params"], ref_ema, "ema")

    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    assert all(lr > 0 for lr in stats["lr"])
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
    return stats


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_train_matches_jax(case, config_dir, monkeypatch):
    check_stochastic_case(CASES[case], config_dir, monkeypatch)
