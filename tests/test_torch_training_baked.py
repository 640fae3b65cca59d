"""The port's ``train()`` on a baked store against the JAX package's.

Each case bakes one store with the JAX package (2 rounds of the 32 synthetic
images, crop+flip, each round in its own order) under ``tmp_path``; both
packages then train from that file, the port reusing it by name. Both run
ResNet-18 (width 4) in float64 from the same weights, with no augmentation
at train time (the store's are fixed), as in
``tests/test_torch_training_stochastic.py``: 3 steps with evaluation after
each, ``hyp.warmup=0``. The JAX side runs on a 1-device mesh with
``impl.block_grouping=1``.

* ``fb1-flat``: full batch over the flat 64-image store;
* ``sgd-semi``: the ``SGD_10_CIFAR`` line, ``hyp=base_sgd
  hyp.train_semi_stochastic=True``: steps read rounds 0, 1, 0, shuffled;
* ``fb1-semi``: ``hyp=fb1`` on one round a step, unshuffled.

Params, BN running stats and every ``stats`` entry agree to rtol 1e-8, as in
the other ``train()`` parity tests: float64 with different summation orders
keeps about 1e-13 relative per op, far below 1e-8 after 3 steps.
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
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import train

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-8

BASE = [
    "model=resnet18", "model.width=4", "data.size=32", "data.path=/tmp/__torch_nodata__",
    "data/db=baked", "data.db.rounds=2", "data.augmentations_train=",
    "data.batch_size=16", "hyp.sub_batch=8", "hyp.steps=3", "hyp.warmup=0",
    "impl.validate_every_nth_step=1", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    "seed=0", "name=torch_baked_parity",
]
CASES = {
    "fb1-flat": ["hyp=fb1"],
    "sgd-semi": ["hyp=base_sgd", "hyp.train_semi_stochastic=True", "data.batch_size=8",
                 "hyp.sub_batch=4"],
    "fb1-semi": ["hyp=fb1", "hyp.train_semi_stochastic=True"],
}


def _assert_trees_close(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_close(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-12,
                                       err_msg=f"{path}/{key}")


@pytest.mark.parametrize("case", list(CASES))
def test_baked_train_matches_jax(case, config_dir, tmp_path, monkeypatch):
    overrides = BASE + [f"data.db.path={tmp_path / 'db'}"] + CASES[case]
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

    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    assert tbundle.baked.dir == bundle.baked.dir and tbundle.size == 64
    assert not tbundle.augmentations_active
    np.testing.assert_array_equal(tbundle.train.images, np.asarray(bundle.train.images))
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    load_jax_variables(tmodel, variables)
    tstate, stats = train(tmodel, tbundle, tcfg, device="cpu")

    assert tstate.step == 3
    ours = export_jax_variables(tmodel)
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], ref_bn, "batch_stats")
    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    # a semi-stochastic step covers one round of 32 images, a flat one both
    chunks = sum(k.startswith("grad_norm_train_") for k in keys)
    assert chunks == {"fb1-flat": 8, "sgd-semi": 4, "fb1-semi": 4}[case]
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
