"""The port's full-batch ``train()`` against the JAX package's, end to end.

Both sides run the ``hyp=fb1`` recipe on ResNet-18 (width 4) in float64 from
the same weights and the same synthetic data, without augmentation (threefry
and Philox draws can never match), for 3 steps with evaluation after each.
The JAX side runs on a 1-device mesh with ``impl.block_grouping=1``.
Params, BN running stats and every ``stats`` entry must agree to rtol 1e-8:
float64 with different summation orders (conv algorithms, reductions) keeps
about 1e-13 relative per op, and 3 steps of a 20-BN-layer net amplify that
well below 1e-8.
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
    "model=resnet18", "model.width=4", "hyp=fb1", "data.size=32",
    "data.path=/tmp/__torch_nodata__", "data.batch_size=16", "hyp.sub_batch=8",
    "hyp.steps=3", "hyp.warmup=1", "impl.validate_every_nth_step=1",
    "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    "seed=0", "name=torch_parity",
]
CASES = {
    "fb1": [],
    # per-chunk and full-gradient clipping, plus EMA evaluation, test-time
    # flips, the l2 norm bias, label smoothing and the bias/gain weight-decay
    # exemption (one case: each case costs a JAX step compile)
    "clipped": ["hyp.grad_clip=0.5", "hyp.batch_clip=0.9", "hyp.evaluate_ema=True",
                "hyp.eval_ema_momentum=0.5", "hyp.test_time_flips=True",
                "hyp.norm_bias.strength=0.001", "hyp.norm_bias.norm_type=2",
                "hyp.norm_bias.bias=20", "hyp.label_smoothing=0.1",
                "hyp.only_linear_layers_weight_decay=True"],
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
def test_train_matches_jax(case, config_dir, monkeypatch):
    overrides = BASE + CASES[case]
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        # The JAX train() initialises with initialize_model(model, key(seed),
        # pixels, channels) from a float32 dummy, whose float32 BN stats its
        # float64 scan carry then rejects: make those variables in float64
        # and hand them to train().
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(cfg.seed), bundle.pixels, bundle.channels,
            dtype=jnp.float64))
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        state, ref_stats = jax_train(model, bundle, mesh, cfg)
        ref_params = jax.device_get(state.params)
        ref_bn = jax.device_get(state.batch_stats)

    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0)
    np.testing.assert_array_equal(tbundle.train.images, bundle.train.images)
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes).to(torch.float64)
    load_jax_variables(tmodel, variables)
    tstate, stats = train(tmodel, tbundle, tcfg, device="cpu")

    assert tstate.step == 3
    ours = export_jax_variables(tmodel)
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], ref_bn, "batch_stats")

    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    if case == "clipped":
        assert 0 < sum(stats["clipped_batches"]) < 3 * 4, stats["clipped_batches"]
        assert {"preclip_gradnorm", "clipped_step"} <= keys
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)

