"""``hyp.grad_noise.additive`` and ``.multiplicative`` (``Trainer.modify_gradient``)
against the JAX package's, in distribution.

The port draws from torch's Philox generator, the JAX package from
threefry, so the two match in distribution only. Each package evaluates the
full-batch gradient of the ``linear`` model with and without noise from one
state at four steps (each step a fresh draw), and the noise is their
difference. Checked in both packages, over the 4 x 1,010 draws, each
moment within 5 of its standard errors:

* additive: mean 0 and standard deviation the configured scale, and the
  two packages' deviations within 4% of each other (2.5 standard errors of
  their difference);
* multiplicative: the noise over the gradient has mean 0 and the
  configured deviation, the same in the upper and the lower half of ``|g|``
  (the noise scales with ``|g|``), and zero gradients stay zero.
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
from fullbatchtraining_tpu.training.training import make_train_functions, stage_epoch
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, params_to_jax
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training.training import Trainer, TrainState

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

BASE = ["hyp=fb1", "model=linear", "data.path=/tmp/__torch_nodata__", "data.size=64",
        "data.batch_size=32", "data.augmentations_train=", "seed=0"]
STEPS = range(4)
SCALE = {"additive": 0.05, "multiplicative": 0.1}


def port_noise(config_dir, kind):
    """``(noise, clean gradient)``, each flat over the params and the steps."""
    def grads(extra):
        cfg = load_config(config_dir, overrides=BASE + extra)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
        trainer = Trainer(model, bundle, cfg, torch.device("cpu"))
        out = []
        for step in STEPS:
            state = TrainState(step=step, model=model, optimizer=None)
            g = trainer.pre_step_gradient(state, *trainer.stage(step))
            out.append(np.concatenate([np.reshape(a, -1) for a in
                                       jax.tree.leaves(params_to_jax(model, g))]))
        return np.concatenate(out), export_jax_variables(model)

    clean, variables = grads([])
    noisy, _ = grads([f"hyp.grad_noise.{kind}={SCALE[kind]}"])
    return noisy - clean, clean, variables


def jax_noise(config_dir, kind, variables):
    def grads(extra):
        cfg = jax_load_config(config_dir, overrides=BASE + extra)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        fns = make_train_functions(model, bundle, mesh, cfg)
        state = fns.init_state(jax.tree.map(jnp.asarray, variables))
        images, labels = stage_epoch(bundle, fns, mesh, cfg, 0, {})
        out = []
        for step in STEPS:
            g, _, _ = fns.gradient_eval(state.replace(step=jnp.asarray(step, jnp.int32)),
                                        images, labels)
            out.append(np.concatenate([np.asarray(a).reshape(-1)
                                       for a in jax.tree.leaves(jax.device_get(g))]))
        return np.concatenate(out)

    clean = grads([])
    return grads([f"hyp.grad_noise.{kind}={SCALE[kind]}"]) - clean, clean


def _standard(noise, scale):
    """``noise / scale`` has mean 0 and deviation 1, each within 5 of its
    standard errors (``1 / sqrt(n)``, ``1 / sqrt(2 n)``)."""
    z = noise / scale
    assert abs(z.mean()) < 5 / np.sqrt(z.size), z.mean()
    assert abs(z.std() - 1) < 5 / np.sqrt(2 * z.size), z.std()
    return z.std()


@pytest.mark.parametrize("kind", list(SCALE))
def test_noise_matches_jax_in_distribution(kind, config_dir):
    ours, clean, variables = port_noise(config_dir, kind)
    ref, ref_clean = jax_noise(config_dir, kind, variables)
    np.testing.assert_allclose(clean, ref_clean, rtol=1e-4, atol=1e-6)
    deviations = []
    for noise, g in ((ours, clean), (ref, ref_clean)):
        # a fresh draw a step
        per_step = noise.reshape(len(STEPS), -1)
        assert not np.allclose(per_step[0], per_step[1])
        if kind == "additive":
            deviations.append(_standard(noise, SCALE[kind]))
            continue
        assert np.all(noise[g == 0] == 0)
        nonzero = np.abs(g) > 1e-6
        ratio, magnitude = noise[nonzero] / g[nonzero], np.abs(g[nonzero])
        deviations.append(_standard(ratio, SCALE[kind]))
        upper = magnitude >= np.median(magnitude)
        for half in (upper, ~upper):
            _standard(ratio[half], SCALE[kind])
        # so the noise itself grows with |g|
        assert np.abs(noise[nonzero][upper]).mean() > 3 * np.abs(noise[nonzero][~upper]).mean()
    assert abs(deviations[0] / deviations[1] - 1) < 0.04, deviations
