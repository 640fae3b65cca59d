"""The port's ResNets against the flax models, from the same weights.

The variables go through ``convert.load_jax_variables``; train-mode logits
and updated running stats, then eval-mode logits, must agree in float64 to
rtol 1e-10 (summation order only). BN scales, biases and running stats are
drawn at random first, so zero-init-residual scales hide nothing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.models import construct_model as jax_construct_model
from fullbatchtraining_tpu.models import initialize_model
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.models import construct_model

RTOL = 1e-10
CASES = {
    "resnet18-C": ["model=resnet18"],
    "resnet18-B-standard-stem": ["model=resnet18", "model.downsample=B", "model.stem=standard"],
    "resnet20-B": ["model=resnet20"],
    "resnet20-A-efficient-stem": ["model=resnet20", "model.downsample=A",
                                  "model.stem=efficient"],
    "resnet50-C": ["model=resnet50"],
}


def _randomize(tree, rng, in_bn=False):
    """Random BN scales, biases and running stats; other leaves kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, in_bn=k == "bn")
        elif in_bn and k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape)
        elif in_bn:
            out[k] = rng.standard_normal(v.shape) * 0.5 + (1.0 if k == "scale" else 0.0)
        else:
            out[k] = v
    return out


def _cfg(config_dir, case):
    return load_config(config_dir, overrides=CASES[case] + ["model.width=4"])


def _models(config_dir, case):
    """(flax model, variables, port model holding them): the port's own
    initial weights, exported to the flax layout, BN leaves randomised, and
    loaded back through load_jax_variables."""
    cfg = _cfg(config_dir, case)
    tmodel = construct_model(cfg.model, 3, 10).to(torch.float64)
    rng = np.random.default_rng(0)
    variables = {c: _randomize(tree, rng) for c, tree in export_jax_variables(tmodel).items()}
    load_jax_variables(tmodel, variables)
    return (jax_construct_model(cfg.model, 3, 10), variables,
            tmodel.to(memory_format=torch.channels_last))


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_running_stats_match_flax(case, config_dir):
    jmodel, variables, tmodel = _models(config_dir, case)
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3))
    with jax.enable_x64(True):
        logits_ref, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        eval_ref = jmodel.apply(variables, jnp.asarray(x), train=False)
        new_stats = jax.device_get(upd["batch_stats"])

    eval_model = copy.deepcopy(tmodel).eval()
    with torch.no_grad():
        eval_logits = eval_model(torch.from_numpy(x))
    np.testing.assert_allclose(eval_logits.numpy(), eval_ref, rtol=RTOL, atol=1e-12)

    logits = tmodel.train()(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=RTOL, atol=1e-12)
    ours = export_jax_variables(tmodel)["batch_stats"]
    for path, ref in jax.tree_util.tree_leaves_with_path(new_stats):
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, ref, rtol=RTOL, atol=1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def test_export_round_trips(config_dir):
    """export_jax_variables gives the flax model's own tree (paths, shapes),
    and load -> export returns the loaded values bit for bit."""
    jmodel, variables, tmodel = _models(config_dir, "resnet18-C")
    with jax.enable_x64(True):
        abstract = jax.eval_shape(lambda: initialize_model(
            jmodel, jax.random.key(0), 32, 3, dtype=jnp.float64))
    out = export_jax_variables(tmodel)
    shapes = {c: jax.tree.map(lambda a: tuple(a.shape), abstract[c]) for c in out}
    assert shapes == {c: jax.tree.map(np.shape, out[c]) for c in out}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        node = out
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_is_strict(fault, config_dir):
    _, variables, tmodel = _models(config_dir, "resnet20-B")
    broken = copy.deepcopy(variables)
    if fault == "missing":
        del broken["params"]["fc"]["bias"]
    elif fault == "extra":
        broken["batch_stats"]["stem_bn1"]["bn"]["count"] = np.zeros(1)
    else:
        broken["params"]["stem_conv1"]["kernel"] = np.zeros((3, 3, 3, 5))
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(tmodel, broken)
