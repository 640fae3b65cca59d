"""The training loop's model snapshots (``analysis.save_model_every_nth_step``)
against the JAX package's, on the CPU in float64.

One 2-step ``train()`` a case in each package, a snapshot after each step:
SGD with momentum, and with Nesterov momentum (whose update direction is
``g + momentum * buffer``). The JAX ``.msgpack`` files are read with flax;
params, batch stats, the pre-step gradients and the update directions of
the port's ``.pt`` files agree with them at 1e-10. One JAX run a case
serves every check (a module fixture).
"""

import collections

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import (export_jax_variables, load_jax_variables,
                                                 params_to_jax)
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import train

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-10
STEPS = (1, 2)
BASE = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
        "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
        "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
        "hyp.warmup=0", "seed=0", "data.size=32", "data.batch_size=16", "hyp.sub_batch=8",
        "hyp.steps=2", "analysis.save_model_every_nth_step=1", "name=snap"]
CASES = {"momentum": ["hyp.optim.nesterov=False"], "nesterov": ["hyp.optim.nesterov=True"]}

Run = collections.namedtuple("Run", "model ours ref")


@pytest.fixture(scope="module", params=list(CASES))
def run(request, config_dir, tmp_path_factory):
    """Both packages' snapshots of one case: ``Run(port model, {step:
    port payload}, {step: JAX payload})``."""
    overrides = BASE + CASES[request.param]
    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes, seed=0)
    variables = jax.tree.map(lambda a: a.astype(np.float64), export_jax_variables(tmodel))
    jax_dir, port_dir = (tmp_path_factory.mktemp(name) for name in ("jax", "port"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.chdir(jax_dir)
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        mp.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        jax_train(model, bundle, mesh, cfg)
        mp.chdir(port_dir)
        load_jax_variables(tmodel, variables)
        train(tmodel, tbundle, tcfg, device="cpu")
    torch.set_num_threads(threads)
    ref = {k: serialization.msgpack_restore(
        (jax_dir / f"snap_ResNet18_step_{k}.msgpack").read_bytes()) for k in STEPS}
    ours = {k: torch.load(port_dir / f"snap_ResNet18_step_{k}.pt", weights_only=True)
            for k in STEPS}
    return Run(tmodel, ours, ref)


def _close_trees(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _close_trees(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-13,
                                       err_msg=f"{path}/{key}")


def _variables(run, step):
    run.model.load_state_dict(run.ours[step]["model"])
    return export_jax_variables(run.model)


def _named_tree(run, named):
    return params_to_jax(run.model, [named[name] for name, _ in run.model.named_parameters()])


@pytest.mark.parametrize("step", STEPS)
def test_params(run, step):
    _close_trees(_variables(run, step)["params"], run.ref[step]["params"], "params")


@pytest.mark.parametrize("step", STEPS)
def test_batch_stats(run, step):
    ours = _variables(run, step)["batch_stats"]
    assert ours
    _close_trees(ours, run.ref[step]["batch_stats"], "batch_stats")


@pytest.mark.parametrize("step", STEPS)
def test_pre_step_gradients(run, step):
    _close_trees(_named_tree(run, run.ours[step]["grads"]), run.ref[step]["grads"], "grads")


@pytest.mark.parametrize("step", STEPS)
def test_update_directions(run, step):
    ours = _named_tree(run, run.ours[step]["update_directions"])
    _close_trees(ours, run.ref[step]["update_directions"], "update_directions")
    # the update direction is no copy of the gradient
    grads = _named_tree(run, run.ours[step]["grads"])
    assert not np.allclose(ours["fc"]["kernel"], grads["fc"]["kernel"])


def test_payload_and_model_cfg(run):
    for step in STEPS:
        payload = run.ours[step]
        assert set(payload) == {"model", "grads", "update_directions", "model_cfg"}
        assert payload["model_cfg"] == {k: v for k, v in run.ref[step]["model_cfg"].items()}
        names = [name for name, _ in run.model.named_parameters()]
        assert list(payload["grads"]) == names == list(payload["update_directions"])
        assert all(t.device.type == "cpu" and t.dtype == torch.float64
                   for t in payload["grads"].values())
