"""The other model families in the port's ``train()`` against the JAX package's.

Four cases, set up as ``tests/test_torch_training_stochastic.py`` sets up the
ResNet ones (float64, the same weights and synthetic data without
augmentation, a 1-device mesh with ``impl.block_grouping=1``, evaluation
after each step, torch on one intra-op thread), with the tables shrunk in
both packages by ``monkeypatch``:

* a 5-conv VGG with ``hyp=fb1``;
* a DenseNet of growth 4 and blocks (2, 2) with ``hyp=gradreg`` (forward
  differences);
* a 1-block NFNet of width 256 with ``hyp=fb1``: no running stats;
* ResNet-20 (width 4) under ``SequentialGhostNorm`` with ``hyp=base_sgd`` on
  blocks of 128 images: 2 virtual batches a forward.

Params, running stats and every ``stats`` entry agree to rtol 1e-8, as in
the ResNet cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
import fullbatchtraining_tpu.models.nfnets as jax_nfnets
import fullbatchtraining_tpu.models.vgg as jax_vgg
import fullbatchtraining_tpu_torch.models.models as port_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model, nfnets, vgg
from fullbatchtraining_tpu_torch.training import train

from test_torch_training_stochastic import _assert_trees_close
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-8
BASE = [
    "data.size=32", "data.path=/tmp/__torch_nodata__", "data.batch_size=8", "hyp.sub_batch=4",
    "hyp.steps=2", "hyp.warmup=0", "impl.validate_every_nth_step=1",
    "data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
    "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
    "seed=0", "name=torch_family_parity",
]
CASES = {
    "vgg-fb1": ["model=vgg11", "hyp=fb1"],
    "densenet-gradreg": ["model=densenet121", "hyp=gradreg"],
    "nfnet-fb1": ["model=nfn", "hyp=fb1", "data.size=16"],
    "ghostnorm-sgd": ["model=resnet20", "model.width=4",
                      "model.normalization=SequentialGhostNorm", "hyp=base_sgd",
                      "data.size=128", "data.batch_size=128", "hyp.sub_batch=64"],
}


def _shrink(monkeypatch):
    for module in (jax_vgg, vgg):
        monkeypatch.setattr(module, "VGG_PLANS",
                            {"VGG11": [8, "M", 16, "M", 16, "M", 24, "M", 24, "M"]})
    for module in (jax_nfnets, nfnets):
        monkeypatch.setattr(module, "nfnet_params", {"F0": {
            "width": [256], "depth": [1], "train_imsize": 32, "test_imsize": 32,
            "drop_rate": 0.2}})
    for module in (jax_models, port_models):
        monkeypatch.setattr(module, "densenet_depths_to_config", lambda depth: (4, (2, 2), 8))


@pytest.mark.parametrize("case", list(CASES))
def test_family_train_matches_jax(case, config_dir, monkeypatch):
    _shrink(monkeypatch)
    overrides = BASE + CASES[case]
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
        ref_bn = jax.device_get(state.batch_stats) or {}

    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0)
    tmodel = construct_model(tcfg.model, tbundle.channels, tbundle.classes,
                             pixels=tbundle.pixels).to(torch.float64)
    load_jax_variables(tmodel, variables)
    tstate, stats = train(tmodel, tbundle, tcfg, device="cpu")

    assert tstate.step == 2
    ours = export_jax_variables(tmodel)
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], dict(ref_bn), "batch_stats")
    assert (case == "nfnet-fb1") == (not ours["batch_stats"])
    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
