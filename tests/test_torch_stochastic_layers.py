"""The port's stochastic layers (dropout, NFNet's stochastic depth) and their draws.

* Rates of 0 are the deterministic forward, and draw nothing.
* The keep share matches the rate; dropout rescales by the keep share and
  stochastic depth does not.
* A seed repeats its masks, another seed draws others, and a stochastic layer
  in train mode outside ``layer_draws`` raises.
* In ``train()``, the regularizer's second gradient of a chunk draws the masks
  of the chunk's own forward, and the chunks draw different ones.
* A memory-efficient DenseNet (checkpointed dense layers, dropout on) trains
  as the plain one under ``hyp=gradreg``, with forward differences and with
  the exact ``autograd`` variant (a double backward through the
  checkpoints): params and running stats within 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

import fullbatchtraining_tpu_torch.models.models as port_models
import fullbatchtraining_tpu_torch.models.modules as modules
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.models.densenets import DenseNet
from fullbatchtraining_tpu_torch.models.modules import Dropout, layer_draws, stochastic_depth
from fullbatchtraining_tpu_torch.training import train

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

BASE = [
    "model=densenet121", "data.size=16", "data.path=/tmp/__torch_nodata__",
    "data.batch_size=8", "hyp.sub_batch=4", "hyp.steps=2", "hyp.warmup=0",
    "impl.validate_every_nth_step=1", "data.augmentations_train=", "impl.dtype=float64",
    "impl.accumulation_dtype=float64", "impl.mixed_precision=False",
    "impl.eval_block_chunks=1", "seed=0", "name=torch_stochastic_layers",
]


def _tiny_densenet(monkeypatch):
    monkeypatch.setattr(port_models, "densenet_depths_to_config", lambda depth: (4, (2, 2), 8))


def _densenet(drop_rate):
    return DenseNet(growth_rate=4, block_config=(2, 2), num_init_features=8, drop_rate=drop_rate,
                    classes=10, generator=torch.Generator().manual_seed(0)).to(
        memory_format=torch.channels_last).train()


def test_rates_of_zero_are_the_deterministic_forward():
    x = torch.randn(4, 16, 16, 3)
    model = _densenet(0.0)
    plain = model(x)   # no layer_draws block: nothing may draw
    with layer_draws(5):
        drawn = model(x)
    assert torch.equal(plain, drawn)
    y = torch.randn(8, 3, 2, 2)
    assert Dropout(0.0).train()(y) is y
    assert stochastic_depth(y, 0.0, True) is y and stochastic_depth(y, 1.0, True) is y


def test_keep_share_and_scaling():
    x = torch.ones(400, 1000, dtype=torch.float64)
    with layer_draws(1):
        dropped = Dropout(0.25).train()(x)
        depth = stochastic_depth(torch.ones(100_000, 1, 1, 1), 0.25, True)
    kept = dropped != 0
    assert abs(kept.double().mean().item() - 0.75) < 0.005
    assert torch.allclose(dropped[kept], torch.full_like(dropped[kept], 1 / 0.75))
    assert abs(depth.mean().item() - 0.75) < 0.005
    assert set(depth.unique().tolist()) == {0.0, 1.0}
    with torch.no_grad():
        assert torch.equal(Dropout(0.25).eval()(x), x)
        assert torch.equal(stochastic_depth(x, 0.25, False), x)


def test_draws_repeat_for_a_seed():
    x = torch.randn(64, 32)
    layer = Dropout(0.5).train()
    runs = []
    for seed in (3, 3, 4):
        with layer_draws(seed):
            runs.append((layer(x), layer(x)))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[0][1])
    assert not torch.equal(runs[0][0], runs[2][0])
    with pytest.raises(RuntimeError, match="layer_draws"):
        layer(x)


def _run(config_dir, extra):
    cfg = load_config(config_dir, overrides=BASE + list(extra))
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0).to(torch.float64)
    state, stats = train(model, bundle, cfg, device="cpu")
    return state, stats


def test_regularizer_pass_sees_the_chunks_masks(config_dir, monkeypatch):
    """``hyp=gradreg`` (forward differences) on a DenseNet with dropout: per
    chunk, its forward draws the masks and the regularizer's second gradient
    draws them again, equal; another chunk draws others."""
    _tiny_densenet(monkeypatch)
    drawn = []
    keep_mask = modules.keep_mask

    def recorded(shape, keep, like):
        drawn.append(keep_mask(shape, keep, like))
        return drawn[-1]

    monkeypatch.setattr(modules, "keep_mask", recorded)
    _run(config_dir, ["hyp=gradreg", "model.drop_rate=0.3", "hyp.steps=1"])
    per_pass = 4   # one dropout a dense layer
    chunks = 4     # 16 images in chunks of 4
    assert len(drawn) == chunks * 2 * per_pass
    passes = [drawn[i:i + per_pass] for i in range(0, len(drawn), per_pass)]
    for c in range(chunks):
        first, second = passes[2 * c], passes[2 * c + 1]
        assert all(torch.equal(a, b) for a, b in zip(first, second)), c
    assert not torch.equal(passes[0][0], passes[2][0])


@pytest.mark.parametrize("implementation", ["forward-differences", "autograd"])
def test_memory_efficient_densenet_trains_as_the_plain_one(implementation, config_dir,
                                                          monkeypatch):
    _tiny_densenet(monkeypatch)
    runs = []
    for efficient in (False, True):
        state, stats = _run(config_dir, ["hyp=gradreg", "model.drop_rate=0.2",
                                         f"hyp.grad_reg.implementation={implementation}",
                                         f"model.memory_efficient={efficient}"])
        runs.append((state.model.state_dict(), stats))
    (ref, ref_stats), (ours, stats) = runs
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=key)
    for key in ("train_loss", "full_loss", "grad_norm", "valid_loss"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-12, err_msg=key)
