"""The port's schedules and SGD against the JAX package's
``make_lr_schedule`` and ``torch_sgd``, in float64 (rtol 1e-12: the same
formulas, rounded once per op on both sides), and the optimizer interface's
refusals of unknown choices (the rest of the zoo:
``tests/test_torch_optim_zoo.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.training import optimizers as joptim
from fullbatchtraining_tpu_torch.training import optimizers

SCHEDULERS = ["linear", "exponential", "cosine-decay", "cosine-decay-floored", "cosine-4000",
              "none"]


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_schedule_matches(scheduler, warmup, config_dir):
    steps = 20
    cfg = load_config(config_dir, overrides=[
        "hyp=fb1", f"hyp.steps={steps}", f"hyp.warmup={warmup}", f"hyp.scheduler={scheduler}"])
    ours = optimizers.make_lr_schedule(cfg.hyp)
    with jax.enable_x64(True):
        ref = joptim.make_lr_schedule(cfg.hyp)
        expected = [float(ref(jnp.asarray(s, jnp.int32))) for s in range(steps + 6)]
    got = [ours(s) for s in range(steps + 6)]
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0)
    if warmup:  # the base lr is held at steps `warmup` and `warmup + 1`
        assert got[warmup] == got[warmup + 1] == float(cfg.hyp.optim.lr)


class _Params(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            setattr(self, name, nn.Parameter(torch.from_numpy(a.copy())))


@pytest.mark.parametrize("overrides,only_linear", [
    (["hyp.optim.nesterov=True", "hyp.optim.dampening=0.0", "hyp.optim.weight_decay=5e-4"],
     False),
    (["hyp.optim.nesterov=False", "hyp.optim.dampening=0.1", "hyp.optim.weight_decay=1e-2"],
     False),
    (["hyp.optim.momentum=0.0", "hyp.optim.nesterov=False"], False),
    (["hyp.optim.nesterov=True", "hyp.optim.weight_decay=1e-2"], True),
], ids=["nesterov-wd", "dampening-wd", "no-momentum", "only-linear-wd"])
def test_sgd_matches_torch_sgd(overrides, only_linear, config_dir):
    cfg = load_config(config_dir, overrides=["hyp=fb1"] + overrides + [
        f"hyp.only_linear_layers_weight_decay={only_linear}"])
    rng = np.random.default_rng(0)
    arrays = {"weight": rng.standard_normal((3, 4)), "bias": rng.standard_normal(4)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in arrays.items()} for _ in range(4)]
    lrs = [0.1, 0.05, 0.2, 0.01]

    module = _Params(arrays)
    opt = optimizers.make_optimizer(module, cfg.hyp)
    for g, lr in zip(grads, lrs):
        for group in opt.param_groups:
            group["lr"] = lr
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        opt.step()

    o = cfg.hyp.optim
    with jax.enable_x64(True):
        init, update = joptim.torch_sgd(o.momentum, o.dampening, o.nesterov, o.weight_decay,
                                        mask=joptim.wd_mask if only_linear else None)
        params = {k: jnp.asarray(v) for k, v in arrays.items()}
        state = init(params)
        for g, lr in zip(grads, lrs):
            params, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params, lr)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]), rtol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("overrides,message", [
    (["hyp/optim=adam", "hyp.optim.name=Adamax"], "Invalid optimizer Adamax provided."),
    (["hyp.optim.line_search=armijo"], "Invalid linesearch armijo defined."),
    (["hyp.scheduler=triangle"], "Invalid scheduler triangle provided."),
], ids=["optimizer", "line-search", "scheduler"])
def test_other_optimizers_raise(overrides, message, config_dir):
    """An unknown optimizer, line search or scheduler raises ValueError with
    the JAX package's message, in both packages."""
    cfg = load_config(config_dir, overrides=["hyp=fb1"] + overrides)
    with pytest.raises(ValueError, match=message):
        joptim.optim_interface(None, cfg.hyp)
    with pytest.raises(ValueError, match=message):
        optimizers.make_optimizer(_Params({"w": np.zeros(2)}), cfg.hyp)
