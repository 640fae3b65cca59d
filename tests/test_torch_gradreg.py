"""The port's gradient regularizer against the JAX package's, variant by variant.

ResNet-18 at width 4 in float64, one chunk of 8 synthetic 32x32 images, the
same weights on both sides (``convert.load_jax_variables``, BN leaves drawn
at random). The port's ``grad_fn`` is ``Trainer.regrad``; the JAX one is
built here from the flax model and criterion, as the JAX ``train()`` builds
its ``regrad``. Each variant runs with ``block_strength=0.5`` alone and with
``acc_strength=0.5`` and given ``pre_grads``, at ``lr=0.8``.

Tolerance: the regularized gradient and the regularizer's own increment
(output minus input gradient) agree to 1e-9 relative to the largest entry of
each tensor. Float64 with other summation orders keeps about 1e-13 relative
per gradient; a finite difference divides the difference of two gradients
by ``eps_n = eps / ||v||`` (about 1e-2 here), which amplifies that error
about a hundredfold, still far inside 1e-9.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import from_dict as jax_from_dict
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.models import construct_model as jax_construct_model
from fullbatchtraining_tpu.models.modules import get_loss_fn as jax_get_loss_fn
from fullbatchtraining_tpu.training import grad_reg as jax_grad_reg
from fullbatchtraining_tpu_torch.config import from_dict, load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import grad_reg
from fullbatchtraining_tpu_torch.training.training import Trainer

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-9
LR = 0.8
OVERRIDES = ["model=resnet18", "model.width=4", "hyp=gradreg", "data.size=8",
             "data.batch_size=8", "hyp.sub_batch=8", "data.path=/tmp/__torch_nodata__",
             "data.augmentations_train=", "impl.dtype=float64",
             "impl.accumulation_dtype=float64", "impl.mixed_precision=False", "seed=0"]


def _randomize_bn(tree, rng, in_bn=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, in_bn=k == "bn")
        elif in_bn and k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape)
        elif in_bn:
            out[k] = rng.standard_normal(v.shape) * 0.5 + (1.0 if k == "scale" else 0.0)
        else:
            out[k] = v
    return out


def _as_list(tmodel, params_tree, variables):
    """A flax params tree as a list in ``tmodel.parameters()`` order."""
    clone = load_jax_variables(copy.deepcopy(tmodel),
                               {"params": params_tree, "batch_stats": variables["batch_stats"]})
    return [p.detach() for p in clone.parameters()]


def _as_tree(tmodel, tensors):
    """A list in ``tmodel.parameters()`` order as a flax params tree."""
    clone = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, t in zip(clone.parameters(), tensors):
            p.copy_(t)
    return export_jax_variables(clone)["params"]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _assert_close(ours, ref, what):
    ref = dict(_flat(ref))
    for name, value in _flat(ours):
        scale = max(np.abs(ref[name]).max(), 1e-30)
        np.testing.assert_allclose(value, ref[name], rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def setup(config_dir):
    """(trainer, variables, x NHWC numpy, labels, JAX grad_fn)."""
    cfg = load_config(config_dir, overrides=OVERRIDES)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=True)
    tmodel = construct_model(cfg.model, bundle.channels, bundle.classes).to(torch.float64)
    rng = np.random.default_rng(0)
    variables = {c: _randomize_bn(t, rng) for c, t in export_jax_variables(tmodel).items()}
    load_jax_variables(tmodel, variables)
    trainer = Trainer(tmodel, bundle, cfg, torch.device("cpu"))
    tmodel.train()

    x = np.random.default_rng(1).standard_normal((8, 32, 32, 3))
    labels = np.random.default_rng(2).integers(0, 10, 8)

    jcfg = jax_load_config(config_dir, overrides=OVERRIDES)
    jmodel = jax_construct_model(jcfg.model, 3, 10)
    criterion = jax_get_loss_fn(jcfg.hyp, 8)

    def jax_grad_fn(params, batch_stats, images, labels_, key):
        def loss(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": batch_stats}, images,
                                     train=True, mutable=["batch_stats"])
            return criterion(logits, labels_)
        return jax.grad(loss)(params)

    return trainer, variables, x, labels, jax_grad_fn


def _cfg(implementation, acc, block=0.5):
    return {"norm": 2, "block_strength": block, "acc_strength": acc, "eps": 1e-2,
            "implementation": implementation}


def _pre_grads(variables):
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda v: rng.standard_normal(v.shape) * 0.05, variables["params"])


def _run_port(trainer, variables, x, labels, implementation, acc):
    tx = torch.from_numpy(x)
    tl = torch.from_numpy(labels).long()
    reg_fn = grad_reg.make_grad_regularizer(from_dict(_cfg(implementation, acc)), trainer.regrad)
    grads = trainer.regrad(trainer.params, tx, tl)
    pre = _as_list(trainer.model, _pre_grads(variables), variables) if acc else None
    out = reg_fn(grads, trainer.params, tx, tl, pre, LR)
    return grads, out


def _run_jax(variables, x, labels, jax_grad_fn, implementation, acc):
    with jax.enable_x64(True):
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        images, lbls = jnp.asarray(x), jnp.asarray(labels)
        reg_fn = jax_grad_reg.make_grad_regularizer(
            jax_from_dict(_cfg(implementation, acc)), jax_grad_fn)
        grads = jax_grad_fn(params, stats, images, lbls, None)
        pre = jax.tree.map(jnp.asarray, _pre_grads(variables)) if acc else None
        out = reg_fn(grads, params, stats, images, lbls, pre, LR, jax.random.key(0))
        return jax.device_get(grads), jax.device_get(out)


@pytest.mark.parametrize("acc", [0.0, 0.5], ids=["block", "block+acc"])
@pytest.mark.parametrize("implementation", grad_reg.VARIANTS)
def test_variant_matches_jax(setup, implementation, acc):
    trainer, variables, x, labels, jax_grad_fn = setup
    grads, out = _run_port(trainer, variables, x, labels, implementation, acc)
    jgrads, jout = _run_jax(variables, x, labels, jax_grad_fn, implementation, acc)
    model = trainer.model
    _assert_close(_as_tree(model, grads), jgrads, "base gradient")
    _assert_close(_as_tree(model, out), jout, "regularized gradient")
    increment = jax.tree.map(np.subtract, jout, jgrads)
    _assert_close(_as_tree(model, [o - g for o, g in zip(out, grads)]), increment, "increment")
    assert max(np.abs(v).max() for _, v in _flat(increment)) > 1e-6, "the regularizer did nothing"


def test_reg_fn_leaves_running_stats_alone(setup):
    trainer, variables, x, labels, _ = setup
    before = {k: b.clone() for k, b in trainer.model.named_buffers()}
    for implementation in ("forward-differences", "autograd-pen"):
        _run_port(trainer, variables, x, labels, implementation, 0.5)
    for k, b in trainer.model.named_buffers():
        assert torch.equal(b, before[k]), k


def test_autograd_equals_complex_step_bitwise(setup):
    trainer, variables, x, labels, _ = setup
    _, a = _run_port(trainer, variables, x, labels, "autograd", 0.5)
    _, c = _run_port(trainer, variables, x, labels, "complex-step", 0.5)
    assert all(torch.equal(s, t) for s, t in zip(a, c))


@pytest.mark.parametrize("cfg,error", [
    (_cfg("forward-differences", 0.0, block=0.0), None),
    (_cfg("not-a-method", 0.0), ValueError),
    (_cfg("autograd-pen", 0.5, block=0.0), ValueError),
], ids=["zero-strength", "unknown", "pen-without-block"])
def test_construction_matches_jax(cfg, error):
    def nothing(*args, **kwargs):
        raise AssertionError("grad_fn called at construction")

    if error is None:
        assert grad_reg.make_grad_regularizer(from_dict(cfg), nothing) is None
        assert jax_grad_reg.make_grad_regularizer(jax_from_dict(cfg), nothing) is None
        return
    with pytest.raises(error) as ours:
        grad_reg.make_grad_regularizer(from_dict(cfg), nothing)
    with pytest.raises(error) as ref:
        jax_grad_reg.make_grad_regularizer(jax_from_dict(cfg), nothing)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("implementation", ["forward-differences", "central-differences"])
def test_difference_quotient_tends_to_the_exact_product(setup, implementation):
    """At eps = 1e-6 the finite differences give the exact ``autograd``
    increment to 1e-4 (forward: O(eps) truncation) and 1e-8 (central:
    O(eps^2)) of its norm; at the configs' eps = 1e-2 the step crosses ReLU
    kinks and they may lie far from it."""
    trainer, _, x, labels, _ = setup
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels).long()
    grads = trainer.regrad(trainer.params, tx, tl)

    def increment(implementation_, eps):
        cfg = from_dict({**_cfg(implementation_, 0.0), "eps": eps})
        out = grad_reg.make_grad_regularizer(cfg, trainer.regrad)(
            grads, trainer.params, tx, tl, None, LR)
        return torch.cat([(o - g).flatten() for o, g in zip(out, grads)])

    exact = increment("autograd", 1e-2)
    tol = 1e-4 if implementation == "forward-differences" else 1e-8
    assert (increment(implementation, 1e-6) - exact).norm() <= tol * exact.norm()
