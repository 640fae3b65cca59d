"""The port's eval-mode BatchNorm (``ops.bn.BNEval``, reached through
``models.layers.eval_affine``) against the JAX package, in float64 on the
CPU, where the wrappers run the kernels' plain versions with the Function's
real glue.

``BNEval``'s output and its ``dx``, ``dscale``, ``dbias`` are held against
``jax.vjp`` of the JAX ``_TorchBatchNorm(train=False)`` on the same numpy
inputs at 1e-12, and against ``torch.autograd.gradcheck``; a ResNet-20 under
``SequentialGhostNorm`` in eval mode (every norm a ``GhostBatchNorm``) has
the flax model's parameter gradient at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.models.layers import _TorchBatchNorm
from fullbatchtraining_tpu_torch.convert import params_to_jax
from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d
from fullbatchtraining_tpu_torch.ops import bn

from test_torch_families import _assert_close, build, port_and_variables
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-12
MODEL_RTOL = 1e-10
SHAPES = [(4, 8, 8, 16), (3, 5, 7, 24), (128, 40), (2, 1, 1, 9)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return {"x": rng.standard_normal(shape) * 1.5 + 0.3,
            "scale": rng.standard_normal(c) * 0.5 + 1.0,
            "bias": rng.standard_normal(c),
            "mean": rng.standard_normal(c) * 0.3,
            "var": rng.uniform(0.5, 2.0, c),
            "dy": rng.standard_normal(shape)}


def _jax_eval(v):
    """``y`` and ``(dx, dscale, dbias)`` of the JAX ``_TorchBatchNorm`` in
    eval mode, by ``jax.vjp``."""
    c = v["x"].shape[-1]
    module = _TorchBatchNorm(channels=c)
    with jax.enable_x64(True):
        def f(x, scale, bias):
            return module.apply({"params": {"scale": scale, "bias": bias},
                                 "batch_stats": {"mean": jnp.asarray(v["mean"]),
                                                 "var": jnp.asarray(v["var"])}},
                                x, train=False)

        y, vjp = jax.vjp(f, *(jnp.asarray(v[k]) for k in ("x", "scale", "bias")))
        grads = vjp(jnp.asarray(v["dy"]))
        return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_bn_eval_matches_jax(shape):
    v = _inputs(shape)
    y_ref, grads_ref = _jax_eval(v)
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    leaves = [t[k].clone().requires_grad_() for k in ("x", "scale", "bias")]
    y = bn.bn_eval(*leaves, t["mean"], t["var"])
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=RTOL, atol=1e-12)
    grads = torch.autograd.grad(y, leaves, t["dy"])
    for name, g, ref in zip(("dx", "dscale", "dbias"), grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), ref, rtol=RTOL, atol=1e-12, err_msg=name)


def test_bn_eval_gradcheck():
    v = _inputs((2, 3, 3, 5), seed=1)
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    leaves = [t[k].clone().requires_grad_() for k in ("x", "scale", "bias")]
    assert torch.autograd.gradcheck(
        lambda x, s, b: bn.bn_eval(x, s, b, t["mean"], t["var"]), leaves)


def test_bn_eval_forward_is_the_folded_apply():
    """Without grad, one ``apply`` of ``a = scale * rsqrt(var + eps)``, ``b =
    bias - mean * a`` in ``stat_dtype``, bitwise, for each input dtype; the
    running stats get no gradient."""
    v = _inputs((4, 6, 6, 8), seed=2)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        t = {k: torch.from_numpy(a) for k, a in v.items()}
        x = t["x"].to(dtype)
        acc = bn.stat_dtype(dtype)
        a = t["scale"].to(acc) * torch.rsqrt(t["var"].to(acc) + 1e-5)
        b = t["bias"].to(acc) - t["mean"].to(acc) * a
        with torch.no_grad():
            y = bn.bn_eval(x, t["scale"], t["bias"], t["mean"], t["var"])
        assert y.dtype == dtype
        assert torch.equal(y, bn.apply_plain(x.reshape(-1, 8), torch.stack([a, b])).view(x.shape))
    module = BatchNorm2d(8).to(torch.float64).eval()
    x = torch.from_numpy(v["x"]).permute(0, 3, 1, 2).requires_grad_()
    module(x).sum().backward()
    assert x.grad is not None and module.weight.grad is not None
    assert all(b.grad is None for b in module.buffers())


def test_ghostnorm_model_eval_gradient_matches_flax(monkeypatch):
    """The parameter gradient of a fixed linear functional of the eval-mode
    logits of ResNet-20 under ``SequentialGhostNorm`` (random running
    stats), against ``jax.grad`` of the flax model with ``train=False``."""
    case = "ghostnorm-even"
    model, variables = port_and_variables(case, monkeypatch)
    jmodel = build(case, monkeypatch, "jax")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 8, 8, 3))
    w = rng.standard_normal((6, 10))
    with jax.enable_x64(True):
        def functional(params):
            logits = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), train=False)
            return jnp.sum(logits * w)

        grads_ref = jax.device_get(jax.jit(jax.grad(functional))(variables["params"]))
    model.eval()
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    grads = params_to_jax(model, [p.grad for p in model.parameters()])
    _assert_close(grads, grads_ref, MODEL_RTOL, "eval grad")
