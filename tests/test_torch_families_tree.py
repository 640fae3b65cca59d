"""The leaf trees, activation estimates, refusals and conversions of the
port's other model families, against the JAX package.

* Every ``config/model`` file at its own widths: the port's leaf paths and
  shapes (built on the ``meta`` device) are ``jax.eval_shape`` of the flax
  ``model.init`` at 32 px; ``nfn``, ``densenet121`` and ``vgg16`` have their
  known parameter totals.
* ``estimate_activation_bytes`` equals the JAX function for every case of
  ``tests/test_torch_families.py``, in float32 and bfloat16.
* What the JAX package cannot build the port refuses: the padded-conv modes
  and GroupNorm(32) at a width 32 does not divide.
* ``convert`` round-trips every family bit for bit, its flat vectors follow
  the JAX ``ravel_pytree`` order, and loading stays strict.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.models import construct_model as jax_construct_model
from fullbatchtraining_tpu.models.models import \
    estimate_activation_bytes as jax_estimate_activation_bytes
from fullbatchtraining_tpu_torch.convert import (export_jax_variables, flat_from_jax,
                                                 flat_to_jax, jax_shapes, load_jax_variables)
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.models.models import estimate_activation_bytes
from test_torch_families import CASES, CONFIG, _leaves, build, port_and_variables
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

ALL_CONFIGS = sorted(p.stem for p in (CONFIG / "model").glob("*.yaml"))
TOTALS = {"nfn": 68_447_014, "densenet121": 6_956_298, "vgg16": 14_728_266}


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_every_config_builds_the_flax_tree(name):
    """Each ``config/model`` file at its own widths: the port's leaf paths and
    shapes are ``jax.eval_shape`` of the flax ``model.init`` at 32 px (the
    port built on the ``meta`` device)."""
    cfg = load_config(CONFIG, overrides=[f"model={name}"])
    with torch.device("meta"):
        model = construct_model(cfg.model, 3, 10)
    jmodel = jax_construct_model(cfg.model, 3, 10)
    abstract = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "stochdepth": jax.random.key(1),
         "dropout": jax.random.key(2)}, jnp.zeros((2, 32, 32, 3)), train=True))
    ref = {(coll, tuple(k.key for k in path)): tuple(leaf.shape)
           for coll in ("params", "batch_stats") if coll in abstract
           for path, leaf in jax.tree_util.tree_leaves_with_path(abstract[coll])}
    assert {k: tuple(v) for k, v in jax_shapes(model).items()} == ref
    if name in TOTALS:
        assert sum(p.numel() for p in model.parameters()) == TOTALS[name]


@pytest.mark.parametrize("case", list(CASES))
def test_activation_estimate_matches_jax(case, monkeypatch):
    spec = CASES[case]
    pixels = spec.get("pixels", 32)
    tmodel = build(case, monkeypatch, "port")
    jmodel = build(case, monkeypatch, "jax")
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                          (torch.float16, jnp.float16)):
        assert (estimate_activation_bytes(tmodel, pixels, 3, dtype)
                == jax_estimate_activation_bytes(jmodel, pixels, 3, jdtype))


REFUSED = {
    "circular": ["model.convolution=circular"],
    "reflect": ["model.convolution=reflect"],
    "replicate": ["model.convolution=replicate"],
    "groupnorm-width16": ["model.normalization=GroupNorm"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_what_jax_cannot_build_the_port_refuses(case):
    """Padded-conv modes and GroupNorm(32) at ResNet-20's width 16 raise in
    both packages."""
    cfg = load_config(CONFIG, overrides=["model=resnet20", *REFUSED[case]])
    with pytest.raises(Exception) as jax_err:
        jax_construct_model(cfg.model, 3, 10).init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    with pytest.raises(ValueError, match="JAX reference" if "width" not in case
                       else "does not divide"):
        construct_model(cfg.model, 3, 10)
    assert ("NameInUse" in type(jax_err.value).__name__ if "width" not in case
            else isinstance(jax_err.value, ValueError)), repr(jax_err.value)


ROUND_TRIP = ["vgg-imagenet", "densenet-efficient", "pyramidnet-bottleneck", "nfnet-cifar",
              "ghostnorm-even", "groupnorm8", "layernorm", "skipinit-bottleneck-C",
              "standardized", "linear"]


@pytest.mark.parametrize("case", ROUND_TRIP)
def test_export_load_round_trips(case, monkeypatch):
    """export -> load into a fresh model -> export returns the same leaves
    bit for bit; the flat vectors of L-BFGS follow the leaf order
    (``flat_from_jax`` of ``ravel_pytree`` is the port's own flat vector)."""
    from jax.flatten_util import ravel_pytree

    tmodel, variables = port_and_variables(case, monkeypatch)
    fresh = build(case, monkeypatch, "port").to(torch.float64)
    load_jax_variables(fresh, variables)
    for coll in variables:
        for key, value in _leaves(variables[coll]).items():
            np.testing.assert_array_equal(_leaves(export_jax_variables(fresh)[coll])[key],
                                          value, err_msg=key)
    with jax.enable_x64(True):
        flat, _ = ravel_pytree(variables["params"])
    ours = torch.cat([p.detach().reshape(-1) for p in tmodel.parameters()])
    assert torch.equal(flat_from_jax(tmodel, np.asarray(flat)), ours)
    np.testing.assert_array_equal(flat_to_jax(tmodel, ours), np.asarray(flat))


FAULTS = {
    "ghost-missing-mean": ("ghostnorm-even", "batch_stats", "stem_bn1/mean", "del"),
    "nfnet-missing-skip-gain": ("nfnet-cifar", "params", "block0/skip_gain", "del"),
    "nfnet-extra-stats": ("nfnet-cifar", "batch_stats", "block0/mean", "add"),
    "groupnorm-shape": ("groupnorm8", "params", "stem_bn1/gn/scale", "shape"),
    "pyramidnet-wrapped-bn": ("pyramidnet-basic", "params", "bn1/scale", "wrap"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_load_is_strict(fault, monkeypatch):
    case, coll, path, kind = FAULTS[fault]
    tmodel, variables = port_and_variables(case, monkeypatch)
    broken = copy.deepcopy(variables)
    *parents, leaf = path.split("/")
    node = broken[coll]
    for part in parents:
        node = node.setdefault(part, {})
    if kind == "del":
        del node[leaf]
    elif kind == "add":
        node[leaf] = np.zeros(3)
    elif kind == "shape":
        node[leaf] = np.zeros(node[leaf].shape[0] + 1)
    else:
        node["bn"] = {leaf: node.pop(leaf)}
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(tmodel, broken)


@pytest.mark.parametrize("shape", [(128, 128, 3), (1536, 768, 1), (3, 16, 3)])
def test_wsconv_bf16_standardization(shape):
    """Under bf16 the port standardizes ``WSConv2d``'s weight in float32 and
    rounds the result once; the JAX step casts the kernel and gain to bf16
    first and standardizes in bf16. Against the float64 weight, the port's
    is the closer: relative L2 error below 2e-3 (one bf16 rounding), the
    JAX way's above 3e-3, at NFNet-F0's conv shapes (in, out, kernel)."""
    from fullbatchtraining_tpu_torch.models.layers import WSConv2d

    cin, cout, k = shape
    conv = WSConv2d(cin, cout, k, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.gain.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        exact = conv.double().standardized_weight()
        ours = conv.float().standardized_weight().to(torch.bfloat16).double()
    kernel = jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0), jnp.bfloat16)
    gain = jnp.asarray(conv.gain.detach().numpy(), jnp.bfloat16)
    mean = jnp.mean(kernel, axis=(0, 1, 2), keepdims=True)
    var = jnp.var(kernel, axis=(0, 1, 2), keepdims=True, ddof=1)
    w = (kernel - mean) * jax.lax.rsqrt(jnp.maximum(var * conv.fan_in, 1e-4)) * gain
    theirs = torch.from_numpy(np.asarray(w.astype(jnp.float32)).transpose(3, 2, 0, 1).copy())

    def error(w):
        return ((w.double() - exact).norm() / exact.norm()).item()

    print(f"WSConv2d {shape}: relative L2 error in bf16, port {error(ours):.3e}, "
          f"JAX way {error(theirs):.3e}")   # shown with pytest -s
    assert error(ours) < 2e-3 < 3e-3 < error(theirs), (error(ours), error(theirs))


@pytest.mark.parametrize("shape", [(128, 128, 3), (1536, 768, 1), (3, 16, 3)])
def test_wsconv_float16_standardization(shape):
    """The bf16 check above in float16 (``impl.compute_dtype=float16``
    autocasts the convolution, not the standardization): against the
    float64 weight the port's, standardized in float32 and rounded once, is
    within 2.5e-4 (one float16 rounding, 8x finer than bf16's), the JAX
    way's, standardized in float16, beyond 3.75e-4."""
    from fullbatchtraining_tpu_torch.models.layers import WSConv2d

    cin, cout, k = shape
    conv = WSConv2d(cin, cout, k, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.gain.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        exact = conv.double().standardized_weight()
        with torch.autocast("cpu", dtype=torch.float16):
            ours = conv.float().standardized_weight()
        assert ours.dtype == torch.float32
        ours = ours.to(torch.float16).double()
    kernel = jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0), jnp.float16)
    gain = jnp.asarray(conv.gain.detach().numpy(), jnp.float16)
    mean = jnp.mean(kernel, axis=(0, 1, 2), keepdims=True)
    var = jnp.var(kernel, axis=(0, 1, 2), keepdims=True, ddof=1)
    w = (kernel - mean) * jax.lax.rsqrt(jnp.maximum(var * conv.fan_in, 1e-4)) * gain
    theirs = torch.from_numpy(np.asarray(w.astype(jnp.float32)).transpose(3, 2, 0, 1).copy())

    def error(w):
        return ((w.double() - exact).norm() / exact.norm()).item()

    assert error(ours) < 2.5e-4 < 3.75e-4 < error(theirs), (error(ours), error(theirs))
