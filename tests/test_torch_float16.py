"""The port in float16 (and bfloat16 parameters) against the JAX package as it
ships, on the CPU.

Every tolerance is a control: how far the JAX package moves the same
quantity by itself when its half-precision run starts from inputs (or
weights) 2^-11 off, one float16 rounding step. Where the JAX package adds
float16 values one at a time (the per-leaf squared norms behind
``grad_norm`` and ``full_loss``, in its tree's leaf order), a second control
is its own run with those leaves added in the reverse order: the port adds
them in another order too. The port must lie no further from the JAX
half-precision result than that. The JAX float32 result is no tolerance:
where float16 changes a result beyond rounding noise, the port must lie
strictly closer to the JAX float16 result than to the float32 one, so a port
that computed in float32 fails:

* ``bn_train`` in float16 against ``pallas_bn.bn_train_reference`` (and the
  Pallas kernels in interpret mode where they tile): ``y``, ``mean``,
  ``var`` and the gradients, element by element; ``y`` and ``dx`` closer to
  float16 than to float32;
* a ResNet-20 (width 8) in float16: train-mode logits and the parameter
  gradient, in relative L2; the gradient closer to float16;
* ``Linear`` and ``Conv2d`` in float16 against flax ``Dense`` and ``Conv``
  (the bias added after the rounded product), and on the CPU each product
  and its gradients within 10x JAX's own count of entries off the float64
  result rounded once;
* 2 ``hyp=fb1`` steps of ``train()`` under ``impl.compute_dtype=float16``
  and under ``impl.dtype=float16`` from the JAX weights: params and
  running stats in relative L2, each step's losses and gradient norm; the
  running stats (and float16 params) closer to float16;
* ``bn_train`` in float16 at the shape of a ResNet-20's last ``bn2``, with
  a scale near 1e-4 so that ``dx`` lies below float16's normal range: the
  default against the Pallas functions, ``split_dx=True`` against the JAX
  model's BatchNorm (``_TorchBatchNorm``), which rounds ``dx``'s two parts
  apart; the two JAX functions' counts of exactly-zero ``dx`` differ;
* one chunk's gradient at the weights of those 2 JAX steps, through the
  port's ``Trainer``: within the control, closer to float16, and with its
  count of exactly-zero entries (float16 underflow adds to float32's)
  closer to the JAX float16 count than to the float32 one, and within 10x
  the control's distance of it (20 entries at least); each layer-3 leaf
  within 10x the control in relative L2;
* one residual block of layer 3 at those weights, fed the same seeded
  float16 activation and cotangent in both packages: its last BatchNorm's
  forward, its backward, and the block's backward through ReLU, the
  residual add and ``conv2``, in zero counts and values;
* under ``impl.dtype=bfloat16`` and ``float16`` the port keeps its running
  stats in float32, as the JAX ``batch_stats``; after the 2 steps both
  packages' eval-mode logits on the JAX weights agree within the control.

Float16 has no loss scaling in either package: a gradient below its range
is zero in both.
"""

import copy
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
import fullbatchtraining_tpu.training.training as jax_training
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.data.augmentations import normalize as jax_normalize
from fullbatchtraining_tpu.models.layers import BatchNorm2d as JaxBatchNorm2d
from fullbatchtraining_tpu.models.layers import get_layer_functions as jax_layer_functions
from fullbatchtraining_tpu.models.modules import get_loss_fn as jax_loss_fn
from fullbatchtraining_tpu.models.resnets import BasicBlock as JaxBasicBlock
from fullbatchtraining_tpu.ops import pallas_bn
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model, layers
from fullbatchtraining_tpu_torch.ops import bn
from fullbatchtraining_tpu_torch.training import train
from fullbatchtraining_tpu_torch.training.training import Trainer, place_model

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

CONFIG = pathlib.Path(__file__).resolve().parent.parent / "config"
ULP16 = 2.0 ** -11      # float16's relative rounding step, the perturbation's size


def _perturbed(a, seed):
    """``a`` with each entry moved by ``ULP16`` of itself, up or down."""
    sign = np.sign(np.random.default_rng(seed).standard_normal(np.shape(a)))
    return np.asarray(a, np.float64) * (1 + ULP16 * sign)


def _f64(a):
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _rel_l2(a, b):
    a, b = (np.concatenate([np.ravel(_f64(x)) for x in jax.tree.leaves(t)]) for t in (a, b))
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _zeros(tree):
    return sum(int(np.sum(_f64(x) == 0)) for x in jax.tree.leaves(tree))


def _zero_limit(control_zeros, ref_zeros):
    """How far a zero count may lie from the JAX one: 10x the control's
    distance, and no less than 20 entries."""
    return max(20, 10 * abs(control_zeros - ref_zeros))


# --------------------------------------------------------------------------
# bn_train
# --------------------------------------------------------------------------

BN_SHAPES = [(4, 8, 8, 64), (3, 5, 7, 24)]


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_bn, "_INTERPRET", True)


def _jax_bn(fn, x, scale, bias, cot, dtype):
    """``(y, mean, var, dx, dscale, dbias)`` of a JAX BN function."""
    def loss(x_, s_, b_):
        return jnp.sum(fn(x_, s_, b_)[0].astype(jnp.float32) * jnp.asarray(cot, jnp.float32))

    jx = jnp.asarray(x, dtype)
    js, jb = jnp.asarray(scale, jnp.float32), jnp.asarray(bias, jnp.float32)
    y, mean, var = fn(jx, js, jb)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jx, js, jb)
    return [_f64(t) for t in (y, mean, var, *grads)]


@pytest.mark.parametrize("shape", BN_SHAPES, ids=["x".join(map(str, s)) for s in BN_SHAPES])
def test_bn_train_float16_matches_jax(shape, _interpret):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = _f64(jnp.asarray(rng.standard_normal(shape) * 1.5 + 0.3, jnp.float16))
    scale = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cot = _f64(jnp.asarray(rng.standard_normal(shape), jnp.float16))

    tx = torch.tensor(x, dtype=torch.float16, requires_grad=True)
    ts, tb = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    y, mean, var = bn.bn_train(tx, ts, tb)
    assert y.dtype == torch.float16 and mean.dtype == var.dtype == torch.float32
    grads = torch.autograd.grad(y, (tx, ts, tb), torch.tensor(np.asarray(cot)).half())
    ours = [t.detach().double().numpy() for t in (y, mean, var, *grads)]

    ref = pallas_bn.bn_train_reference
    half = _jax_bn(ref, x, scale, bias, cot, jnp.float16)
    control = [np.abs(a - b).max() for a, b in zip(half, _jax_bn(
        ref, _perturbed(x, 1), _perturbed(scale, 2), _perturbed(bias, 3), _perturbed(cot, 4),
        jnp.float16))]
    oracles = [("reference", ref)]
    if pallas_bn.supported(jnp.asarray(x, jnp.float16)):
        oracles.append(("pallas", pallas_bn.bn_train))
    for name, fn in oracles:
        theirs = _jax_bn(fn, x, scale, bias, cot, jnp.float16)
        for what, o, t, tol in zip(("y", "mean", "var", "dx", "dscale", "dbias"), ours, theirs,
                                   control):
            assert np.abs(o - t).max() <= tol, (name, what, np.abs(o - t).max(), tol)
    # the float16 outputs; the statistics and dscale, dbias are float32 sums
    # of the same float16 inputs in both runs
    single = _jax_bn(ref, x, scale, bias, cot, jnp.float32)
    for what, i in (("y", 0), ("dx", 3)):
        assert np.abs(ours[i] - half[i]).max() < np.abs(ours[i] - single[i]).max(), what


# the last bn2 of a ResNet-20 at width 8 on 8 images: [8, 8, 8, 32]
BN2_SHAPE = (8, 8, 8, 32)


def _jax_model_bn(x, scale, bias):
    """The JAX model's train-mode BatchNorm (``layers.BatchNorm2d``) as its
    step runs it, on params cast to float16: ``(y, mean, var)``, the
    statistics in the expressions of ``_TorchBatchNorm``."""
    c = scale.shape[0]
    params = {"bn": {"scale": scale.astype(jnp.float16), "bias": bias.astype(jnp.float16)}}
    stats = {"bn": {"mean": jnp.zeros(c, jnp.float32), "var": jnp.ones(c, jnp.float32)}}
    y, _ = JaxBatchNorm2d(c).apply({"params": params, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
    xf = x.astype(jnp.float32)
    axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(xf, axes)
    return y, mean, jnp.mean(jnp.square(xf), axes) - jnp.square(mean)


def test_bn_train_float16_subnormal_gradient_matches_jax(_interpret):
    """A ``bn2``-like BatchNorm: scales of 1e-4 to 1e-3, ``dx`` below float16's
    smallest normal number, where a rounding step is an absolute 6e-8. The
    default ``bn_train`` rounds ``dx`` once, as ``pallas_bn`` does (its
    reference and, in interpret mode, its kernels); ``split_dx=True`` with
    float16 scale and bias, as the model's BatchNorm calls it, rounds
    ``a*dy`` and ``c1 + c2*x`` apart, as autodiff of the JAX model's
    BatchNorm does. Each lies within the control of its JAX function,
    element by element and in its count of exactly-zero ``dx``; the two
    JAX functions' counts differ by more than that."""
    rng = np.random.default_rng(14)
    c = BN2_SHAPE[-1]
    x = _f64(jnp.asarray(rng.standard_normal(BN2_SHAPE) * 0.7 + 0.8, jnp.float16))
    scale = _f64(jnp.asarray(10.0 ** rng.uniform(-4, -3, c), jnp.float16))
    bias = _f64(jnp.asarray(rng.standard_normal(c) * 0.1, jnp.float16))
    # a cotangent that came through the block's last ReLU: a quarter of it
    # zero, and a mean per channel
    cot = (rng.uniform(size=BN2_SHAPE) > 0.25) * (rng.standard_normal(BN2_SHAPE)
                                                  + 2 * rng.standard_normal(c))
    cot = _f64(jnp.asarray(cot * 1e-4, jnp.float16))
    off = (_perturbed(x, 1), _perturbed(scale, 2), _perturbed(bias, 3), _perturbed(cot, 4))
    names = ("y", "mean", "var", "dx", "dscale", "dbias")

    zeros = {}
    for split, fn in ((False, pallas_bn.bn_train_reference), (True, _jax_model_bn)):
        affine = torch.float16 if split else torch.float32
        tx = torch.tensor(x, dtype=torch.float16, requires_grad=True)
        ts = torch.tensor(scale, dtype=affine, requires_grad=True)
        tb = torch.tensor(bias, dtype=affine, requires_grad=True)
        y, mean, var = bn.bn_train(tx, ts, tb, split_dx=split)
        grads = torch.autograd.grad(y, (tx, ts, tb), torch.tensor(cot, dtype=torch.float16))
        ours = [t.detach().double().numpy() for t in (y, mean, var, *grads)]
        theirs = _jax_bn(fn, x, scale, bias, cot, jnp.float16)
        control = _jax_bn(fn, *off, jnp.float16)
        oracles = [theirs]
        if not split and pallas_bn.supported(jnp.asarray(x, jnp.float16)):
            oracles.append(_jax_bn(pallas_bn.bn_train, x, scale, bias, cot, jnp.float16))
        for oracle in oracles:
            for what, o, t, ref, ctl in zip(names, ours, oracle, theirs, control):
                tol = np.abs(ctl - ref).max()
                assert np.abs(o - t).max() <= tol, (split, what, np.abs(o - t).max(), tol)
            counts = [int(np.sum(a[3] == 0)) for a in (ours, oracle, control)]
            assert abs(counts[0] - counts[1]) <= _zero_limit(counts[2], counts[1]), (split,
                                                                                    counts)
        assert np.abs(theirs[3]).max() < 6.1e-5     # below float16's normal range
        zeros[split] = counts
        print(f"split_dx={split}: exactly-zero dx entries: port {counts[0]}, JAX {counts[1]}, "
              f"JAX from inputs 2^-11 off {counts[2]} of {x.size}")
    once, apart = zeros[False][1], zeros[True][1]
    assert abs(once - apart) > _zero_limit(zeros[True][2], apart), (once, apart)


# --------------------------------------------------------------------------
# a ResNet-20's forward and gradient
# --------------------------------------------------------------------------

def _resnet20():
    cfg = load_config(CONFIG, overrides=["model=resnet20", "model.width=8"])
    return cfg, construct_model(cfg.model, 3, 10)


def test_resnet20_float16_forward_and_gradient_match_jax():
    """Train-mode logits and the parameter gradient of the mean cross-entropy
    of 8 images, every param and the input in float16 on both sides."""
    cfg, tmodel = _resnet20()
    variables = export_jax_variables(copy.deepcopy(tmodel).double())
    rng = np.random.default_rng(3)
    x = _f64(jnp.asarray(rng.standard_normal((8, 32, 32, 3)), jnp.float16))
    labels = rng.integers(0, 10, 8)
    jmodel = jax_models.construct_model(cfg.model, 3, 10)

    def jax_side(params, x_, dtype):
        def loss(p):
            p = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
            logits, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(x_, dtype), train=True,
                                     mutable=["batch_stats"])
            logits = logits.astype(jnp.float32)
            return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(8), labels]), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return _f64(logits), jax.tree.map(_f64, grads)

    half = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float16)), variables["params"])
    theirs = jax_side(half, x, jnp.float16)
    f32 = jax_side(half, x, jnp.float32)
    off = jax_side(jax.tree.map(lambda a: _perturbed(a, 5), half), _perturbed(x, 6),
                   jnp.float16)

    place_model(tmodel, "cpu", torch.float16)
    logits = tmodel(torch.tensor(x, dtype=torch.float16)).float()   # NHWC in
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    grads = dict(zip([n for n, _ in tmodel.named_parameters()],
                     torch.autograd.grad(loss, list(tmodel.parameters()))))
    for p, g in grads.items():
        assert g.dtype == torch.float16, p
    probe = copy.deepcopy(tmodel).double()
    for p, g in zip(probe.parameters(), grads.values()):
        p.data.copy_(g)
    ours_grads = export_jax_variables(probe)["params"]

    for what, ours, ref, control in (
            ("logits", logits.detach().double().numpy(), theirs[0], off[0]),
            ("gradient", ours_grads, theirs[1], off[1])):
        tol = _rel_l2(control, ref)
        assert _rel_l2(ours, ref) <= tol, (what, _rel_l2(ours, ref), tol)
    # the logits are one float16 rounding from the float32 ones on either side
    assert _rel_l2(ours_grads, theirs[1]) < _rel_l2(ours_grads, f32[1])


# layer: (input shape, weight shape, the torch product and its arguments)
PRODUCTS = {
    "linear": ((256, 32), (10, 32), (torch.nn.functional.linear,)),
    "conv": ((8, 8, 8, 32), (16, 32, 3, 3), (torch.nn.functional.conv2d, 1, 1, 1, 1)),
}


def _flax_product(layer, x, w, b, cot):
    """``(y, dx, dw)`` of flax ``Dense`` or ``Conv`` in float16, the bias
    ``b`` added after the product (none where ``b`` is None), ``dw`` in the
    torch weight's layout."""
    import flax.linen as flax_nn

    if layer == "linear":
        module, kernel = flax_nn.Dense(w.shape[0], use_bias=b is not None), w.T
    else:
        module = flax_nn.Conv(w.shape[0], (3, 3), padding=((1, 1), (1, 1)),
                              use_bias=b is not None)
        kernel = w.transpose(2, 3, 1, 0)
    params = {"kernel": jnp.asarray(kernel, jnp.float16)}
    if b is not None:
        params["bias"] = jnp.asarray(b, jnp.float16)
    y, vjp = jax.vjp(lambda p, x_: module.apply({"params": p}, x_), params,
                     jnp.asarray(x, jnp.float16))
    dp, dx = vjp(jnp.asarray(cot, jnp.float16))
    dw = _f64(dp["kernel"])
    dw = dw.T if layer == "linear" else dw.transpose(3, 2, 0, 1)
    return _f64(y), _f64(dx), dw


def _exact_product(layer, x, w, cot):
    """``(y, dx, dw)`` of the product without bias in float64, each rounded
    once to float16."""
    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tw = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    if layer == "linear":
        y = torch.nn.functional.linear(tx, tw)
    else:
        y = torch.nn.functional.conv2d(tx.permute(0, 3, 1, 2), tw, padding=1).permute(0, 2, 3, 1)
    grads = torch.autograd.grad(y, (tx, tw), torch.tensor(cot, dtype=torch.float64))
    return [t.detach().half().double().numpy() for t in (y, *grads)]


@pytest.mark.parametrize("layer", ["linear", "conv"])
@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_products_float16_match_flax(case, layer):
    """The classifier and the convolutions in float16 (float16 params, or
    float32 ones under autocast), with a cotangent below float16's normal
    range. Flax ``Dense`` and ``Conv`` round the product to float16 and add
    the bias in float16; the port's ``Linear`` and ``Conv2d`` do the same
    (``F.linear``/``F.conv2d`` with the bias fused round once), and differ
    from JAX in fewer outputs than the fused form does; the port lies within
    the control (JAX from inputs 2^-11 off). On the CPU the port computes a
    float16 product in float32 and rounds once, as XLA does: its output and
    both gradients differ from the float64 product rounded once to float16
    in no more entries than 10x JAX's own count (20 at least), on any host
    (torch's CPU float16 kernels round as they accumulate on a host with
    AVX512-FP16)."""
    rng = np.random.default_rng(8)
    x_shape, w_shape, (fn, *args) = PRODUCTS[layer]
    x = _f64(jnp.asarray(rng.standard_normal(x_shape) * 0.5, jnp.float16))
    w = _f64(jnp.asarray(rng.standard_normal(w_shape) * 0.2, jnp.float16))
    b = _f64(jnp.asarray(rng.standard_normal(w_shape[0]) * 0.2, jnp.float16))
    y_shape = (*x_shape[:-1], w_shape[0])
    cot = _f64(jnp.asarray(rng.standard_normal(y_shape) * 1e-5, jnp.float16))

    theirs = _flax_product(layer, x, w, b, cot)
    control = _flax_product(layer, _perturbed(x, 1), _perturbed(w, 2), _perturbed(b, 3),
                            _perturbed(cot, 4))
    product = _flax_product(layer, x, w, None, cot)[0]
    exact = _exact_product(layer, x, w, cot)
    half = case == "float16-params"
    module = (layers.Linear(x_shape[-1], w_shape[0]) if layer == "linear"
              else layers.Conv2d(x_shape[-1], w_shape[0], 3, padding=1))
    with torch.no_grad():
        module.weight.copy_(torch.tensor(w))
        module.bias.copy_(torch.tensor(b))
    module.to(torch.float16 if half else torch.float32)
    tx = torch.tensor(x, dtype=torch.float16, requires_grad=True)
    nchw = (lambda t: t) if layer == "linear" else (lambda t: t.permute(0, 3, 1, 2))
    nhwc = (lambda t: t) if layer == "linear" else (lambda t: t.permute(0, 2, 3, 1))
    with torch.autocast("cpu", dtype=torch.float16, enabled=not half):
        y = nhwc(module(nchw(tx)))
        fused = nhwc(fn(nchw(tx), module.weight, module.bias, *args[1:]))
        prod = nhwc(layers.half_product(fn, nchw(tx), module.weight, *args[1:]))
    assert y.dtype == fused.dtype == prod.dtype == torch.float16
    dx, dw = torch.autograd.grad(y, (tx, module.weight), torch.tensor(cot).half())
    ours = [t.detach().double().numpy() for t in (y, dx, dw)]
    fused, prod = (t.detach().double().numpy() for t in (fused, prod))
    for what, o, t, c in zip(("y", "dx", "dw"), ours, theirs, control):
        assert np.abs(o - t).max() <= np.abs(c - t).max(), (what, np.abs(o - t).max())
    print(f"{case} {layer}: outputs that differ from flax: port {np.sum(ours[0] != theirs[0])}, "
          f"fused bias {np.sum(fused != theirs[0])} of {fused.size}")
    assert np.sum(ours[0] != theirs[0]) < np.sum(fused != theirs[0])
    for what, o, t, e in zip(("product", "dx", "dw"), (prod, *ours[1:]),
                             (product, *theirs[1:]), exact):
        mine, jax_count = np.sum(o != e), np.sum(t != e)
        print(f"  {what}: entries off the float64 product rounded once: port {mine}, "
              f"JAX {jax_count} of {e.size}")
        assert mine <= max(20, 10 * jax_count), (what, mine, jax_count)


# --------------------------------------------------------------------------
# train(): 2 hyp=fb1 steps
# --------------------------------------------------------------------------

BASE = [
    "model=resnet20", "model.width=8", "hyp=fb1", "data.size=32",
    "data.path=/tmp/__torch_nodata__", "data.batch_size=16", "hyp.sub_batch=8",
    "hyp.steps=2", "hyp.warmup=0", "impl.validate_every_nth_step=1",
    "data.augmentations_train=", "impl.mixed_precision=False", "impl.block_grouping=1",
    "impl.eval_block_chunks=1", "seed=0", "name=half_parity",
]
CASES = {
    "float32": [],
    "float16-compute": ["impl.compute_dtype=float16"],
    "float16-params": ["impl.dtype=float16", "impl.accumulation_dtype=float16"],
    "bfloat16-params": ["impl.dtype=bfloat16"],
}
HELD = ("train_loss", "valid_loss", "full_loss", "grad_norm")
# the JAX runs each case's tolerances come from: weights 2^-11 off, and
# where the squared norms are float16 sums, those sums in the reverse order
CONTROLS = {"float16-compute": ("perturbed",), "float16-params": ("perturbed", "reversed"),
            "bfloat16-params": ("perturbed",)}


@functools.cache
def _initial():
    cfg = jax_load_config(CONFIG, overrides=BASE)
    bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
    return jax.device_get(jax_models.initialize_model(model, jax.random.key(0), bundle.pixels,
                                                      bundle.channels))


def _reversed_sqnorm(tree):
    return sum(jnp.sum(jnp.square(leaf)) for leaf in reversed(jax.tree.leaves(tree)))


@functools.cache
def _jax_run(case, control=None):
    """The JAX ``train()`` of ``case`` from ``_initial()``: as it ships, or
    with its params each ``ULP16`` off (``control="perturbed"``), or with
    every squared norm summed over the leaves in the reverse order
    (``control="reversed"``). Returns ``(params, batch_stats, stats)``."""
    variables = _initial()
    if control == "perturbed":
        variables = {**variables, "params": jax.tree.map(
            lambda a: _perturbed(a, 7).astype(np.float32), variables["params"])}
    cfg = jax_load_config(CONFIG, overrides=BASE + CASES[case])
    mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
    bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        if control == "reversed":
            mp.setattr(jax_training, "tree_sqnorm", _reversed_sqnorm)
        state, stats = jax_train(model, bundle, mesh, cfg)
    return jax.device_get(state.params), jax.device_get(state.batch_stats), stats


def _controls(case):
    return [_jax_run(case, control) for control in CONTROLS[case]]


def _port_run(case):
    cfg = load_config(CONFIG, overrides=BASE + CASES[case])
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    load_jax_variables(model, _initial())
    state, stats = train(model, bundle, cfg, device="cpu")
    return state.model, bundle, stats


@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_train_float16_matches_jax(case):
    """Under float32 master weights (``float16-compute``) the params carry
    float16 noise in any order of rounding, as far from the JAX float16
    params as from the float32 ones; the running stats, means of float16
    activations, and float16 params do not."""
    model, _, stats = _port_run(case)
    params, batch_stats, ref_stats = _jax_run(case)
    single = _jax_run("float32")
    ours = export_jax_variables(copy.deepcopy(model).double())
    for i, (what, ref) in enumerate((("params", params), ("batch_stats", batch_stats))):
        tol = max(_rel_l2(c[i], ref) for c in _controls(case))
        assert _rel_l2(ours[what], ref) <= tol, (what, _rel_l2(ours[what], ref), tol)
        if what == "batch_stats" or case == "float16-params":
            assert _rel_l2(ours[what], ref) < _rel_l2(ours[what], single[i]), what
    for key in HELD:
        for step, (o, r) in enumerate(zip(stats[key], ref_stats[key])):
            tol = max(abs(c[2][key][step] - r) for c in _controls(case))
            assert abs(o - r) <= tol, (key, step, o, r, tol)
    assert stats["train_acc"] == ref_stats["train_acc"]


@functools.cache
def _chunk_gradients(case):
    """One chunk's gradient (8 training images) at the weights of the 2 JAX
    steps of ``case``: ``(port, JAX float16, JAX float32, JAX float16 from
    weights 2^-11 off)`` as trees of the JAX params' layout. The port's
    runs through its ``Trainer`` (autocast under ``float16-compute``), the
    JAX one as its step takes it: params cast to float16."""
    params, batch_stats, _ = _jax_run(case)
    cfg = load_config(CONFIG, overrides=BASE + CASES[case])
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    images, labels = np.asarray(bundle.train.images[:8]), np.asarray(bundle.train.labels[:8])
    jcfg = jax_load_config(CONFIG, overrides=BASE + CASES[case])
    jmodel = jax_models.construct_model(jcfg.model, bundle.channels, bundle.classes)
    criterion = jax_loss_fn(jcfg.hyp, len(labels))

    def jax_grads(p, dtype):
        def loss(p_):
            x = jax_normalize(jnp.asarray(images), np.asarray(bundle.mean),
                              np.asarray(bundle.std), dtype)
            logits, _ = jmodel.apply({"params": jax.tree.map(lambda a: a.astype(dtype), p_),
                                      "batch_stats": batch_stats}, x, train=True,
                                     mutable=["batch_stats"])
            return criterion(logits.astype(jnp.float32), jnp.asarray(labels))
        return jax.tree.map(_f64, jax.grad(loss)(p))

    theirs, single = jax_grads(params, jnp.float16), jax_grads(params, jnp.float32)
    off = jax_grads(jax.tree.map(lambda a: jnp.asarray(_perturbed(a, 11), a.dtype), params),
                    jnp.float16)

    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    load_jax_variables(model, {"params": jax.tree.map(_f64, params),
                               "batch_stats": batch_stats})
    trainer = Trainer(model, bundle, cfg, torch.device("cpu"))
    logits = trainer.forward(model, trainer._normalize(torch.as_tensor(images)))
    grads = torch.autograd.grad(trainer.criterion(logits, torch.as_tensor(labels).long()),
                                trainer.params)
    probe = copy.deepcopy(model).double()
    for p, g in zip(probe.parameters(), grads):
        p.data.copy_(g)
    ours = export_jax_variables(probe)["params"]
    return ours, theirs, single, off


@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_float16_gradient_underflow_matches_jax(case):
    """One chunk's gradient (:func:`_chunk_gradients`). Float16 underflows
    entries to exactly zero that float32 keeps."""
    ours, theirs, single, off = _chunk_gradients(case)

    assert _rel_l2(ours, theirs) <= _rel_l2(off, theirs), (_rel_l2(ours, theirs),
                                                           _rel_l2(off, theirs))
    assert _rel_l2(ours, theirs) < _rel_l2(ours, single)
    assert _zeros(single) < _zeros(theirs)
    assert abs(_zeros(ours) - _zeros(theirs)) < abs(_zeros(ours) - _zeros(single)), (
        _zeros(ours), _zeros(theirs), _zeros(off), _zeros(single))
    print(f"exactly-zero entries: port {_zeros(ours)}, JAX float16 {_zeros(theirs)}, "
          f"JAX float16 from weights 2^-11 off {_zeros(off)}, JAX float32 {_zeros(single)} "
          f"of {sum(np.size(a) for a in jax.tree.leaves(theirs))}")


@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_float16_gradient_zero_count_within_jax_noise(case):
    """The chunk gradient's count of exactly-zero entries lies within 10x
    the control's distance of the JAX count (20 entries at least), and each
    layer-3 leaf, whose gradient lies wholly below float16's normal range,
    within 10x the control's relative L2 of that leaf. Prints the per-leaf
    counts: port, JAX, control."""
    ours, theirs, _, off = _chunk_gradients(case)
    rows = []
    for (path, o), t, c in zip(jax.tree_util.tree_flatten_with_path(ours)[0],
                               jax.tree.leaves(theirs), jax.tree.leaves(off)):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        norm = np.linalg.norm(t)
        rows.append((name, *(int(np.sum(a == 0)) for a in (o, t, c)),
                     np.linalg.norm(o - t) / norm, np.linalg.norm(c - t) / norm))
    print(f"{case}: leaf, exactly-zero entries (port, JAX, JAX from weights 2^-11 off), "
          "relative L2 to JAX (port, control)")
    for name, zo, zt, zc, ro, rc in rows:
        print(f"  {name:45s} {zo:6d} {zt:6d} {zc:6d}  {ro:.3e} {rc:.3e}")
    counts = [_zeros(t) for t in (ours, theirs, off)]
    print(f"  total {counts}")
    assert abs(counts[0] - counts[1]) <= _zero_limit(counts[2], counts[1]), counts
    layer3 = [r for r in rows if r[0].startswith("layer3_")]
    assert len(layer3) == 21     # 3 blocks of 6 leaves, and the downsample's 3
    for name, *_, ro, rc in layer3:
        assert ro <= 10 * rc, (name, ro, rc)


def _block_inputs(seed):
    """Seeded float16 inputs of ``layer3_block2`` at 8 images: the block's
    input (a ReLU's output), its output's cotangent, ``bn2``'s input (a
    conv's output) and ``bn2``'s output cotangent (through the block's last
    ReLU: a quarter zero, a mean per channel), all ``[8, 8, 8, 32]`` NHWC."""
    rng = np.random.default_rng(seed)
    c = BN2_SHAPE[-1]
    block_x = np.maximum(rng.standard_normal(BN2_SHAPE) + 0.3, 0)
    block_cot = (rng.standard_normal(BN2_SHAPE) + 2 * rng.standard_normal(c)) * 1e-4
    bn_x = rng.standard_normal(BN2_SHAPE) * 0.7 + 0.8
    bn_cot = (rng.uniform(size=BN2_SHAPE) > 0.25) * block_cot
    return [_f64(jnp.asarray(a, jnp.float16)) for a in (block_x, block_cot, bn_x, bn_cot)]


def _port_block(case):
    """The port's ``layer3_block2`` (train mode) at the 2 JAX steps' weights
    and how its ``Trainer`` runs it: float16 params, or float32 params
    under float16 autocast."""
    params, batch_stats, _ = _jax_run(case)
    _, model = _resnet20()
    load_jax_variables(model, {"params": jax.tree.map(_f64, params), "batch_stats": batch_stats})
    half = case == "float16-params"
    place_model(model, "cpu", torch.float16 if half else torch.float32)
    autocast = torch.autocast("cpu", dtype=torch.float16, enabled=not half)
    return model.layer3_block2.train(), autocast


def _port_vjp(module, autocast, x, cot):
    """``(output, input gradient, param gradients as a JAX tree)`` of a port
    module on NHWC float16 ``x`` and ``cot``."""
    tx = torch.tensor(x, dtype=torch.float16, requires_grad=True)
    with autocast:
        y = module(tx.permute(0, 3, 1, 2))   # channels_last NCHW, as the model's
    params = list(module.parameters())
    grads = torch.autograd.grad(y, [tx] + params,
                                torch.tensor(cot, dtype=torch.float16).permute(0, 3, 1, 2))
    probe = copy.deepcopy(module).double()
    for p, g in zip(probe.parameters(), grads[1:]):
        p.data.copy_(g)
    return (y.detach().permute(0, 2, 3, 1).double().numpy(), grads[0].double().numpy(),
            export_jax_variables(probe)["params"])


def _jax_vjp(module, params, stats, x, cot):
    """The same of a JAX module, its params cast to float16 as the step does."""
    def fn(p, x_):
        p = jax.tree.map(lambda a: a.astype(jnp.float16), p)
        return module.apply({"params": p, "batch_stats": stats}, x_, train=True,
                            mutable=["batch_stats"])[0]
    y, vjp = jax.vjp(fn, params, jnp.asarray(x, jnp.float16))
    dp, dx = vjp(jnp.asarray(cot, jnp.float16))
    return _f64(y), _f64(dx), jax.tree.map(_f64, dp)


@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_layer3_block_float16_matches_jax(case):
    """The chunk gradient's parts, in ``layer3_block2`` at the 2 JAX steps'
    weights, fed the same seeded float16 inputs in both packages: (a) the
    ``bn2`` forward, (b) its backward, (c) the block's backward through
    ReLU, the residual add and ``conv2``. Values within the control (JAX from
    inputs 2^-11 off; for (c), 10x its relative L2), and counts of exactly
    zero entries within 10x its distance (20 entries at least)."""
    params, batch_stats, _ = _jax_run(case)
    jp, js = params["layer3_block2"], batch_stats["layer3_block2"]
    block, autocast = _port_block(case)
    block_x, block_cot, bn_x, bn_cot = _block_inputs(21)
    off = [_perturbed(a, 22 + i) for i, a in enumerate((block_x, block_cot, bn_x, bn_cot))]

    jbn = JaxBatchNorm2d(BN2_SHAPE[-1])
    ours = _port_vjp(block.bn2, autocast, bn_x, bn_cot)
    theirs = _jax_vjp(jbn, jp["bn2"], js["bn2"], bn_x, bn_cot)
    control = _jax_vjp(jbn, jp["bn2"], js["bn2"], off[2], off[3])
    for what, o, t, c in (("(a) bn2 y", ours[0], theirs[0], control[0]),
                          ("(b) bn2 dx", ours[1], theirs[1], control[1]),
                          ("(b) bn2 dscale", ours[2]["bn"]["scale"], theirs[2]["bn"]["scale"],
                           control[2]["bn"]["scale"]),
                          ("(b) bn2 dbias", ours[2]["bn"]["bias"], theirs[2]["bn"]["bias"],
                           control[2]["bn"]["bias"])):
        zeros = [int(np.sum(a == 0)) for a in (o, t, c)]
        err, tol = np.abs(o - t).max(), np.abs(c - t).max()
        print(f"{case} {what}: exactly zero (port, JAX, control) {zeros} of {t.size}; "
              f"max |port - JAX| {err:.3g}, control {tol:.3g}")
        assert err <= tol, (what, err, tol)
        assert abs(zeros[0] - zeros[1]) <= _zero_limit(zeros[2], zeros[1]), (what, zeros)
    assert 0 < np.abs(theirs[1]).max() < 6.1e-5        # dx below float16's normal range

    conv, norm, nonlin = jax_layer_functions("Standard", "BatchNorm2d", "ReLU")
    jblock = JaxBasicBlock(planes=BN2_SHAPE[-1], stride=1, conv=conv, norm=norm, nonlin=nonlin,
                           use_bias=False)
    ours = _port_vjp(block, autocast, block_x, block_cot)
    theirs = _jax_vjp(jblock, jp, js, block_x, block_cot)
    control = _jax_vjp(jblock, jp, js, off[0], off[1])
    for what, o, t, c in [("(c) block dx", ours[1], theirs[1], control[1])] + [
            (f"(c) block d{name}", *(tree[name]["kernel"] for tree in
                                     (ours[2], theirs[2], control[2])))
            for name in ("conv2", "conv1")]:
        zeros = [int(np.sum(a == 0)) for a in (o, t, c)]
        rel, tol = (np.linalg.norm(a - t) / np.linalg.norm(t) for a in (o, c))
        print(f"{case} {what}: exactly zero (port, JAX, control) {zeros} of {t.size}; "
              f"relative L2 to JAX {rel:.3g}, control {tol:.3g}")
        assert rel <= 10 * tol, (what, rel, tol)
        assert abs(zeros[0] - zeros[1]) <= _zero_limit(zeros[2], zeros[1]), (what, zeros)


@pytest.mark.parametrize("case", ["bfloat16-params", "float16-params"])
def test_half_params_keep_float32_running_stats(case):
    """The repair of the running stats' dtype: float32 beside half params, as
    the JAX ``batch_stats``, within the control of them; and eval-mode logits
    of the validation images on the JAX weights within the control (the JAX
    model's logits from inputs 2^-11 off)."""
    model, bundle, _ = _port_run(case)
    params, batch_stats, _ = _jax_run(case)
    half = {"bfloat16-params": torch.bfloat16, "float16-params": torch.float16}[case]
    assert {p.dtype for p in model.parameters()} == {half}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert {np.asarray(a).dtype for a in jax.tree.leaves(batch_stats)} == {np.dtype(np.float32)}
    ours = export_jax_variables(copy.deepcopy(model).double())["batch_stats"]
    tol = max(_rel_l2(c[1], batch_stats) for c in _controls(case))
    assert _rel_l2(ours, batch_stats) <= tol, (_rel_l2(ours, batch_stats), tol)

    cfg = jax_load_config(CONFIG, overrides=BASE + CASES[case])
    jmodel = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
    images = bundle.valid.images[:16]
    mean, std = np.asarray(bundle.mean), np.asarray(bundle.std)
    x = (images / 255.0 - mean) / std
    jdtype = jnp.bfloat16 if half == torch.bfloat16 else jnp.float16

    def jax_logits(x_, dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        return _f64(jmodel.apply({"params": p, "batch_stats": batch_stats},
                                 jnp.asarray(x_, dtype), train=False).astype(jnp.float32))

    theirs = jax_logits(x, jdtype)
    tol = _rel_l2(jax_logits(_perturbed(x, 9), jdtype), theirs)
    tmodel = construct_model(cfg.model, bundle.channels, bundle.classes)
    load_jax_variables(tmodel, {"params": jax.tree.map(_f64, params),
                                "batch_stats": batch_stats})
    place_model(tmodel, "cpu", half).eval()
    tx = torch.tensor(np.asarray(jnp.asarray(x, jdtype).astype(jnp.float32))).to(half)
    with torch.no_grad():
        logits = tmodel(tx).double().numpy()
    assert _rel_l2(logits, theirs) <= tol, (_rel_l2(logits, theirs), tol)
