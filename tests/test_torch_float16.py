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
* 2 ``hyp=fb1`` steps of ``train()`` under ``impl.compute_dtype=float16``
  and under ``impl.dtype=float16`` from the JAX weights: params and
  running stats in relative L2, each step's losses and gradient norm; the
  running stats (and float16 params) closer to float16;
* one chunk's gradient at the weights of those 2 JAX steps, through the
  port's ``Trainer``: within the control, closer to float16, and with its
  count of exactly-zero entries (float16 underflow adds to float32's)
  closer to the JAX float16 count than to the float32 one;
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
from fullbatchtraining_tpu.models.modules import get_loss_fn as jax_loss_fn
from fullbatchtraining_tpu.ops import pallas_bn
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables, load_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
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


@pytest.mark.parametrize("case", ["float16-compute", "float16-params"])
def test_float16_gradient_underflow_matches_jax(case):
    """One chunk's gradient (8 training images) at the weights of the 2 JAX
    steps, the port's through its ``Trainer`` (autocast under
    ``float16-compute``), the JAX one as its step takes it: params cast to
    float16. Float16 underflows entries to exactly zero that float32 keeps."""
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

    assert _rel_l2(ours, theirs) <= _rel_l2(off, theirs), (_rel_l2(ours, theirs),
                                                           _rel_l2(off, theirs))
    assert _rel_l2(ours, theirs) < _rel_l2(ours, single)
    assert _zeros(single) < _zeros(theirs)
    assert abs(_zeros(ours) - _zeros(theirs)) < abs(_zeros(ours) - _zeros(single)), (
        _zeros(ours), _zeros(theirs), _zeros(off), _zeros(single))
    print(f"exactly-zero entries: port {_zeros(ours)}, JAX float16 {_zeros(theirs)}, "
          f"JAX float16 from weights 2^-11 off {_zeros(off)}, JAX float32 {_zeros(single)} "
          f"of {sum(np.size(a) for a in jax.tree.leaves(theirs))}")


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
