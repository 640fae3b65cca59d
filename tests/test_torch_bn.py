"""The port's BatchNorm (ops/bn.py, models/layers.py) against the JAX package.

On the CPU the port's ``BNTrain`` runs the kernels' plain versions with its
real glue (the coefficient math between the kernels). It is held against
``pallas_bn.bn_train`` in interpret mode (where the Pallas path can tile the
rows) and ``pallas_bn.bn_train_reference``, for float32 and bfloat16. Those
compute their statistics in float32 always; for float64 the oracle is the
same formula in float64, the rule of ``_TorchBatchNorm`` (statistics in
promote(x.dtype, float32)). Tolerances: float32 1e-5 (summation order),
bfloat16 2e-2 (one bf16 rounding of y and dx), float64 1e-12. BNTrain's
double backward is held against ``bn_train_reference`` differentiated twice,
in float64: first order 1e-12, second order 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.models.layers import BatchNorm2d as FlaxBatchNorm2d
from fullbatchtraining_tpu.ops import pallas_bn
from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d
from fullbatchtraining_tpu_torch.ops import bn

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float64": 1e-12}
STAT_TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
CASES = [
    ((4, 8, 8, 64), "float32"),
    ((2, 4, 4, 96), "bfloat16"),
    ((128, 40), "float32"),
    ((3, 5, 7, 24), "float32"),    # M = 105 rows: ragged for any tile
    ((3, 5, 7, 24), "bfloat16"),
    ((4, 8, 8, 64), "float64"),
    ((3, 5, 7, 24), "float64"),
]
IDS = [f"{'x'.join(map(str, s))}-{d}" for s, d in CASES]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_bn, "_INTERPRET", True)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale + shift


def _reference_f64(x, scale, bias, eps=1e-5):
    """bn_train_reference's formula with float64 statistics."""
    axes = tuple(range(x.ndim - 1))
    mean = jnp.mean(x, axes)
    var = jnp.mean(jnp.square(x), axes) - jnp.square(mean)
    y = (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias
    return y, mean, var


def _oracles(x, dtype):
    """(name, fn) of the JAX functions the port is held against."""
    if dtype == "float64":
        return [("reference_f64", _reference_f64)]
    out = [("reference", pallas_bn.bn_train_reference)]
    if pallas_bn.supported(x):
        out.append(("pallas", pallas_bn.bn_train))
    return out


def _inputs(shape, dtype):
    c = shape[-1]
    x = _rand(shape, 0, 1.5, 0.3)
    scale = _rand((c,), 1) * 0.5 + 1.0
    bias = _rand((c,), 2)
    cot = _rand(shape, 3)
    sdtype = "float64" if dtype == "float64" else "float32"
    return x, scale.astype(sdtype), bias.astype(sdtype), cot


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype, grad=False):
    rounded = np.asarray(jnp.asarray(a, getattr(jnp, dtype))).astype(np.float64)
    t = torch.tensor(rounded, dtype=getattr(torch, dtype))
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _close(ours, ref, tol, what):
    ref = np.asarray(ref).astype(np.float64)
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_forward_matches_jax(shape, dtype):
    x, scale, bias, _ = _inputs(shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        jx = _jax(x, dtype)
        y, mean, var = bn.bn_train(_torch(x, dtype), torch.tensor(scale), torch.tensor(bias))
        assert y.dtype == getattr(torch, dtype) and y.shape == shape
        for name, fn in _oracles(jx, dtype):
            y_ref, mean_ref, var_ref = fn(jx, jnp.asarray(scale), jnp.asarray(bias))
            _close(_np(y), y_ref, TOL[dtype], f"{name} y")
            _close(_np(mean), mean_ref, STAT_TOL[dtype], f"{name} mean")
            _close(_np(var), var_ref, STAT_TOL[dtype], f"{name} var")


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_backward_matches_jax(shape, dtype):
    """Full backward with mean and var as functions of x, at non-zero scales
    (a zero-init scale would hide a wrong dx)."""
    x, scale, bias, cot = _inputs(shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        jx, jcot = _jax(x, dtype), _jax(cot, dtype)
        tx = _torch(x, dtype, grad=True)
        ts = torch.tensor(scale, requires_grad=True)
        tb = torch.tensor(bias, requires_grad=True)
        y, _, _ = bn.bn_train(tx, ts, tb)
        grads = torch.autograd.grad(y, (tx, ts, tb), grad_outputs=_torch(cot, dtype))
        for name, fn in _oracles(jx, dtype):
            def loss(x_, s_, b_):
                return jnp.sum(fn(x_, s_, b_)[0] * jcot)

            ref = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(scale), jnp.asarray(bias))
            for what, ours, r in zip(("dx", "dscale", "dbias"), grads, ref):
                _close(_np(ours), r, TOL[dtype], f"{name} {what}")


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_mean_var_cotangents(shape, dtype):
    """The mean/var outputs feed the running stats; their cotangents are zero
    in training, but the backward must be right when they are not."""
    x, scale, bias, _ = _inputs(shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        jx = _jax(x, dtype)
        tx = _torch(x, dtype, grad=True)
        y, mean, var = bn.bn_train(tx, torch.tensor(scale), torch.tensor(bias))
        total = y.to(mean.dtype).sum() + (mean * 3.0).sum() + (var * 0.5).sum()
        (dx,) = torch.autograd.grad(total, (tx,))
        for name, fn in _oracles(jx, dtype):
            def agg(x_):
                y_, m_, v_ = fn(x_, jnp.asarray(scale), jnp.asarray(bias))
                return (jnp.sum(y_.astype(m_.dtype)) + jnp.sum(m_ * 3.0)
                        + jnp.sum(v_ * 0.5))

            _close(_np(dx), jax.grad(agg)(jx), TOL[dtype], f"{name} dx")


def test_kernels_take_only_their_dtypes():
    with pytest.raises(TypeError):
        bn.stats(torch.zeros(4, 3, dtype=torch.int32))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm2d_matches_flax(train):
    """BatchNorm2d against the flax layer it ports, in float64: outputs and
    updated running stats (unbiased n/(n-1) variance, momentum 0.9)."""
    shape, c = (3, 6, 5, 16), 16
    x = _rand(shape, 4, 2.0, -0.5)
    params = {"scale": _rand((c,), 5) * 0.3 + 1.0, "bias": _rand((c,), 6)}
    stats = {"mean": _rand((c,), 7), "var": np.abs(_rand((c,), 8)) + 0.5}
    with jax.enable_x64(True):
        layer = FlaxBatchNorm2d(c)
        variables = {"params": {"bn": params}, "batch_stats": {"bn": stats}}
        if train:
            y_ref, upd = layer.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
            stats_ref = upd["batch_stats"]["bn"]
        else:
            y_ref, stats_ref = layer.apply(variables, jnp.asarray(x), train=False), stats

    module = BatchNorm2d(c).to(torch.float64)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(params["scale"]))
        module.bias.copy_(torch.from_numpy(params["bias"]))
        module.running_mean.copy_(torch.from_numpy(stats["mean"]))
        module.running_var.copy_(torch.from_numpy(stats["var"]))
    module.train(train)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW view
    with torch.set_grad_enabled(train):
        y = module(tx)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_np(y.permute(0, 2, 3, 1)), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(module.running_mean.numpy(), stats_ref["mean"], rtol=1e-12)
    np.testing.assert_allclose(module.running_var.numpy(), stats_ref["var"], rtol=1e-12)


# --------------------------------------------------------------------------
# the launch plan of the four kernels: a pure function
# --------------------------------------------------------------------------

H100_SMS = 132
KERNEL_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
# ResNet-18's BN inputs [M, C] on CIFAR (32x32): stages at H*W = 1024 ... 16,
# for chunks of 2048 (the bf16 bench shape) and 512 images (fp32, evaluation)
RESNET18_STAGES = [(1024, 64), (256, 128), (64, 256), (16, 512)]
ALIGNED = 0x7F3A_0000_0200   # a caching-allocator address (512-byte aligned)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
@pytest.mark.parametrize("hw,c", RESNET18_STAGES, ids=lambda v: str(v))
def test_launch_plan_takes_16_bytes_on_resnet18(hw, c, dtype):
    for images in (2048, 512, 8):
        m = images * hw
        g, vec = bn.launch_plan(H100_SMS, m, c, dtype, ALIGNED, ALIGNED + m * c * dtype.itemsize)
        assert vec * dtype.itemsize == 16
        assert 1 <= g <= 3 * H100_SMS


@pytest.mark.parametrize("c,dtype,offset", [
    (12, torch.bfloat16, 0),     # 12 % 8
    (3, torch.float32, 0),
    (6, torch.float32, 0),       # 6 % 4
    (3, torch.float64, 0),
    (64, torch.bfloat16, 2),     # buf[1:] of a bf16 buffer
    (64, torch.float32, 4),
    (64, torch.float64, 8),
    (520, torch.bfloat16, 8),    # 8-byte aligned is not enough
], ids=str)
def test_launch_plan_takes_one_element_where_16_bytes_cannot(c, dtype, offset):
    _, vec = bn.launch_plan(H100_SMS, 333, c, dtype, ALIGNED, ALIGNED + offset)
    assert vec == 1


@pytest.mark.parametrize("c,dtype", [(4096, torch.bfloat16), (520, torch.float64),
                                     (2048, torch.bfloat16), (1024, torch.float32)], ids=str)
def test_launch_plan_checks_every_address(c, dtype):
    """One operand off alignment (the input, the output, or dy) is enough
    for one element a thread; rows wider than a block take 16 bytes too."""
    step = dtype.itemsize
    assert bn.launch_plan(H100_SMS, 333, c, dtype, ALIGNED, ALIGNED + 512)[1] * step == 16
    for addresses in [(ALIGNED + step, ALIGNED), (ALIGNED, ALIGNED + step),
                      (ALIGNED, ALIGNED, ALIGNED + 16 + step)]:
        assert bn.launch_plan(H100_SMS, 333, c, dtype, *addresses)[1] == 1


@pytest.mark.parametrize("sms", [1, 132, 144])
def test_launch_plan_row_blocks_depend_on_sms_m_and_c_alone(sms):
    """G is the same for every dtype and address, at most 3 blocks an SM,
    and no block under 8192 elements unless one block holds everything."""
    for m in (1, 333, 16 * 512, 2048 * 1024):
        for c in (3, 12, 64, 512, 4096):
            gs = {bn.launch_plan(sms, m, c, dtype, ALIGNED + off)[0]
                  for dtype in KERNEL_DTYPES for off in (0, 2, 4, 8)}
            assert len(gs) == 1, (m, c, gs)
            (g,) = gs
            assert 1 <= g <= 3 * sms
            assert g == 1 or m * c >= 8192 * (g - 1)
    assert bn.launch_plan(sms, 2048 * 1024, 64, torch.bfloat16, ALIGNED)[0] == 3 * sms


# [M, C] operands of each kernel's C entry point, output included
OPERANDS = {"stats": 1, "apply": 2, "bwd_reduce": 2, "bwd_apply": 3}


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
@pytest.mark.parametrize("name", list(OPERANDS))
def test_launch_plan_for_each_kernels_operands(name, dtype):
    """All operands aligned take 16 bytes; any one of them off alignment, by
    an element or by 8 bytes, takes one element a thread."""
    m, c = 2048 * 16, 512
    size = m * c * dtype.itemsize
    aligned = [ALIGNED + k * size for k in range(OPERANDS[name])]
    assert bn.launch_plan(H100_SMS, m, c, dtype, *aligned)[1] * dtype.itemsize == 16
    for k in range(OPERANDS[name]):
        for off in {dtype.itemsize, 8}:
            addresses = list(aligned)
            addresses[k] += off
            assert bn.launch_plan(H100_SMS, m, c, dtype, *addresses)[1] == 1, (k, off)


def test_cpu_tensors_launch_nothing():
    before = (dict(bn.launches), dict(bn.vector_launches))
    x, dy = torch.randn(64, 16), torch.randn(64, 16)
    ab, coef = torch.randn(2, 16), torch.randn(3, 16)
    torch.testing.assert_close(bn.stats(x), bn.stats_plain(x))
    torch.testing.assert_close(bn.apply(x, ab), bn.apply_plain(x, ab))
    torch.testing.assert_close(bn.bwd_reduce(dy, x), bn.bwd_reduce_plain(dy, x))
    torch.testing.assert_close(bn.bwd_apply(dy, x, coef), bn.bwd_apply_plain(dy, x, coef))
    assert (bn.launches, bn.vector_launches) == before
    assert set(bn.vector_launches) == set(bn.launches)


# --------------------------------------------------------------------------
# BNTrain differentiated twice (the exact Hessian-vector products of the
# gradient regularizer), in float64
# --------------------------------------------------------------------------

DOUBLE_SHAPES = [(3, 4, 5, 6), (40, 8)]


def _double_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.tensor(rng.standard_normal(shape) * 1.5 + 0.3, requires_grad=True)
    scale = torch.tensor(rng.standard_normal(c) * 0.5 + 1.0, requires_grad=True)
    bias = torch.tensor(rng.standard_normal(c), requires_grad=True)
    # cotangents of (y, mean, var), all non-zero, themselves differentiated
    cots = [torch.tensor(rng.standard_normal(s), requires_grad=True) for s in (shape, c, c)]
    return x, scale, bias, cots


@pytest.mark.parametrize("shape", DOUBLE_SHAPES, ids=str)
def test_bn_train_gradgradcheck(shape):
    x, scale, bias, cots = _double_inputs(shape)
    assert torch.autograd.gradgradcheck(
        lambda *a: bn.bn_train(*a), (x, scale, bias),
        grad_outputs=[c.detach() for c in cots])


@pytest.mark.parametrize("shape", DOUBLE_SHAPES, ids=str)
def test_double_backward_matches_reference(shape):
    """First-order values to 1e-12 and second-order ones to 1e-10 of
    ``bn_train_reference``'s, differentiated in every input and cotangent."""
    x, scale, bias, cots = _double_inputs(shape)
    inputs = (x, scale, bias, *cots)
    before = bn.double_backward_calls

    def derivatives(fn):
        first = torch.autograd.grad(fn(x, scale, bias), (x, scale, bias), cots,
                                    create_graph=True)
        vs = [torch.tensor(np.random.default_rng(7 + i).standard_normal(tuple(f.shape)))
              for i, f in enumerate(first)]
        # dbias = sum(dy) is linear in dy alone: the reference gives it no
        # graph to x, so only the first two enter the second derivative
        second = torch.autograd.grad(first[:2], inputs, vs[:2], allow_unused=True)
        return first, second

    first, second = derivatives(bn.bn_train)
    assert bn.double_backward_calls == before + 1
    first_ref, second_ref = derivatives(bn.bn_train_reference)
    for ours, ref, what in zip(first, first_ref, ("dx", "dscale", "dbias")):
        _close(_np(ours), _np(ref), 1e-12, what)
    for ours, ref, what in zip(second, second_ref, ("x", "scale", "bias", "dy", "dmean", "dvar")):
        if ref is None:
            assert ours is None or not ours.abs().max(), what
            continue
        _close(_np(ours), _np(ref), 1e-10, f"d2 {what}")
