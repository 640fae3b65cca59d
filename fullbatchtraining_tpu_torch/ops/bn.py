"""Train-mode BatchNorm: four CUDA kernels, their plain versions, and the
autograd Function that joins them.

Counterpart of ``fullbatchtraining_tpu/ops/pallas_bn.py``. The kernels live in
``csrc/bn_kernels.cu`` and work on the row-major ``[M, C]`` view of a
channels-last activation:

* ``stats``       per-channel ``(sum x, sum x^2)``           (``_stats_kernel``)
* ``apply``       ``y = a*x + b``, per-channel ``a``, ``b``   (``_apply_kernel``)
* ``bwd_reduce``  per-channel ``(sum dy, sum dy*x)``         (``_bwd_reduce_kernel``)
* ``bwd_apply``   ``dx = a*dy + c1 + c2*x``                  (``_bwd_apply_kernel``)

``bwd_apply`` rounds ``dx`` to the input type ``T`` once, as the Pallas
kernel does, or, with ``split=True``, ``T(a*dy) + T(c1 + c2*x)``: the ``dy``
path and the statistics' path rounded apart and added in ``T``. The second
is the ``dx`` that autodiff gives the JAX model's BatchNorm
(``_TorchBatchNorm`` casts ``x`` to float32 twice, for the statistics and to
normalise, so ``jax.grad`` returns the sum of two cotangents, each cast back
to ``T``); the model's :class:`BatchNorm2d` asks for it through
``bn_train(..., split_dx=True)``. For float32 and float64 the casts are
no-ops. In float16 below its normal range, where a rounding step is an
absolute 6e-8, the one rounding leaves more entries at exactly zero.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor; nothing falls back from one to the other. Inside
:func:`plain_versions` (``_build``'s, which ``pool.py`` reads too) the
plain versions run on CUDA too (tests and the chip smoke compare the two
that way). Each kernel launch adds one to ``launches[name]``.

Each kernel moves 16 bytes a thread per access where it can;
:func:`launch_plan` picks the width from ``C``, the dtype and the tensors'
addresses, and each launch at 16 bytes also adds one to
``vector_launches[name]``.

Sums and coefficients are kept in ``promote(x.dtype, float32)``: float32 for
float32, bfloat16 and float16 inputs, float64 for float64 (the rule of the
model's BatchNorm, ``_TorchBatchNorm.stat_dtype``). A float16 output
beyond 65504 rounds to inf, as the JAX kernels' does: nothing clamps it.

``BNTrain`` runs its backward through ``BNTrainBackward``, so it can be
differentiated twice; that double backward is plain PyTorch and counts its
calls in ``double_backward_calls``. ``BNEval``, the eval-mode BatchNorm
from running stats, runs ``apply`` forward and ``apply`` and ``bwd_reduce``
backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import plain_versions  # noqa: F401  (re-exported)

launches = {"stats": 0, "apply": 0, "bwd_reduce": 0, "bwd_apply": 0}
# launches that took the 16-byte width
vector_launches = dict.fromkeys(launches, 0)
# channels-last copies BNTrain had to make of an input or an incoming gradient
layout_copies = 0
# double backwards of BNTrain (BNTrainBackward.backward, plain PyTorch)
double_backward_calls = 0

# G: one wave of the blocks per SM that the kernels' __launch_bounds__ keep
# resident (csrc MIN_BLOCKS)
_BLOCKS_PER_SM = 3
_MIN_ELEMENTS_PER_BLOCK = 8192


def reset_counts() -> None:
    global layout_copies, double_backward_calls
    for counts in (launches, vector_launches):
        for name in counts:
            counts[name] = 0
    layout_copies = 0
    double_backward_calls = 0


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """promote(dtype, float32); the kernels take float32, bfloat16, float16
    and float64."""
    if dtype not in _build.SUFFIX:
        raise TypeError(f"BatchNorm kernels take float32, bfloat16, float16 or float64, "
                        f"not {dtype}")
    return torch.promote_types(dtype, torch.float32)


# --------------------------------------------------------------------------
# plain versions: the same functions in PyTorch
# --------------------------------------------------------------------------

def stats_plain(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(stat_dtype(x.dtype))
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def apply_plain(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    return (x.to(ab.dtype) * ab[0] + ab[1]).to(x.dtype)


def bwd_reduce_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = stat_dtype(x.dtype)
    dyf, xf = dy.to(acc), x.to(acc)
    return torch.stack([dyf.sum(0), (dyf * xf).sum(0)])


def bwd_apply_plain(dy: torch.Tensor, x: torch.Tensor, coef: torch.Tensor,
                    split: bool = False) -> torch.Tensor:
    dyf, xf = dy.to(coef.dtype), x.to(coef.dtype)
    if not split:
        return (dyf * coef[0] + coef[1] + xf * coef[2]).to(x.dtype)
    direct = (dyf * coef[0]).to(x.dtype).to(coef.dtype)
    stats_path = (coef[1] + xf * coef[2]).to(x.dtype).to(coef.dtype)
    return (direct + stats_path).to(x.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("bn_kernels")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in _build.SUFFIX.values():
        for name, nptr in (("stats", 3), ("apply", 3), ("bwd_reduce", 4), ("bwd_apply", 4),
                           ("bwd_apply_split", 4)):
            fn = getattr(lib, f"fbt_bn_{name}_{suffix}")
            fn.argtypes = [ptr] * nptr + [i64, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
    return lib


def launch_plan(sm_count: int, m: int, c: int, dtype: torch.dtype,
                *addresses: int) -> tuple[int, int]:
    """``(G, vec)``, the last two launch arguments of every kernel for
    ``[m, c]`` tensors of ``dtype`` at ``addresses`` (of every ``[M, C]``
    operand, output included) on a card with ``sm_count`` SMs.

    ``vec``, the channels a thread moves in one access, is ``16 / itemsize``
    where ``c`` is a multiple of that and every address is 16-byte aligned,
    else 1 (a view with a storage offset need not be aligned; the caching
    allocator's blocks are). ``G``, the row ranges, fills every SM's resident
    blocks once, with no fewer than ``_MIN_ELEMENTS_PER_BLOCK`` elements a
    block, and depends on ``(sm_count, m, c)`` alone. The summation order of
    the reductions follows ``G`` and ``vec`` (a thread's row lanes are
    ``vec`` wide), so it is fixed for a card, a shape and a width."""
    wide = 16 // dtype.itemsize
    vec = 1 if c % wide or any(a % 16 for a in addresses) else wide
    g = max(1, min(sm_count * _BLOCKS_PER_SM, -(-m * c // _MIN_ELEMENTS_PER_BLOCK)))
    return g, vec


def _use_kernel(*tensors: torch.Tensor) -> bool:
    device = tensors[0].device
    if device.type in ("cpu", "meta") or (_build.force_plain and device.type == "cuda"):
        return False   # meta: shapes only (the activation estimate's probe)
    if device.type != "cuda":
        raise RuntimeError(f"BatchNorm kernels run on CUDA or CPU tensors, not {device}")
    x = tensors[0]
    for t in tensors:
        if t.device != device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("BatchNorm kernel inputs must share device, dtype and shape")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("BatchNorm kernels take contiguous [M, C] tensors")
    if device.index != torch.cuda.current_device():
        raise RuntimeError(f"tensor on {device} but the current device is "
                           f"cuda:{torch.cuda.current_device()}")
    stat_dtype(x.dtype)
    return True


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"BatchNorm kernel {name} failed to launch: CUDA error {err}")


def _coefficients(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    acc = stat_dtype(x.dtype)
    if k.shape != (k.shape[0], x.shape[1]) or k.dtype != acc:
        raise ValueError(f"per-channel coefficients must be [{k.shape[0]}, {x.shape[1]}] {acc}")
    return k.contiguous()


def _plan(x: torch.Tensor, addresses: list[int]) -> tuple[int, int]:
    m, c = x.shape
    return launch_plan(_build.sm_count(x.device.index), m, c, x.dtype, *addresses)


def _launched(name: str, vec: int) -> None:
    launches[name] += 1
    if vec > 1:
        vector_launches[name] += 1


def _reduce(name: str, plain, *inputs: torch.Tensor) -> torch.Tensor:
    if not _use_kernel(*inputs):
        return plain(*inputs)
    x = inputs[-1]
    m, c = x.shape
    acc = stat_dtype(x.dtype)
    out = torch.empty((2, c), dtype=acc, device=x.device)
    if m == 0 or c == 0:
        return out.zero_()
    ptrs = [t.data_ptr() for t in inputs]
    g, vec = _plan(x, ptrs)
    ws = torch.empty((g, 2, c), dtype=acc, device=x.device)
    fn = getattr(_library(), f"fbt_bn_{name}_{_build.SUFFIX[x.dtype]}")
    stream = _build.stream(x.device.index)
    _check(fn(*ptrs, ws.data_ptr(), out.data_ptr(), m, c, g, vec, stream), name)
    _launched(name, vec)
    return out


def _elementwise(name: str, plain, coef: torch.Tensor, *inputs: torch.Tensor,
                 entry: str | None = None) -> torch.Tensor:
    """Kernel ``name`` through its entry point ``entry`` (default ``name``)."""
    if not _use_kernel(*inputs):
        return plain(*inputs, coef)
    x = inputs[-1]
    coef = _coefficients(x, coef)
    m, c = x.shape
    out = torch.empty_like(x)
    if m == 0 or c == 0:
        return out
    ptrs = [t.data_ptr() for t in (*inputs, out)]
    g, vec = _plan(x, ptrs)
    fn = getattr(_library(), f"fbt_bn_{entry or name}_{_build.SUFFIX[x.dtype]}")
    stream = _build.stream(x.device.index)
    _check(fn(*ptrs[:-1], coef.data_ptr(), ptrs[-1], m, c, g, vec, stream), name)
    _launched(name, vec)
    return out


def stats(x: torch.Tensor) -> torch.Tensor:
    """``[2, C]``: per-channel ``sum x`` and ``sum x^2`` of ``x [M, C]``."""
    return _reduce("stats", stats_plain, x)


def apply(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """``y = ab[0]*x + ab[1]`` per channel, in ``x.dtype``."""
    return _elementwise("apply", apply_plain, ab, x)


def bwd_reduce(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[2, C]``: per-channel ``sum dy`` and ``sum dy*x``."""
    return _reduce("bwd_reduce", bwd_reduce_plain, dy, x)


def bwd_apply(dy: torch.Tensor, x: torch.Tensor, coef: torch.Tensor,
              split: bool = False) -> torch.Tensor:
    """``dx = coef[0]*dy + coef[1] + coef[2]*x`` per channel, in ``x.dtype``;
    with ``split``, ``coef[0]*dy`` and ``coef[1] + coef[2]*x`` each rounded
    to ``x.dtype`` and added in it."""
    return _elementwise("bwd_apply", functools.partial(bwd_apply_plain, split=split), coef,
                        dy, x, entry="bwd_apply_split" if split else None)


# --------------------------------------------------------------------------
# the autograd Function (pallas_bn.bn_train and its custom VJP)
# --------------------------------------------------------------------------

def as_rows(t: torch.Tensor) -> torch.Tensor:
    """``[..., C]`` -> contiguous ``[M, C]``; a copy only for a strided input."""
    global layout_copies
    if not t.is_contiguous():
        # the activation estimate's probe on the meta device moves no data
        layout_copies += t.device.type != "meta"
        t = t.contiguous()
    return t.reshape(-1, t.shape[-1])


class BNTrain(torch.autograd.Function):
    """``(y, mean, biased var)`` over every axis but the trailing channel
    axis; differentiable in x, scale and bias with mean and var treated as
    functions of x, and correct for cotangents of mean and var too. Its
    backward is :class:`BNTrainBackward`, so it can be differentiated twice
    (``create_graph=True``); ``split_dx`` picks ``bwd_apply``'s rounding."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, scale, bias, eps: float, split_dx: bool = False):
        x2 = as_rows(x)
        n = x2.shape[0]
        acc = stat_dtype(x.dtype)
        sums = stats(x2)
        mean = sums[0] / n
        var = sums[1] / n - mean * mean  # E[x^2] - E[x]^2, as pallas_bn and layers.py
        invstd = torch.rsqrt(var + eps)
        a = scale.to(acc) * invstd
        b = bias.to(acc) - mean * a
        y = apply(x2, torch.stack([a, b]))
        # x itself, not its rows: under create_graph the saved input comes
        # back with its history, so the double backward reaches x's producer
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.eps, ctx.split_dx = eps, split_dx
        return y.view(x.shape), mean, var

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, invstd = ctx.saved_tensors
        x2 = as_rows(x)
        dy2 = as_rows(dy.to(x.dtype))
        dx, dscale, dbias = BNTrainBackward.apply(dy2, x2, scale, dmean, dvar,
                                                  mean.detach(), invstd, ctx.eps, ctx.split_dx)
        return dx.view(x.shape), dscale, dbias, None, None


class BNTrainBackward(torch.autograd.Function):
    """``(dx, dscale, dbias)`` of :class:`BNTrain` from ``dy [M, C]`` and the
    cotangents of mean and var: the ``bwd_reduce`` and ``bwd_apply`` kernels
    and the ``[C]`` glue between them, differentiable in
    ``(dy, x, scale, dmean, dvar)``.

    ``mean`` and ``invstd`` come in as values (BNTrain made them with grad
    mode off). The backward of this Function, the double backward of
    BNTrain, treats them as functions of x: it recomputes the train-mode BN
    backward from :func:`bn_train_reference` in ``stat_dtype`` under
    ``torch.enable_grad()`` and differentiates it. That is plain PyTorch by
    design, not a fallback: the JAX package has no kernel for this
    derivative either (its Hessian-vector products differentiate the plain
    ``_TorchBatchNorm``), and every first-order value still comes from the
    kernels. Each call adds one to ``double_backward_calls``."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, dy2, x2, scale, dmean, dvar, mean, invstd, eps: float,
                split_dx: bool = False):
        n = x2.shape[0]
        sums = bwd_reduce(dy2, x2)
        s1 = sums[0]                    # sum(dy)
        s2 = sums[1] - mean * s1        # sum(dy * (x - mean))
        a = scale.to(mean.dtype) * invstd
        # dx = a*dy + c1 + c2*x: the dy terms plus the cotangents of mean, var
        c2 = (-a * invstd * invstd * s2 + 2.0 * dvar) / n
        c1 = (-a * s1 + dmean) / n - c2 * mean
        dx = bwd_apply(dy2, x2, torch.stack([a, c1, c2]), split_dx)
        ctx.save_for_backward(dy2, x2, scale, dmean, dvar)
        ctx.eps = eps
        return dx, (s2 * invstd).to(scale.dtype), s1.to(scale.dtype)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, ddx, ddscale, ddbias):
        global double_backward_calls
        double_backward_calls += 1
        inputs = ctx.saved_tensors
        acc = stat_dtype(inputs[1].dtype)
        with torch.enable_grad(), torch.autocast(inputs[1].device.type, enabled=False):
            dy, x, scale, dmean, dvar = leaves = [t.detach().to(acc).requires_grad_()
                                                  for t in inputs]
            bias = torch.zeros_like(scale, requires_grad=True)
            outs = bn_train_reference(x, scale, bias, ctx.eps)
            first = torch.autograd.grad(outs, (x, scale, bias), (dy, dmean, dvar),
                                        create_graph=True)
            cotangents = [g.to(acc) for g in (ddx, ddscale, ddbias)]
            second = torch.autograd.grad(first, leaves, cotangents, allow_unused=True)
        return (*(None if g is None else g.to(t.dtype) for g, t in zip(second, inputs)),
                None, None, None, None)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
             split_dx: bool = False):
    """Train-mode batch norm of ``x [..., C]``: ``(y, mean, biased var)``.
    ``split_dx`` rounds the gradient's two parts apart (``bwd_apply``), as
    autodiff of the JAX model's BatchNorm does."""
    return BNTrain.apply(x, scale, bias, eps, split_dx)


class BNEval(torch.autograd.Function):
    """Eval-mode batch norm of ``x [..., C]`` from running statistics:
    ``y = a*x + b`` with ``a = scale * rsqrt(var + eps)`` and ``b = bias -
    mean * a`` folded in ``stat_dtype``, one ``apply`` launch. Differentiable
    in x, scale and bias (the running stats are constants): ``dx = a*dy`` is
    ``apply`` with ``[a, 0]``, and ``(sum dy, sum dy*x)`` from ``bwd_reduce``
    give ``dbias = sum dy`` and ``dscale = rsqrt(var + eps) * (sum dy*x -
    mean * sum dy)``. The backward is not differentiated again."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, scale, bias, mean, var, eps: float):
        x2 = as_rows(x)
        acc = stat_dtype(x.dtype)
        invstd = torch.rsqrt(var.to(acc) + eps)
        a = scale.to(acc) * invstd
        mean = mean.to(acc)
        y = apply(x2, torch.stack([a, bias.to(acc) - mean * a]))
        ctx.save_for_backward(x2, mean, invstd, a)
        ctx.shape, ctx.dtype = x.shape, scale.dtype
        return y.view(x.shape)

    @staticmethod
    @once_differentiable
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x2, mean, invstd, a = ctx.saved_tensors
        dy2 = as_rows(dy.to(x2.dtype))
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dx = apply(dy2, torch.stack([a, torch.zeros_like(a)])).view(ctx.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            sums = bwd_reduce(dy2, x2)
            dscale = (invstd * (sums[1] - mean * sums[0])).to(ctx.dtype)
            dbias = sums[0].to(ctx.dtype)
        return dx, dscale, dbias, None, None, None


def bn_eval(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm of ``x [..., C]`` from running ``mean`` and ``var``."""
    return BNEval.apply(x, scale, bias, mean, var, eps)


def bn_train_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-5):
    """Differentiable plain twin of :func:`bn_train` in stock PyTorch ops."""
    xf = x.to(stat_dtype(x.dtype))
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(xf.dtype) + bias.to(xf.dtype)
    return y.to(x.dtype), mean, var
