"""Lower precisions for the controls of the comparison that decides
``correct``, and for looking at what a precision does on its own.

* ``tf32``: the operands of every convolution and product rounded to TF32
  (10 mantissa bits, to nearest) and accumulated in float32, as the tensor
  cores do with TF32 on; everything else float32. The step below float32
  with TF32 off.
* ``bf16`` and ``fp8``: a whole pipeline in that format, as autocast runs
  one: the normalised input, every activation a layer puts out and every
  gradient it passes back are rounded to the format, and so are the
  parameters where a layer uses them; products accumulate in float32 and
  BatchNorm's statistics are float32. fp8 rounds forward values to E4M3
  and gradients to E5M2, each tensor scaled by its own largest magnitude
  first (the usual recipe of fp8 training). ``fp8`` is the step below a
  bfloat16 configuration; ``bf16`` shows what bfloat16 alone does.
* ``bf16split``: ``bf16``, with BatchNorm's input gradient rounded the way
  autodiff of a BatchNorm that casts its bfloat16 input to float32 twice
  (once for the statistics, once to normalise) gives it: ``dx = a dy + c1 +
  c2 x`` as ``bf16(bf16(a dy) + bf16(c1 + c2 x))``, where ``bf16`` alone
  rounds once. The two parts are each about as large as ``dy``, and their
  sum is what is left once the batch's mean and its correlation with ``x``
  are taken out of ``dy``, so it carries the parts' rounding. It looks at
  what that rounding does to the small leaves; it has no double backward.

Rounding is done by hand, so a control reads the same on a CPU as on a
card. ``float32`` leaves everything as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import BN_EPS, update_stats_

PRECISIONS = ("float32", "tf32", "bf16", "bf16split", "fp8")
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view_as(x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def round_fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` scaled so its largest magnitude is the format's largest, cast to
    the fp8 format and back, unscaled."""
    dtype, top = _FP8[fmt]
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Rounded(torch.autograd.Function):
    """A value rounded on its way forward, its gradient on its way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, rnd)
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        stride, padding, rnd = ctx.conf
        gq = rnd(gy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding)
        return dx, dw, None, None, None


class _RoundedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rnd):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.rnd = rnd
        return xq @ wq.t() + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = ctx.rnd(gy)
        return gq @ wq, gq.t() @ xq, gy.sum(0), None


class _SplitBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of NCHW ``x`` (from its batch ``mean`` and
    ``invstd``) whose input gradient rounds its two parts apart, to bfloat16."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd):
        ctx.save_for_backward(x, weight, mean, invstd)
        a = weight * invstd
        return x * a[None, :, None, None] + (bias - mean * a)[None, :, None, None]

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        n = x.numel() / x.shape[1]
        s1 = dy.sum(dim=(0, 2, 3))
        s2 = (dy * (x - mean[None, :, None, None])).sum(dim=(0, 2, 3))
        a = weight * invstd
        c2 = -a * invstd * invstd * s2 / n
        c1 = -a * s1 / n - c2 * mean
        direct = round_bf16(dy * a[None, :, None, None])
        stats_path = round_bf16(c1[None, :, None, None] + x * c2[None, :, None, None])
        return round_bf16(direct + stats_path), s2 * invstd, s1, None, None


def split_batch_norm(x, weight, bias, stats, name, update_stats: bool):
    """:func:`.layers.batch_norm` with :class:`_SplitBatchNorm`'s gradient."""
    with torch.no_grad():
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    if update_stats:
        update_stats_(stats, name, mean, var, x.numel() / x.shape[1])
    return _SplitBatchNorm.apply(x, weight, bias, mean, torch.rsqrt(var + BN_EPS))


def layer_functions(precision: str):
    """``(conv, linear, act, norm)`` for a family's ``forward``: ``conv(x,
    w, stride, padding)``, ``linear(x, w, b)``, ``act(t)``, which rounds an
    activation or a parameter where a layer takes it, and BatchNorm; None
    for the plain float32 ones."""
    if precision == "float32":
        return None, None, None, None
    if precision == "tf32":
        return ((lambda x, w, stride, padding:
                 _RoundedConv.apply(x, w, stride, padding, round_tf32)),
                (lambda x, w, b: _RoundedLinear.apply(x, w, b, round_tf32)), None, None)
    norm = None
    if precision in ("bf16", "bf16split"):
        fwd = bwd = round_bf16
        norm = split_batch_norm if precision == "bf16split" else None
    elif precision == "fp8":
        fwd, bwd = (lambda t: round_fp8(t, "e4m3")), (lambda t: round_fp8(t, "e5m2"))
    else:
        raise ValueError(f"unknown precision {precision!r}")

    def act(t):
        return _Rounded.apply(t, fwd, bwd)

    return ((lambda x, w, stride, padding: act(F.conv2d(x, act(w), None, stride, padding))),
            (lambda x, w, b: act(F.linear(x, act(w), act(b)))), act, norm)
