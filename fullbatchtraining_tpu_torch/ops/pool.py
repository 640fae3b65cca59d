"""Average pool over disjoint windows: two CUDA kernels, their plain
versions, the autograd Functions that join them, and the rule that picks
them.

The kernels live in ``csrc/pool_kernels.cu`` and pool a channels-last
``[N, C, H, W]`` tensor over ``k x k`` windows at stride ``k`` with no
padding, ``H`` and ``W`` multiples of ``k``:

* ``fwd``  ``y = mean`` of each window          (``avg_pool_nhwc_fwd``)
* ``bwd``  ``dx = dy / k^2`` at each of its window's positions
  (``avg_pool_nhwc_bwd``)

in float32, bfloat16, float16 and float64, with ATen's arithmetic: the
results are bitwise those of ``F.avg_pool2d`` and its gradient. No TPU kernel
stands behind them (the JAX package leaves the pool to XLA); they replace
ATen's NHWC pooling kernels on the main path.

:func:`route` is the rule ``layers.avg_pool`` follows, from what it sees of
its input: window == stride == 1 with no padding is the identity (nothing
launches); window == stride with no padding, ``H`` and ``W`` divisible and
one of the four dtypes takes :class:`AvgPool`; anything else (a padded
window, a ragged size) takes ``F.avg_pool2d``.

As in ``bn.py``, a CUDA tensor runs the kernel and a CPU tensor, or any
tensor inside ``plain_versions()`` (``_build``'s switch, which ``bn`` reads
too), the plain version: ``F.avg_pool2d`` and ATen's
``avg_pool2d_backward``. Each launch adds one to ``launches[name]``, and to
``vector_launches[name]`` at 16 bytes a thread (:func:`launch_plan`); an
input or incoming gradient that is not channels-last is made so and adds one
to ``layout_copies``. ``layers.avg_pool`` counts its identities in
``identity_calls`` and its calls of ``F.avg_pool2d`` in ``plain_calls``.

The kernels index their items in 32 bits, so :func:`route` leaves a pooled
side of ``_MAX_POOLED`` elements or more to ``F.avg_pool2d`` (no model of the
port comes near: an ImageNet chunk of 4096 pools about 10^8).

:class:`AvgPool` saves only the window: the backward needs no input. Its
backward is :class:`AvgPoolBackward`, whose own backward is the pool again,
so a double backward runs on the kernels too. A launch's entry point, grid
and widths are looked up once a shape (:func:`_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

launches = {"fwd": 0, "bwd": 0}
# launches that took the 16-byte width
vector_launches = dict.fromkeys(launches, 0)
# calls of layers.avg_pool that took F.avg_pool2d
plain_calls = 0
# calls of layers.avg_pool at window == stride == 1: the input itself, no launch
identity_calls = 0
# channels-last copies AvgPool had to make of an input or an incoming gradient
layout_copies = 0

_THREADS = 256         # csrc THREADS
_BLOCKS_PER_SM = 16    # the most blocks a launch gives an SM; the kernels' loop takes the rest
# the kernels' 32-bit index reaches items + grid * _THREADS < 2 * items + _THREADS,
# and items are at most the pooled side's elements: below this, that stays under 2^32
_MAX_POOLED = 2 ** 31 - _THREADS


def reset_counts() -> None:
    global plain_calls, identity_calls, layout_copies
    for counts in (launches, vector_launches):
        for name in counts:
            counts[name] = 0
    plain_calls = identity_calls = layout_copies = 0


def route(shape: torch.Size | tuple[int, ...], dtype: torch.dtype, window: int, stride: int,
          padding: int = 0) -> str:
    """``"identity"``, ``"kernel"`` or ``"plain"``: how ``layers.avg_pool``
    pools an input of ``shape`` and ``dtype``."""
    if len(shape) != 4 or window != stride or padding != 0:
        return "plain"
    if window == 1:
        return "identity"
    n, c, h, w = shape
    if (window > 1 and h % window == 0 and w % window == 0 and dtype in _build.SUFFIX
            and n * c * (h // window) * (w // window) < _MAX_POOLED):
        return "kernel"
    return "plain"


def launch_plan(sm_count: int, pixels: int, c: int, dtype: torch.dtype,
                *addresses: int) -> tuple[int, int]:
    """``(grid, vec)`` of a launch over ``pixels`` output pixels of ``c``
    channels of ``dtype``, operands at ``addresses``, on a card with
    ``sm_count`` SMs. ``vec``, the channels a thread moves in one access, is
    ``16 / itemsize`` where ``c`` is a multiple of it and every address is
    16-byte aligned, else 1. ``grid`` covers the ``pixels * c / vec`` items
    at one a thread, capped at ``_BLOCKS_PER_SM`` blocks an SM (the kernels'
    loop takes the rest)."""
    wide = 16 // dtype.itemsize
    vec = 1 if c % wide or any(a % 16 for a in addresses) else wide
    items = pixels * (c // vec)
    return max(1, min(-(-items // _THREADS), sm_count * _BLOCKS_PER_SM)), vec


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def forward_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x, k, k)


def backward_plain(dy: torch.Tensor, k: int) -> torch.Tensor:
    """ATen's gradient of ``F.avg_pool2d(x, k, k)``; it reads of ``x`` only
    its shape and layout, which a stand-in gives."""
    n, c, ho, wo = dy.shape
    layout = (torch.channels_last if dy.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    stand_in = torch.empty((n, c, ho * k, wo * k), dtype=dy.dtype, device=dy.device,
                           memory_format=layout)
    return torch.ops.aten.avg_pool2d_backward(dy, stand_in, [k, k], [k, k], [0, 0], False,
                                              True, None)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("pool_kernels")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in _build.SUFFIX.values():
        for name in ("fwd", "bwd"):
            fn = getattr(lib, f"fbt_pool_{name}_{suffix}")
            fn.argtypes = [ptr, ptr, i64, i64, i64, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def _plan(name: str, pooled: torch.Size, dtype: torch.dtype, index: int) -> tuple:
    """``(entry point, rows, wo, c, (grid, vec) at 16 bytes, (grid, 1))`` of
    a launch of ``name`` whose pooled side is ``pooled`` on card ``index``;
    the 16-byte plan is the one-element one where ``C`` does not allow it."""
    n, c, ho, wo = pooled
    fn = getattr(_library(), f"fbt_pool_{name}_{_build.SUFFIX[dtype]}")
    sms = _build.sm_count(index)
    return (fn, n * ho, wo, c, launch_plan(sms, n * ho * wo, c, dtype, 0),
            launch_plan(sms, n * ho * wo, c, dtype, 1))


def _use_kernel(t: torch.Tensor) -> bool:
    device = t.device
    if device.type in ("cpu", "meta") or (_build.force_plain and device.type == "cuda"):
        return False   # meta: shapes only (the activation estimate's probe)
    if device.type != "cuda":
        raise RuntimeError(f"pooling kernels run on CUDA or CPU tensors, not {device}")
    if device.index != torch.cuda.current_device():
        raise RuntimeError(f"tensor on {device} but the current device is "
                           f"cuda:{torch.cuda.current_device()}")
    if t.dim() != 4 or t.dtype not in _build.SUFFIX:
        raise ValueError(f"pooling kernels take 4-d float32, bfloat16, float16 or float64 "
                         f"tensors, not {t.dim()}-d {t.dtype}")
    return True


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    global layout_copies
    if not t.is_contiguous(memory_format=torch.channels_last):
        layout_copies += 1
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _run(name: str, src: torch.Tensor, dst: torch.Tensor, pooled: torch.Size,
         k: int) -> torch.Tensor:
    """Launch ``name`` from ``src`` into ``dst``; ``pooled`` is the pooled
    side's ``[N, C, H/k, W/k]`` shape."""
    if dst.numel() == 0:
        return dst
    index = src.device.index
    fn, rows, wo, c, wide, narrow = _plan(name, pooled, src.dtype, index)
    a, b = src.data_ptr(), dst.data_ptr()
    grid, vec = wide if (a | b) % 16 == 0 else narrow
    err = fn(a, b, rows, wo, c, k, grid, vec, _build.stream(index))
    if err != 0:
        raise RuntimeError(f"pooling kernel {name} failed to launch: CUDA error {err}")
    launches[name] += 1
    vector_launches[name] += vec > 1
    return dst


def pool_forward(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of each ``k x k`` window of ``x [N, C, H, W]``, at stride ``k``."""
    if not _use_kernel(x):
        return forward_plain(x, k)
    n, c, h, w = x.shape
    if h % k or w % k:
        raise ValueError(f"pooling kernels take H and W divisible by the window {k}, "
                         f"not {h} x {w}")
    x = _channels_last(x)
    y = torch.empty((n, c, h // k, w // k), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    return _run("fwd", x, y, y.shape, k)


def pool_backward(dy: torch.Tensor, k: int) -> torch.Tensor:
    """Gradient of :func:`pool_forward` for the incoming ``dy [N, C, H/k, W/k]``."""
    if not _use_kernel(dy):
        return backward_plain(dy, k)
    dy = _channels_last(dy)
    n, c, ho, wo = dy.shape
    dx = torch.empty((n, c, ho * k, wo * k), dtype=dy.dtype, device=dy.device,
                     memory_format=torch.channels_last)
    return _run("bwd", dy, dx, dy.shape, k)


# --------------------------------------------------------------------------
# the autograd Functions
# --------------------------------------------------------------------------

class AvgPool(torch.autograd.Function):
    """``F.avg_pool2d(x, k, k)`` on the kernels; saves only ``k``."""

    @staticmethod
    def forward(ctx, x, k: int):
        ctx.k = k
        return pool_forward(x, k)

    @staticmethod
    def backward(ctx, dy):
        if not torch.is_grad_enabled():   # a first-order backward records nothing
            return pool_backward(dy, ctx.k), None
        return AvgPoolBackward.apply(dy, ctx.k), None


class AvgPoolBackward(torch.autograd.Function):
    """The gradient of :class:`AvgPool`, linear in ``dy``; its own gradient
    is the pool of the incoming one."""

    @staticmethod
    def forward(ctx, dy, k: int):
        ctx.k = k
        return pool_backward(dy, k)

    @staticmethod
    def backward(ctx, ddx):
        return AvgPool.apply(ddx, ctx.k), None
