"""The port's pooling kernels (ops/pool.py) against ATen's, on the card.

Marked ``gpu``: they skip where CUDA is absent. Run them on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_pool_gpu.py

The kernels compute ATen's arithmetic, so forward and backward are held
bitwise (bit patterns, signed zeros included) to ``F.avg_pool2d`` and its
gradient, in float32, bfloat16, float16 and float64, at ResNet-18's three
downsample inputs at a chunk of 64, ResNet-152's four (window 1 at stage 1,
which ``layers.avg_pool`` leaves to the identity, and window 2), DenseNet-121's
first transition, and at the edges of the two widths: C of 3, 12, 40 and 520
(one that no 16-byte group divides in some dtype), window 3, one row, and an
operand 1 element off 16-byte alignment. ``-s`` on ``test_time_against_aten``
prints the kernels' and ATen's times at ResNet-18's inputs for a chunk of 4096
in bfloat16.
"""

import json
import statistics

import pytest
import torch
import torch.nn.functional as F

from fullbatchtraining_tpu_torch.ops import bn, pool

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
DTYPE_IDS = ["f32", "bf16", "f16", "f64"]
BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
SHAPES = {
    "r18-stage2": ((64, 64, 32, 32), 2),
    "r18-stage3": ((64, 128, 16, 16), 2),
    "r18-stage4": ((64, 256, 8, 8), 2),
    "r152-stage1": ((64, 64, 32, 32), 1),
    "r152-stage2": ((64, 256, 32, 32), 2),
    "r152-stage3": ((64, 512, 16, 16), 2),
    "r152-stage4": ((64, 1024, 8, 8), 2),
    "densenet121-transition1": ((64, 128, 32, 32), 2),
}
EDGE_C = [3, 12, 40, 520]
EDGES = {"k2": ((4, 6, 10), 2), "k3": ((3, 9, 6), 3), "one-row": ((1, 2, 10), 2)}
HBM_BYTES_PER_S = 3.35e12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    pool.reset_counts()
    return torch.device("cuda")


def _data(shape, dtype, device, seed, offset=0):
    """Channels-last ``[N, C, H, W]`` data; ``offset`` elements past the
    start of a flat buffer (an address 16-byte aligned only at offset 0)."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    flat = (torch.randn(n * c * h * w + offset, generator=g, device=device,
                        dtype=torch.float64) * 1.5 + 0.3).to(dtype)
    return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


def _assert_bitwise(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    bits = BITS[ours.dtype.itemsize]
    assert torch.equal(ours.contiguous().view(bits), ref.contiguous().view(bits))


def _pool_and_gradient(x, k, dy):
    """(y, dx) through ``AvgPool`` and through ``F.avg_pool2d``."""
    out = []
    for fn in (lambda t: pool.AvgPool.apply(t, k), lambda t: F.avg_pool2d(t, k, k)):
        leaf = x.detach().requires_grad_()
        y = fn(leaf)
        out.append((y.detach(), torch.autograd.grad(y, leaf, dy)[0]))
    return out


def _check(shape, k, dtype, device, offset=0):
    x = _data(shape, dtype, device, seed=1, offset=offset)
    n, c, h, w = shape
    dy = _data((n, c, h // k, w // k), dtype, device, seed=2, offset=offset)
    before = dict(pool.launches), dict(pool.vector_launches)
    (y, dx), (y_ref, dx_ref) = _pool_and_gradient(x, k, dy)
    torch.cuda.synchronize()
    _assert_bitwise(y, y_ref)
    _assert_bitwise(dx, dx_ref)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    launched = {name: pool.launches[name] - before[0][name] for name in pool.launches}
    wide = {name: pool.vector_launches[name] - before[1][name] for name in pool.launches}
    assert launched == {"fwd": 1, "bwd": 1}
    return wide


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_models_shapes_bitwise_aten(cuda, name, dtype):
    shape, k = SHAPES[name]
    assert _check(shape, k, dtype, cuda) == {"fwd": 1, "bwd": 1}
    assert pool.layout_copies == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("c", EDGE_C)
@pytest.mark.parametrize("edge", [*EDGES, "offset"])
def test_edges_bitwise_aten(cuda, edge, c, dtype):
    """Each width's edges; the 16-byte width only where C and both operands'
    addresses allow it."""
    (n, h, w), k = EDGES.get(edge, EDGES["k2"])
    offset = 1 if edge == "offset" else 0
    wide = 16 // dtype.itemsize
    vec = int(c % wide == 0 and offset == 0)
    assert _check((n, c, h, w), k, dtype, cuda, offset) == {"fwd": vec, "bwd": vec}


def test_other_layouts_are_made_channels_last(cuda):
    """An NCHW input and an NCHW incoming gradient are copied to
    channels-last (``layout_copies``) and pool as ATen does."""
    x = _data((8, 24, 8, 8), torch.float32, cuda, seed=3).contiguous()
    dy = _data((8, 24, 4, 4), torch.float32, cuda, seed=4).contiguous()
    (y, dx), (y_ref, dx_ref) = _pool_and_gradient(x, 2, dy)
    _assert_bitwise(y, y_ref)
    _assert_bitwise(dx, dx_ref)
    assert pool.layout_copies == 2


def test_gradgradcheck(cuda):
    x = _data((2, 6, 4, 6), torch.float64, cuda, seed=5).requires_grad_()
    assert torch.autograd.gradgradcheck(lambda t: pool.AvgPool.apply(t, 2), (x,))
    assert pool.launches["fwd"] > 0 and pool.launches["bwd"] > 0


def test_double_backward_runs_on_the_kernels(cuda):
    """The gradient of the gradient is the pool of the incoming one: one more
    ``fwd`` launch, ATen's values bitwise."""
    x = _data((8, 64, 16, 16), torch.bfloat16, cuda, seed=6)
    dy = _data((8, 64, 8, 8), torch.bfloat16, cuda, seed=7)
    ddx = _data((8, 64, 16, 16), torch.bfloat16, cuda, seed=8)
    results = []
    for fn in (lambda t: pool.AvgPool.apply(t, 2), lambda t: F.avg_pool2d(t, 2, 2)):
        leaf, cot = x.clone().requires_grad_(), dy.clone().requires_grad_()
        dx, = torch.autograd.grad(fn(leaf), leaf, cot, create_graph=True)
        results.append(torch.autograd.grad(dx, cot, ddx)[0])
    _assert_bitwise(*results)
    assert pool.launches == {"fwd": 2, "bwd": 1}


def test_entry_point_refuses_an_index_past_32_bits(cuda):
    """A launch whose loop index would pass 2^32 returns
    cudaErrorInvalidValue before it launches (``route`` sends such sizes to
    ``F.avg_pool2d``)."""
    for name in ("fwd", "bwd"):
        fn = getattr(pool._library(), f"fbt_pool_{name}_bf16")
        assert fn(None, None, 2 ** 32 - 255, 1, 1, 2, 1, 1, None) == 1
    assert pool.launches == {"fwd": 0, "bwd": 0}


def test_plain_versions_launch_nothing(cuda):
    x = _data((4, 64, 8, 8), torch.bfloat16, cuda, seed=9).requires_grad_()
    with bn.plain_versions():
        pool.AvgPool.apply(x, 2).sum().backward()
    assert pool.launches == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("model, identities", [("resnet18", 0), ("resnet152", 1)])
def test_resnet_chunk_launches(cuda, model, identities):
    """One chunk's forward and backward at full width in bfloat16 autocast:
    three ``fwd`` and three ``bwd`` launches (the downsample-C pools), none
    through ``F.avg_pool2d``; ResNet-152's stage-1 projection at stride 1 is
    the identity."""
    from pathlib import Path

    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.models import construct_model

    root = Path(__file__).resolve().parent.parent
    cfg = load_config(root / "config", overrides=[f"model={model}"])
    net = construct_model(cfg.model, 3, 10).to(cuda, memory_format=torch.channels_last)
    x = torch.randn((64, 32, 32, 3), device=cuda)
    pool.reset_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = net(x).float().sum()
    loss.backward()
    torch.cuda.synchronize()
    assert pool.launches == pool.vector_launches == {"fwd": 3, "bwd": 3}
    assert (pool.plain_calls, pool.identity_calls, pool.layout_copies) == (0, identities, 0)


def _cuda_ms(fn, calls=30, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def test_time_against_aten(cuda):
    """Forward and backward at ResNet-18's three downsample inputs for a chunk
    of 4096 in bfloat16: CUDA events over 30 calls after 3 warm-up, each the
    median of 3; the bound moves the input once and the output once at
    3.35 TB/s. The kernels must beat ATen's; the numbers print as JSON."""
    rows = []
    for c, hw in ((64, 32), (128, 16), (256, 8)):
        x = _data((4096, c, hw, hw), torch.bfloat16, cuda, seed=10)
        dy = _data((4096, c, hw // 2, hw // 2), torch.bfloat16, cuda, seed=11)
        bound = (x.numel() + dy.numel()) * x.element_size() / HBM_BYTES_PER_S * 1e3
        times = {
            "fwd": lambda: pool.pool_forward(x, 2),
            "fwd_aten": lambda: F.avg_pool2d(x, 2, 2),
            "bwd": lambda: pool.pool_backward(dy, 2),
            "bwd_aten": lambda: torch.ops.aten.avg_pool2d_backward(dy, x, [2, 2], [2, 2], [0, 0],
                                                                   False, True, None),
        }
        row = {"shape": [4096, c, hw, hw], "bound_ms": bound}
        for key, fn in times.items():
            row[f"{key}_ms"] = statistics.median(_cuda_ms(fn) for _ in range(3))
        rows.append(row)
        del x, dy
    total = {key: sum(r[key] for r in rows) for key in rows[0] if key.endswith("_ms")}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows, "chunk": total}))
    assert total["fwd_ms"] < total["fwd_aten_ms"] and total["bwd_ms"] < total["bwd_aten_ms"]
