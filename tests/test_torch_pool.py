"""The port's average pool (ops/pool.py, models/layers.py avg_pool) on the CPU.

``pool.route`` is the rule ``layers.avg_pool`` follows: the identity at
window == stride == 1, the kernels (``AvgPool``) for disjoint windows that
tile H and W in one of the four dtypes, ``F.avg_pool2d`` otherwise. On the
CPU ``AvgPool`` runs its plain versions (``F.avg_pool2d`` and ATen's
backward); forward, backward and double backward are held bitwise to
``F.avg_pool2d`` differentiated by autograd, and so is the identity. The
kernels themselves run in ``test_torch_pool_gpu.py`` on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from fullbatchtraining_tpu_torch.models import layers
from fullbatchtraining_tpu_torch.ops import pool

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
DTYPE_IDS = ["f32", "bf16", "f16", "f64"]


@pytest.fixture(autouse=True)
def _counts():
    pool.reset_counts()
    yield
    pool.reset_counts()


def _input(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 1.5 + 0.3).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


@pytest.mark.parametrize("shape, dtype, window, stride, padding, expected", [
    ((64, 64, 32, 32), torch.bfloat16, 2, 2, 0, "kernel"),     # ResNet-18 downsample C
    ((8, 256, 32, 32), torch.float32, 2, 2, 0, "kernel"),      # ResNet-152 stage 2
    ((8, 64, 32, 32), torch.float32, 1, 1, 0, "identity"),     # ResNet-152 stage 1
    ((8, 512, 7, 7), torch.float32, 1, 1, 0, "identity"),      # VGG's ImageNet head at 224 px
    ((8, 64, 32, 32), torch.int64, 1, 1, 0, "identity"),
    ((4, 12, 9, 6), torch.float64, 3, 3, 0, "kernel"),
    ((4, 12, 9, 6), torch.float16, 3, 3, 0, "kernel"),
    ((8, 64, 32, 32), torch.float32, 2, 2, 1, "plain"),        # NFNet's padded shortcut
    ((8, 64, 32, 32), torch.float32, 1, 1, 1, "plain"),
    ((8, 64, 7, 7), torch.float32, 2, 2, 0, "plain"),          # ragged
    ((8, 64, 8, 7), torch.float32, 2, 2, 0, "plain"),
    ((8, 64, 8, 8), torch.float32, 3, 2, 0, "plain"),          # overlapping windows
    ((8, 64, 8, 8), torch.float32, 2, 1, 0, "plain"),
    ((8, 64, 8, 8), torch.int64, 2, 2, 0, "plain"),
    ((64, 32, 32), torch.float32, 2, 2, 0, "plain"),           # unbatched
    # the kernels' 32-bit index: a pooled side of 2^31 - 256 elements or more
    ((1, 2 ** 31 - 257, 2, 2), torch.bfloat16, 2, 2, 0, "kernel"),
    ((1, 2 ** 31 - 256, 2, 2), torch.bfloat16, 2, 2, 0, "plain"),
    ((8192, 256, 64, 64), torch.float32, 2, 2, 0, "plain"),
])
def test_route(shape, dtype, window, stride, padding, expected):
    assert pool.route(torch.Size(shape), dtype, window, stride, padding) == expected


@pytest.mark.parametrize("window, stride, padding, count_include_pad, shape, calls", [
    (2, 2, 0, True, (2, 8, 6, 4), (0, 0)),
    (1, 1, 0, True, (2, 8, 6, 4), (1, 0)),
    (2, 2, 1, False, (2, 8, 6, 4), (0, 1)),
    (3, 2, 1, True, (2, 8, 7, 5), (0, 1)),
    (2, 2, 0, True, (2, 8, 7, 5), (0, 1)),
])
def test_layer_is_avg_pool2d_bitwise_on_every_route(window, stride, padding, count_include_pad,
                                                    shape, calls):
    """Each route's output and gradient equal ``F.avg_pool2d``'s bitwise;
    ``identity_calls`` and ``plain_calls`` count the routes that launch
    nothing; the CPU launches no kernel."""
    x = _input(shape, torch.float32).requires_grad_()
    ours = layers.avg_pool(x, window, stride, padding, count_include_pad)
    ref = F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)
    dy = _input(ref.shape, torch.float32, seed=1)
    assert torch.equal(ours, ref)
    assert torch.equal(torch.autograd.grad(ours, x, dy)[0], torch.autograd.grad(ref, x, dy)[0])
    assert (pool.identity_calls, pool.plain_calls) == calls
    assert pool.launches == {"fwd": 0, "bwd": 0} and pool.layout_copies == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_identity_is_avg_pool2d_of_window_1(dtype, channels_last):
    """window == stride == 1 returns the input itself; value and gradient are
    ``F.avg_pool2d(x, 1, 1)``'s bitwise, but for the sign of a zero: ATen's
    sum starts from +0, so it turns a -0 into +0, which the identity keeps
    (the two compare equal)."""
    x = _input((3, 12, 5, 7), dtype, channels_last=channels_last)
    x[0, :5, 0, 0] = -0.0
    x.requires_grad_()
    ours = layers.avg_pool(x, 1, 1)
    ref = F.avg_pool2d(x, 1, 1)
    assert ours is x
    dy = _input(ref.shape, dtype, seed=1)
    dy[-1, -5:, -1, -1] = -0.0
    g_ours, = torch.autograd.grad(ours, x, dy)
    g_ref, = torch.autograd.grad(ref, x, dy)
    for a, b in ((ours, ref), (g_ours, g_ref)):
        assert torch.equal(a, b)
        assert torch.equal(a.signbit() != b.signbit(), (a == 0) & a.signbit())
    assert pool.identity_calls == 1 and pool.plain_calls == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape, k", [((4, 64, 32, 32), 2), ((2, 40, 6, 10), 2),
                                      ((3, 12, 9, 6), 3), ((1, 3, 2, 2), 2)],
                         ids=["r18-stage1", "c40", "k3", "one-window"])
def test_avg_pool_plain_versions_are_avg_pool2d(dtype, shape, k):
    """``AvgPool`` on the CPU: forward, backward and double backward bitwise
    ``F.avg_pool2d``'s under autograd, in the channels-last layout."""
    x = _input(shape, dtype).requires_grad_()
    ours = pool.AvgPool.apply(x, k)
    ref = F.avg_pool2d(x, k, k)
    assert torch.equal(ours, ref)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    dy = _input(ref.shape, dtype, seed=1).requires_grad_()
    g_ours, = torch.autograd.grad(ours, x, dy, create_graph=True)
    g_ref, = torch.autograd.grad(ref, x, dy, create_graph=True)
    assert torch.equal(g_ours, g_ref)
    assert g_ours.is_contiguous(memory_format=torch.channels_last)
    ddx = _input(x.shape, dtype, seed=2)
    assert torch.equal(torch.autograd.grad(g_ours, dy, ddx)[0],
                       torch.autograd.grad(g_ref, dy, ddx)[0])
    assert pool.launches == {"fwd": 0, "bwd": 0}


def test_avg_pool_gradgradcheck():
    x = _input((2, 3, 6, 4), torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: pool.AvgPool.apply(t, 2), (x,))
    assert torch.autograd.gradgradcheck(lambda t: pool.AvgPool.apply(t, 2), (x,))


def test_avg_pool_saves_no_tensor():
    """The graph keeps nothing of the input alive (peak memory)."""
    x = _input((2, 8, 4, 4), torch.float32).requires_grad_()
    y = pool.AvgPool.apply(x, 2)
    assert not y.grad_fn.saved_tensors


def test_meta_tensors_take_the_plain_version():
    y = pool.AvgPool.apply(torch.empty((2, 8, 6, 4), device="meta"), 2)
    assert y.shape == (2, 8, 3, 2) and y.device.type == "meta"
    assert pool.launches == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("c, dtype, vec", [
    (64, torch.bfloat16, 8), (64, torch.float16, 8), (64, torch.float32, 4),
    (64, torch.float64, 2), (40, torch.bfloat16, 8), (12, torch.float32, 4),
    (12, torch.bfloat16, 1), (3, torch.float32, 1), (520, torch.bfloat16, 8),
    (3, torch.float64, 1),
])
def test_launch_plan_width(c, dtype, vec):
    assert pool.launch_plan(132, 1000, c, dtype, 0, 1 << 20)[1] == vec


@pytest.mark.parametrize("offset", [2, 8])
def test_launch_plan_takes_one_element_off_16_bytes(offset):
    """Every operand's address must be 16-byte aligned for the wide width."""
    assert pool.launch_plan(132, 1000, 64, torch.bfloat16, 1 << 20, offset)[1] == 1
    assert pool.launch_plan(132, 1000, 64, torch.bfloat16, offset, 1 << 20)[1] == 1


@pytest.mark.parametrize("sms, pixels, c, dtype, grid", [
    (132, 4096 * 16 * 16, 64, torch.bfloat16, 132 * 16),   # ResNet-18 stage 1, chunk of 4096
    (132, 1, 3, torch.float32, 1),                         # one pixel of 3 channels
    (132, 100, 64, torch.bfloat16, 4),                     # 800 items
    (132, 256, 8, torch.bfloat16, 1),                      # 256 items: one block
    (132, 257, 8, torch.bfloat16, 2),
    (8, 10 ** 6, 64, torch.float32, 8 * 16),
])
def test_launch_plan_grid(sms, pixels, c, dtype, grid):
    """One thread an item up to ``_BLOCKS_PER_SM`` blocks an SM."""
    assert pool.launch_plan(sms, pixels, c, dtype, 0, 0)[0] == grid


def test_one_plain_switch_for_both_kernel_families():
    """``bn.plain_versions()`` is ``_build``'s, which ``pool`` reads too."""
    from fullbatchtraining_tpu_torch.ops import _build, bn

    assert bn.plain_versions is _build.plain_versions
    assert not _build.force_plain
    with bn.plain_versions():
        assert _build.force_plain
        with _build.plain_versions():
            assert _build.force_plain
        assert _build.force_plain
    assert not _build.force_plain


def test_reset_counts():
    pool.launches["fwd"] += 3
    pool.launches["bwd"] += 2
    pool.vector_launches["bwd"] += 1
    pool.plain_calls, pool.identity_calls, pool.layout_copies = 4, 5, 6
    pool.reset_counts()
    assert pool.launches == pool.vector_launches == {"fwd": 0, "bwd": 0}
    assert (pool.plain_calls, pool.identity_calls, pool.layout_copies) == (0, 0, 0)


@pytest.mark.parametrize("model, identities", [("resnet18", 0), ("resnet50", 1)])
def test_resnet_pools_take_the_kernel_route(model, identities, config_dir, monkeypatch):
    """A ResNet's downsample-C pools all route to the kernels (three stride-2
    pools), the bottleneck's stage-1 projection at stride 1 to the identity;
    none to ``F.avg_pool2d``."""
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.models import construct_model

    cfg = load_config(config_dir, overrides=[f"model={model}", "model.width=4"])
    net = construct_model(cfg.model, 3, 10).to(memory_format=torch.channels_last)
    routes = []

    def spy(*args, route=pool.route):
        routes.append(route(*args))
        return routes[-1]

    monkeypatch.setattr(pool, "route", spy)
    net(torch.randn(2, 32, 32, 3)).sum().backward()
    assert routes == ["identity"] * identities + ["kernel"] * 3
    assert (pool.identity_calls, pool.plain_calls) == (identities, 0)
