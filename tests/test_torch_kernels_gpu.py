"""The port's CUDA BatchNorm kernels against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is absent. Run them on a card with

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Shapes are ResNet-18's BN inputs at a small batch (stage 1 and 4) plus two
with ragged row counts and channel counts of 96 and 40, (``SGD_SHAPES``)
its four stages at ``hyp=base_sgd``'s blocks of 128 images and the paper's
chunks of 32, and (``IMAGENET_SHAPES``) its first stage at 224 px, a chunk
of 128 ImageNet images. Every kernel also runs at the edges of its two widths (16 bytes a
thread, or one element): a channel count below, across and above one
256-thread block's row, one that no 16-byte group divides, one row, a ragged
row count, and an operand 1 element off 16-byte alignment; the reductions
must be bitwise repeatable at each. BNEval, the eval-mode BatchNorm, is held
against its plain versions. ``bwd_apply`` runs with both of its roundings
(``split``); in a half type the split one differs from its plain version
in at most 1e-3 of its entries. A float16 convolution's gradients through cuDNN and through the
port's CPU path (``layers.half_product``, on the card's host) are held to the
float64 result rounded once. Tolerances,
relative to the size of the terms summed: float32 sums 1e-5 and
bfloat16- and float16-input sums 1e-5 (float32 accumulation in another
order), float64 1e-12; elementwise outputs 2 ulp of the output dtype (an FMA may round once
where the plain version rounds twice).
"""

import pytest
import torch

from fullbatchtraining_tpu_torch.ops import bn

pytestmark = pytest.mark.gpu

SHAPES = [(8 * 1024, 64), (8 * 16, 512), (1000, 96), (333, 40)]
SGD_SHAPES = [(b * hw, c) for b in (128, 32) for hw, c in ((1024, 64), (256, 128), (64, 256),
                                                           (16, 512))]
IMAGENET_SHAPES = [(128 * 224 * 224, 64)]
EDGE_C = [3, 12, 64, 520, 4096]
EDGE_M = [1, 333, 16 * 512]
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
SUM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5, torch.float16: 1e-5, torch.float64: 1e-12}
SPLIT_OFF_TOL = 1e-3   # half-type split bwd_apply: share of entries off its plain version's
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
       torch.float64: 2.0 ** -52}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(dtype)


def _operand(m, c, dtype, device, seed, aligned):
    """``[m, c]`` data, at a 16-byte aligned address or one element past one
    (``buf[1:].view(m, c)`` of a flat buffer)."""
    offset = 0 if aligned else 1
    return _data((m * c + offset,), dtype, device, seed)[offset:].view(m, c)


def _expected_vec(c, dtype, aligned):
    wide = 16 // dtype.itemsize
    return wide if aligned and c % wide == 0 else 1


def _counts(name):
    return bn.launches[name], bn.vector_launches[name]


def _coef(k, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((k, c), generator=g, device=device, dtype=bn.stat_dtype(dtype))


def _assert_sums_close(ours, ref, scale, dtype):
    err = ((ours - ref).abs() / scale.clamp_min(1e-30)).max().item()
    assert err <= SUM_TOL[dtype], err


def _assert_elementwise_close(ours, ref, magnitude, dtype):
    diff = (ours.to(torch.float64) - ref.to(torch.float64)).abs()
    bound = 2 * ULP[dtype] * (magnitude.to(torch.float64) + ref.to(torch.float64).abs())
    assert bool((diff <= bound).all()), (diff - bound).max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES + SGD_SHAPES + IMAGENET_SHAPES, ids=str)
def test_reductions_match_plain(cuda, shape, dtype):
    x = _data(shape, dtype, cuda, 0)
    dy = _data(shape, dtype, cuda, 1)
    before = dict(bn.launches)
    s, r = bn.stats(x), bn.bwd_reduce(dy, x)
    torch.cuda.synchronize()
    assert bn.launches["stats"] == before["stats"] + 1
    assert bn.launches["bwd_reduce"] == before["bwd_reduce"] + 1
    with bn.plain_versions():
        s_ref, r_ref = bn.stats(x), bn.bwd_reduce(dy, x)
        s_abs = bn.stats(x.abs())
        r_abs = bn.bwd_reduce(dy.abs(), x.abs())
    _assert_sums_close(s, s_ref, s_abs, dtype)
    _assert_sums_close(r, r_ref, r_abs, dtype)
    assert torch.equal(s, bn.stats(x)), "stats is not bitwise repeatable"
    assert torch.equal(r, bn.bwd_reduce(dy, x)), "bwd_reduce is not bitwise repeatable"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES + SGD_SHAPES + IMAGENET_SHAPES, ids=str)
def test_elementwise_match_plain(cuda, shape, dtype):
    x = _data(shape, dtype, cuda, 2)
    dy = _data(shape, dtype, cuda, 3)
    ab = _coef(2, shape[1], dtype, cuda, 4)
    coef = _coef(3, shape[1], dtype, cuda, 5)
    y, dx = bn.apply(x, ab), bn.bwd_apply(dy, x, coef)
    dx_split = bn.bwd_apply(dy, x, coef, split=True)
    torch.cuda.synchronize()
    with bn.plain_versions():
        y_ref, dx_ref = bn.apply(x, ab), bn.bwd_apply(dy, x, coef)
        dx_split_ref = bn.bwd_apply(dy, x, coef, split=True)
    assert y.dtype == dx.dtype == dx_split.dtype == dtype
    acc = bn.stat_dtype(dtype)
    _assert_elementwise_close(y, y_ref, (x.to(acc) * ab[0]).abs() + ab[1].abs(), dtype)
    terms = (dy.to(acc) * coef[0]).abs() + coef[1].abs() + (x.to(acc) * coef[2]).abs()
    _assert_elementwise_close(dx, dx_ref, terms, dtype)
    _assert_elementwise_close(dx_split, dx_split_ref, terms, dtype)
    if dtype in (torch.bfloat16, torch.float16):
        # an FMA moves a half rounding in at most about one entry of 2^13
        assert (dx_split != dx_split_ref).double().mean().item() <= SPLIT_OFF_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bn_train_matches_reference(cuda, dtype):
    """BNTrain on the kernels against autograd through stock ops."""
    x = _data((4, 16, 16, 64), dtype, cuda, 6).requires_grad_()
    scale = _coef(1, 64, dtype, cuda, 7)[0].add(1.0).requires_grad_()
    bias = _coef(1, 64, dtype, cuda, 8)[0].requires_grad_()
    cot = _data((4, 16, 16, 64), dtype, cuda, 9)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    outs = bn.bn_train(x, scale, bias)
    refs = bn.bn_train_reference(x, scale, bias)
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=tol, atol=tol)
    grads = torch.autograd.grad(outs[0], (x, scale, bias), cot)
    grads_ref = torch.autograd.grad(refs[0], (x, scale, bias), cot)
    for g, r in zip(grads, grads_ref):
        torch.testing.assert_close(g, r, rtol=tol, atol=tol * r.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bn_eval_matches_plain(cuda, dtype):
    """BNEval (eval-mode BatchNorm from running stats) on the kernels against
    the same Function under ``plain_versions()``: one ``apply`` forward, one
    ``apply`` and one ``bwd_reduce`` backward."""
    x = _data((4, 16, 16, 64), dtype, cuda, 10).requires_grad_()
    scale = _coef(1, 64, dtype, cuda, 11)[0].add(1.0).requires_grad_()
    bias = _coef(1, 64, dtype, cuda, 12)[0].requires_grad_()
    mean = _coef(1, 64, dtype, cuda, 13)[0]
    var = _coef(1, 64, dtype, cuda, 14)[0].abs().add(0.5)
    cot = _data((4, 16, 16, 64), dtype, cuda, 15)
    tol = 1e-5 if dtype == torch.float32 else 1e-12

    def run():
        y = bn.bn_eval(x, scale, bias, mean, var)
        return (y, *torch.autograd.grad(y, (x, scale, bias), cot))

    bn.reset_counts()
    outs = run()
    assert bn.launches == {"stats": 0, "apply": 2, "bwd_reduce": 1, "bwd_apply": 0}
    with bn.plain_versions():
        refs = run()
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=tol, atol=tol * r.abs().max().item())


def test_wrong_input_raises(cuda):
    x = torch.zeros((64, 8), device=cuda)
    with pytest.raises(ValueError):
        bn.stats(x.t())  # not contiguous
    with pytest.raises(TypeError):
        bn.stats(x.to(torch.int32))
    with pytest.raises(ValueError):
        bn.apply(x, torch.zeros((2, 8), device=cuda, dtype=torch.float64))


def _conv_gradients(x, w, g, device, product):
    """``(dw, dx)`` of a 3x3 ``conv2d(x, w)`` at cotangent ``g`` on
    ``device``, channels-last, through ``product(F.conv2d, x, w, 1, 1)``."""
    xx = x.to(device).contiguous(memory_format=torch.channels_last).requires_grad_()
    ww = w.to(device).requires_grad_()
    y = product(torch.nn.functional.conv2d, xx, ww, 1, 1)
    dx, dw = torch.autograd.grad(y, (xx, ww), g.to(device).contiguous(
        memory_format=torch.channels_last))
    return dw.cpu(), dx.cpu()


def test_float16_conv_gradients_round_once(cuda):
    """Float16 weight and input gradients of a 3x3 convolution, cotangents
    of about 2e-6 (the input gradient below float16's normal range), through
    cuDNN and through the port's CPU path each differ from the float64 result
    rounded once to float16 in at most 1% of their entries: float32 sums in
    another order move a rounding now and then. Torch's own float16 CPU
    kernels are printed beside them, not held: on a host with AVX512-FP16
    they round as they accumulate."""
    from fullbatchtraining_tpu_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(8, 64, 32, 32, generator=gen)).half()
    g = (torch.randn(8, 64, 32, 32, generator=gen) * 2e-6).half()
    w = (torch.randn(64, 64, 3, 3, generator=gen) * 0.05).half()
    exact = (torch.nn.grad.conv2d_weight(x.double(), w.shape, g.double(), 1, 1).half(),
             torch.nn.grad.conv2d_input(x.shape, w.double(), g.double(), 1, 1).half())

    def plain(fn, x, w, *args):
        return fn(x, w, None, *args)

    off = {}
    for name, device, product in (("cudnn", cuda, plain), ("port_cpu", "cpu", layers.half_product),
                                  ("torch_cpu", "cpu", plain)):
        grads = _conv_gradients(x, w, g, device, product)
        off[name] = [int((a != b).sum()) for a, b in zip(grads, exact)]
    print(f"entries off the float64 result rounded once, (dw of {exact[0].numel()}, dx of "
          f"{exact[1].numel()}); exact zeros {[int((e == 0).sum()) for e in exact]}: {off}")
    for name in ("cudnn", "port_cpu"):
        for count, e in zip(off[name], exact):
            assert count <= e.numel() // 100, (name, off)


EDGES = pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])


@EDGES
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("c", EDGE_C)
@pytest.mark.parametrize("name", ["stats", "apply", "bwd_reduce", "bwd_apply"])
def test_widths_and_edges(cuda, name, c, m, dtype, aligned):
    """Each kernel at both widths: ``x`` is aligned or one element off (for
    ``bwd_apply`` it stands for an offset ``dx``, which the wrapper never
    allocates); ``dy`` is aligned."""
    x = _operand(m, c, dtype, cuda, 13, aligned)
    assert (x.data_ptr() % 16 == 0) == aligned
    inputs = (x,) if name in ("stats", "apply") else (_operand(m, c, dtype, cuda, 12, True), x)
    rows = {"apply": 2, "bwd_apply": 3}.get(name)
    coef = (_coef(rows, c, dtype, cuda, 11),) if rows else ()
    fn = getattr(bn, name)
    before = _counts(name)
    out = fn(*inputs, *coef)
    torch.cuda.synchronize()
    wide = _expected_vec(c, dtype, aligned) > 1
    assert _counts(name) == (before[0] + 1, before[1] + wide)
    with bn.plain_versions():
        ref = fn(*inputs, *coef)
        if not coef:
            scale = fn(*(t.abs() for t in inputs))
    if not coef:
        _assert_sums_close(out, ref, scale, dtype)
        assert torch.equal(out, fn(*inputs)), f"{name} is not bitwise repeatable"
        return
    (k,) = coef
    assert out.dtype == dtype and out.shape == (m, c)
    # |k0*in0| + |k1| (+ |k2*in1|): apply a*x + b, bwd_apply a*dy + c1 + c2*x
    magnitude = k[1].abs() + sum((t.to(k.dtype) * k[j]).abs() for t, j in zip(inputs, (0, 2)))
    _assert_elementwise_close(out, ref, magnitude, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_bn_train_double_backward_matches_reference(cuda, dtype):
    """BNTrain differentiated twice: first order on the kernels, second order
    through BNTrainBackward's plain double backward, against autograd through
    stock ops twice. Tolerance relative to the largest entry: float32 1e-4,
    float64 1e-10."""
    shape = (4, 16, 16, 64)
    x = _data(shape, dtype, cuda, 20).requires_grad_()
    scale = _coef(1, 64, dtype, cuda, 21)[0].add(1.0).requires_grad_()
    bias = _coef(1, 64, dtype, cuda, 22)[0].requires_grad_()
    cots = [_data(shape, dtype, cuda, 23).requires_grad_(),
            _coef(1, 64, dtype, cuda, 24)[0].requires_grad_(),
            _coef(1, 64, dtype, cuda, 25)[0].requires_grad_()]
    vs = [_data(shape, dtype, cuda, 26), _coef(1, 64, dtype, cuda, 27)[0]]
    tol = 1e-4 if dtype == torch.float32 else 1e-10

    def derivatives(fn):
        first = torch.autograd.grad(fn(x, scale, bias), (x, scale, bias), cots,
                                    create_graph=True)
        return first, torch.autograd.grad(first[:2], (x, scale, *cots), vs)

    before = (dict(bn.launches), bn.double_backward_calls)
    first, second = derivatives(bn.bn_train)
    torch.cuda.synchronize()
    assert bn.double_backward_calls == before[1] + 1
    assert bn.launches["bwd_apply"] == before[0]["bwd_apply"] + 1
    first_ref, second_ref = derivatives(bn.bn_train_reference)
    for ours, ref in zip((*first, *second), (*first_ref, *second_ref)):
        torch.testing.assert_close(ours, ref, rtol=tol, atol=tol * ref.abs().max().item())


def test_forward_differences_on_the_kernels_matches_plain(cuda):
    """One regularized chunk gradient (``forward-differences``) of ResNet-18
    at width 8 in float64 through ``Trainer.regrad``, on the kernels and on
    the plain versions: 1e-9 of each tensor's largest entry (the two differ
    in the BN sums' order, about 1e-15, which the finite difference
    amplifies about a hundredfold)."""
    from pathlib import Path

    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training.grad_reg import make_grad_regularizer
    from fullbatchtraining_tpu_torch.training.training import Trainer

    root = Path(__file__).resolve().parent.parent
    cfg = load_config(root / "config", overrides=[
        "model=resnet18", "model.width=8", "hyp=gradreg", "data.size=16",
        "data.batch_size=16", "hyp.sub_batch=16", f"data.path={root / 'build' / 'no_data'}",
        "impl.dtype=float64", "impl.accumulation_dtype=float64",
        "impl.mixed_precision=False"])
    bundle = construct_databundle(cfg.data)
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    trainer = Trainer(model, bundle, cfg, cuda)
    model.train()
    reg_fn = make_grad_regularizer(cfg.hyp.grad_reg, trainer.regrad)
    g = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randn((16, 32, 32, 3), generator=g, device=cuda, dtype=torch.float64)
    labels = torch.randint(0, 10, (16,), generator=g, device=cuda)

    def regularized():
        grads = trainer.regrad(trainer.params, x, labels)
        return reg_fn(grads, trainer.params, x, labels, None, 0.8)

    bn.reset_counts()
    ours = regularized()
    torch.cuda.synchronize()
    counts = dict(bn.launches)
    assert all(counts[k] == 2 * 20 for k in ("stats", "bwd_reduce", "bwd_apply")), counts
    with bn.plain_versions():
        ref = regularized()
    assert bn.launches == counts
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, rtol=1e-9, atol=1e-9 * r.abs().max().item())


def test_stochastic_step_launches_a_kernel_per_layer_and_block(cuda):
    """One ``hyp=base_sgd`` step (ResNet-18 at width 8, 512 shuffled images in
    4 blocks of 128) through ``train()`` on the card: ``stats``,
    ``bwd_reduce`` and ``bwd_apply`` launch once a BN layer a block, ``apply``
    that plus once a layer an evaluation block, all at 16 bytes a thread."""
    from pathlib import Path

    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    root = Path(__file__).resolve().parent.parent
    cfg = load_config(root / "config", overrides=[
        "model=resnet18", "model.width=8", "hyp=base_sgd", "data.size=512", "hyp.steps=1",
        "hyp.warmup=0", f"data.path={root / 'build' / 'no_data'}", "seed=0"])
    bundle = construct_databundle(cfg.data)
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    bn.reset_counts()
    _, stats = train(model, bundle, cfg, device="cuda")
    torch.cuda.synchronize()
    blocks, eval_blocks = 512 // 128, -(-len(bundle.valid) // 128)
    assert len(stats["grad_norm_train_3"]) == 1 and "grad_norm_train_4" not in stats
    assert {k: bn.launches[k] for k in ("stats", "bwd_reduce", "bwd_apply")} == dict.fromkeys(
        ("stats", "bwd_reduce", "bwd_apply"), 20 * blocks)
    assert bn.launches["apply"] == 20 * blocks + 20 * eval_blocks
    assert bn.vector_launches == bn.launches


def test_nccl_group_of_one_step_is_bitwise_the_step_without(cuda):
    """One ``hyp=fb1`` step (ResNet-18 at width 8, 512 images in chunks of
    128) through ``train()`` in an NCCL group of one: one ``all_reduce`` for
    the step and one for its evaluation, the kernels launched as without the
    group, and params, running stats and stats bitwise those of the step
    without the group."""
    import socket
    from pathlib import Path

    from fullbatchtraining_tpu_torch import parallel
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = ["model=resnet18", "model.width=8", "hyp=fb1", "data.size=512", "hyp.steps=1",
            "hyp.warmup=0", f"data.path={root / 'build' / 'no_data'}", "seed=0"]
    runs = []
    for setup in (["impl/setup=distributed", f"impl.setup.url=127.0.0.1:{port}"], []):
        cfg = load_config(root / "config", overrides=base + setup)
        world = parallel.setup_distributed(cfg.impl.setup, "cuda")
        try:
            bundle = construct_databundle(cfg.data)
            model = construct_model(cfg.model, bundle.channels, bundle.classes)
            bn.reset_counts()
            parallel.reset_counts()
            state, stats = train(model, bundle, cfg, device="cuda")
            torch.cuda.synchronize()
            runs.append((state.model.state_dict(), stats, dict(bn.launches),
                         dict(parallel.calls), world.size))
        finally:
            parallel.shutdown(world)
    (ours, ours_stats, ours_launches, calls, size), (ref, ref_stats, ref_launches, none, _) = runs
    assert size == 1
    assert calls == {"all_reduce": 2, "all_gather": 0, "broadcast": 0, "barrier": 0}
    assert none == dict.fromkeys(calls, 0)
    assert ours_launches == ref_launches and ref_launches["stats"] == 20 * 4
    assert [k for k in ref if not torch.equal(ours[k], ref[k])] == []
    assert {k: v for k, v in ours_stats.items() if k != "train_time"} == {
        k: v for k, v in ref_stats.items() if k != "train_time"}


@pytest.mark.parametrize("shuffle", [False, True], ids=["in-order", "shuffled"])
def test_streamed_step_is_bitwise_the_resident_step(cuda, shuffle):
    """One ``hyp=fb1`` step (ResNet-18 at width 8, 512 images in chunks of
    128) through ``train()`` with the epoch streamed from pinned host
    buffers on a side stream, a block a segment: params, running stats and
    stats bitwise those of the resident step, the same launches, and the
    epoch's bytes copied host to device."""
    from pathlib import Path

    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.parallel import streaming
    from fullbatchtraining_tpu_torch.training import train

    root = Path(__file__).resolve().parent.parent
    base = ["model=resnet18", "model.width=8", "hyp=fb1", "data.size=512", "hyp.steps=1",
            "hyp.warmup=0", f"data.path={root / 'build' / 'no_data'}", "seed=0",
            f"hyp.shuffle={shuffle}"]
    runs = []
    for extra in ([], ["impl.hbm_epoch_max_bytes=600000"]):   # 393,216 bytes a block
        cfg = load_config(root / "config", overrides=base + extra)
        bundle = construct_databundle(cfg.data)
        model = construct_model(cfg.model, bundle.channels, bundle.classes)
        bn.reset_counts()
        streaming.reset_counts()
        state, stats = train(model, bundle, cfg, device="cuda")
        torch.cuda.synchronize()
        runs.append((state.model.state_dict(), stats, dict(bn.launches),
                     dict(streaming.counts)))
    (ref, ref_stats, ref_launches, none), (ours, stats, launches, counts) = runs
    assert none == {"segments": 0, "h2d_bytes": 0}
    # the 102 validation images, one block, stay resident
    assert counts == {"segments": 4, "h2d_bytes": 512 * 32 * 32 * 3}, counts
    assert launches == ref_launches and ref_launches["stats"] == 20 * 4
    assert [k for k in ref if not torch.equal(ours[k], ref[k])] == []
    assert {k: v for k, v in stats.items() if k != "train_time"} == {
        k: v for k, v in ref_stats.items() if k != "train_time"}
