"""The plain reference against the port, at tiny width on the CPU: the same
steps from the same inputs, in float64 to rounding, and the reference's
parts on their own."""

from __future__ import annotations

import pytest
import torch

from portbench import compare, inputs
from portbench.program import Program
from portbench.reference import precision, resnet
from portbench.reference.train import crop_flip, learning_rate
from portbench.tests.tiny import SEED, tiny

CPU = torch.device("cpu")


def readings(cell, seed=SEED, steps=3):
    ours = compare.program_readings(Program(cell, seed, CPU), steps)
    images, labels = inputs.images_and_labels(cell.config, seed, CPU)
    weights = inputs.weights(cell.config, seed, CPU)
    return ours, compare.reference_readings(cell, images, labels, weights, seed, steps)


@pytest.mark.parametrize("workload", ["r18-cifar10.fb1-c4096", "r152-cifar10.gradreg-c512"])
def test_reference_follows_the_port_in_float64(workload):
    ours, ref = readings(tiny(workload, float64=True))
    gaps = compare.gaps(ours, ref)
    for number in ("loss_gap", "loss0_gap", "chunk_gap", "grad_gap", "stats_gap"):
        assert gaps[number][0] < 1e-9, (number, gaps[number])
    assert gaps["change_gap"][0] < 1e-6 and gaps["change_median_gap"][0] < 1e-6
    assert gaps["grad_median_gap"][0] < 1e-9


def test_parameters_and_names_are_the_ports():
    cell = tiny("r18-cifar10.fb1-c4096")
    program = Program(cell, SEED, CPU)
    ours = {n: tuple(p.shape) for n, p in program.state.model.named_parameters()}
    plan = resnet.architecture(18, 4, 3, 10, 32)
    assert ours == {n: shape for n, (shape, _) in resnet.parameter_shapes(plan).items()}
    stats = {n for n, _ in program.state.model.named_buffers() if "running" in n}
    assert stats == set(resnet.initial_stats(plan, CPU))


def test_inputs_depend_on_the_seed_alone():
    cell = tiny("r18-cifar10.fb1-c4096")
    a, la = inputs.images_and_labels(cell.config, SEED, CPU)
    b, lb = inputs.images_and_labels(cell.config, SEED, CPU)
    c, _ = inputs.images_and_labels(cell.config, SEED + 1, CPU)
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(a, c)
    assert a.dtype == torch.uint8 and a.shape == (64, 32, 32, 3)
    w = inputs.weights(cell.config, SEED, CPU)
    assert all(torch.equal(w[k], v) for k, v in inputs.weights(cell.config, SEED, CPU).items())


def test_crop_flip_windows():
    images = torch.arange(2 * 4 * 4, dtype=torch.uint8).view(2, 4, 4, 1)
    g = torch.Generator().manual_seed(3)
    out = crop_flip(images, g, 4, 2, 0.5)
    g = torch.Generator().manual_seed(3)
    oy = torch.randint(0, 5, (2,), generator=g)
    ox = torch.randint(0, 5, (2,), generator=g)
    flip = torch.rand((2,), generator=g) < 0.5
    padded = torch.nn.functional.pad(images, (0, 0, 2, 2, 2, 2))
    for i in range(2):
        window = padded[i, oy[i]:oy[i] + 4, ox[i]:ox[i] + 4]
        assert torch.equal(out[i], window.flip(1) if flip[i] else window)


def test_learning_rate_schedules():
    fb1 = {"hyp.optim.lr": 0.1, "hyp.warmup": 0, "hyp.scheduler": "cosine-decay",
           "hyp.steps": 300}
    assert learning_rate(fb1, 0) == pytest.approx(0.1)
    assert learning_rate(fb1, 150) == pytest.approx(0.05)
    warm = {"hyp.optim.lr": 0.8, "hyp.warmup": 400, "hyp.scheduler": "cosine-4000",
            "hyp.steps": 3000}
    assert learning_rate(warm, 0) == 0.0 and learning_rate(warm, 200) == pytest.approx(0.4)
    assert learning_rate(warm, 401) == pytest.approx(0.8)


def test_rounding_of_the_controls():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9, 1e-3])
    t = precision.round_tf32(x)
    assert t[0] == 1.0 + 2**-10 and t[1] == 1.0 + 2**-10 and t[2] == -3.0 - 2**-9
    assert abs(t[3] - 1e-3) <= 1e-3 * 2**-11
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = precision.round_fp8(y, "e4m3")
    assert (q - y).abs().max() <= y.abs().max() * 2**-4
    assert not torch.equal(q, y) and torch.unique(q).numel() < 256


def test_split_batch_norm_rounds_the_two_parts_of_its_gradient():
    """bf16split's BatchNorm: the forward and the parameters' gradients are
    plain BatchNorm's; the input's gradient is within the rounding of its
    two parts, each about as large as ``a dy``, of plain BatchNorm's."""
    g = torch.Generator().manual_seed(5)
    x = precision.round_bf16(torch.randn(8, 3, 4, 4, generator=g) * 2 + 1)
    dy = precision.round_bf16(torch.randn(8, 3, 4, 4, generator=g))
    w, b = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
    outs = []
    for norm in (resnet.batch_norm, precision.split_batch_norm):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        stats = {"n.running_mean": torch.zeros(3), "n.running_var": torch.ones(3)}
        y = norm(xs, ws, bs, stats, "n", True)
        outs.append((y, torch.autograd.grad(y, (xs, ws, bs), dy), stats))
    (y0, (dx0, dw0, db0), s0), (y1, (dx1, dw1, db1), s1) = outs
    torch.testing.assert_close(y1, y0)
    torch.testing.assert_close(dw1, dw0)
    torch.testing.assert_close(db1, db0)
    assert all(torch.allclose(s0[k], s1[k]) for k in s0)
    a = (w * torch.rsqrt(x.var(dim=(0, 2, 3), unbiased=False) + resnet.BN_EPS))
    step = 3 * 2**-8 * (dy.abs() * a[None, :, None, None]).amax()
    assert (dx1 - dx0).abs().max() <= step
    assert not torch.equal(dx1, precision.round_bf16(dx0))
