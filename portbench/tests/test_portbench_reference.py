"""The plain reference against the port, at each family's cut on the CPU:
the same steps from the same inputs, in float64 to rounding, and the
reference's parts on their own. Every cell of ``BENCHMARK.json`` takes
part, and DenseNet-121, a family that no cell runs yet, under the
``gradreg-c512`` recipe."""

from __future__ import annotations

import hashlib

import pytest
import torch

from portbench import cells, compare, inputs
from portbench.program import Program
from portbench.reference import densenet, layers, precision
from portbench.reference.train import crop_flip, learning_rate
from portbench.tests.tiny import SEED, WORKLOADS, cut, tiny

CPU = torch.device("cpu")
DENSENET = "densenet121-cifar10.gradreg-c512"


def densenet_cell(**model) -> cells.Cell:
    """DenseNet-121 (upstream ``config/model/densenet121.yaml``) on 2,048 of
    CIFAR-10's images under the ``gradreg-c512`` recipe, built here: no
    cell runs it."""
    data = next(c for c in map(cells.find, WORKLOADS) if c.config["data"] == "CIFAR10").config
    config = {"name": "densenet121-cifar10", "model": "densenet121", "data": "CIFAR10",
              "model.depth": 121, "model.bn_size": 4, "model.stem": "CIFAR",
              "model.memory_efficient": False, "model.drop_rate": 0,
              "model.convolution": "Standard", "model.nonlin_fn": "ReLU",
              "model.normalization": "BatchNorm2d",
              **{k: v for k, v in data.items() if k.startswith("data.")},
              "data.size": 2048, **model}
    traffic = cells.load_json(cells.HERE / "traffic" / "gradreg-c512.json")
    workload = {"name": DENSENET, "config": config["name"], "traffic": traffic["name"],
                "chips": 1}
    cells.family(config)
    return cells.Cell(workload, config, traffic, {}, [], [])


def cell_of(workload: str, float64: bool = False) -> cells.Cell:
    """A cell of ``BENCHMARK.json``, or the DenseNet one, at its family's cut
    (DenseNet-121 on 16 images: its 58 concatenations are slow on a CPU)."""
    if workload == DENSENET:
        return cut(densenet_cell(), float64, images=16)
    return tiny(workload, float64)


def readings(cell, seed=SEED, steps=3):
    ours = compare.program_readings(Program(cell, seed, CPU), steps)
    images, labels = inputs.images_and_labels(cell.config, seed, CPU)
    weights = inputs.weights(cell.config, seed, CPU)
    return ours, compare.reference_readings(cell, images, labels, weights, seed, steps)


@pytest.mark.parametrize("workload", WORKLOADS + [DENSENET])
def test_reference_follows_the_port_in_float64(workload):
    ours, ref = readings(cell_of(workload, float64=True))
    gaps = compare.gaps(ours, ref)
    for number in ("loss_gap", "loss0_gap", "chunk_gap", "grad_gap", "stats_gap"):
        assert gaps[number][0] < 1e-9, (number, gaps[number])
    assert gaps["change_gap"][0] < 1e-6 and gaps["change_median_gap"][0] < 1e-6
    assert gaps["grad_median_gap"][0] < 1e-9


def names_and_shapes(model, config):
    """The port's parameters and running statistics of ``model``, and the
    reference's of ``config``."""
    family = cells.family(config)
    plan = family.architecture(config)
    ours = ({n: tuple(p.shape) for n, p in model.named_parameters()},
            {n: tuple(b.shape) for n, b in model.named_buffers() if "running" in n})
    theirs = ({n: shape for n, (shape, _) in family.parameter_shapes(plan).items()},
              {n: tuple(t.shape) for n, t in family.initial_stats(plan, CPU).items()})
    return ours, theirs


@pytest.mark.parametrize("workload", WORKLOADS + [DENSENET])
def test_parameters_and_names_are_the_ports(workload):
    cell = cell_of(workload)
    ours, theirs = names_and_shapes(Program(cell, SEED, CPU).state.model, cell.config)
    assert ours == theirs


def port_densenet(config):
    from fullbatchtraining_tpu_torch.models.densenets import (DenseNet,
                                                             densenet_depths_to_config)
    growth, blocks, init = densenet_depths_to_config(config["model.depth"])
    return DenseNet(growth, blocks, init, bn_size=config["model.bn_size"], classes=10,
                    stem=config["model.stem"])


@pytest.mark.parametrize("depth, stem", [(121, "CIFAR"), (161, "CIFAR"), (169, "CIFAR"),
                                         (201, "CIFAR"), (121, "imagenet"), (121, "standard"),
                                         (121, "efficient")])
def test_densenet_names_are_the_ports_at_every_depth_and_stem(depth, stem):
    config = densenet_cell(**{"model.depth": depth, "model.stem": stem}).config
    ours, theirs = names_and_shapes(port_densenet(config), config)
    assert ours == theirs


@pytest.mark.parametrize("stem", ["CIFAR", "imagenet", "efficient"])
def test_densenet_forward_is_the_ports_at_every_stem(stem):
    """One train-mode forward and backward in float64, from the benchmark's
    weights: the logits, every parameter's gradient and the running
    statistics."""
    config = densenet.tiny(densenet_cell(**{"model.stem": stem}).config)
    model = port_densenet(config).double()
    weights = {k: v.double() for k, v in inputs.weights(config, SEED, CPU).items()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    images = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
    ours = model(images)
    ours.square().sum().backward()
    plan = densenet.architecture(config)
    params = {k: v.clone().requires_grad_() for k, v in weights.items()}
    stats = {k: v.double() for k, v in densenet.initial_stats(plan, CPU).items()}
    theirs = densenet.forward(plan, params, stats, images.permute(0, 3, 1, 2))
    grads = torch.autograd.grad(theirs.square().sum(), list(params.values()))
    torch.testing.assert_close(ours, theirs, rtol=1e-10, atol=1e-12)
    for (name, p), g in zip(params.items(), grads):
        torch.testing.assert_close(dict(model.named_parameters())[name].grad, g,
                                   rtol=1e-8, atol=1e-10 * float(g.abs().max()))
    buffers = dict(model.named_buffers())
    for name, t in stats.items():
        torch.testing.assert_close(buffers[name], t, rtol=1e-10, atol=1e-12)


def test_a_reference_refuses_what_it_does_not_build():
    config = densenet_cell().config
    with pytest.raises(ValueError, match="drop_rate"):
        densenet.architecture(dict(config, **{"model.drop_rate": 0.2}))
    with pytest.raises(ValueError, match="depth 100"):
        densenet.architecture(dict(config, **{"model.depth": 100}))
    resnet = cells.family(cells.find(WORKLOADS[0]).config)
    with pytest.raises(ValueError, match="model.downsample"):
        resnet.architecture(dict(cells.find(WORKLOADS[0]).config, **{"model.downsample": "B"}))


def weights_digest(config, seed) -> str:
    h = hashlib.sha256()
    for name, t in inputs.weights(config, seed, CPU).items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


# the weights each cell was measured with before the model families were
# found by name: names, draw order and values
WEIGHTS = {
    ("r18-cifar10.fb1-c4096", 7):
        "be72cccd699fb5b5d844042b1ee740611d98d52000ba922f3bdd128b3435265f",
    ("r18-cifar10.fb1-c4096", SEED):
        "78ab4f36bd08292a0b7a9abcf0183ad46470b15581f19e4bebd0b99fdfd470d6",
    ("r152-cifar10.gradreg-c512", 7):
        "1756a50cebf836712565a2216d1ae01d64dfafa707302b4d7e7994634b6ce2d3",
    ("r152-cifar10.gradreg-c512", SEED):
        "bbdb002d3548e7a8721b71b37937e2adca6a43af1a6489b879f636113495d2d5",
}


@pytest.mark.parametrize("workload, seed", WEIGHTS)
def test_weights_are_those_measured_before(workload, seed):
    assert weights_digest(cells.find(workload).config, seed) == WEIGHTS[workload, seed]


# the reference's float64 readings at each cell's cut, as they read before
# the model families were found by name: each step's loss, the first step's
# chunk gradient norms and the sums over the leaves of the other readings
READINGS = {
    "r18-cifar10.fb1-c4096": {
        "loss": [2.587063741226263, 2.456706909814642, 2.2419047263858976],
        "chunks": [4.442335773481157, 4.2575159672468335, 4.780741283033027,
                   4.10088164701097],
        "grad": 12.267152104031643, "stats": 24.389212500077463,
        "change": 6.000857228013715, "leaves": {"grad": 62, "stats": 40, "change": 62}},
    "r152-cifar10.gradreg-c512": {
        "loss": [2.689528880174759, 2.6517257701043295, 2.6877194527921695],
        "chunks": [209.4126546313109, 200.06159269594178, 209.7010431708478,
                   228.57014088445365],
        "grad": 0.8455184481887973, "stats": 3256.1929948234865,
        "change": 7.931469906239752, "leaves": {"grad": 161, "stats": 106, "change": 161}},
}


@pytest.mark.parametrize("workload", READINGS)
def test_reference_reads_as_before(workload):
    cell = tiny(workload, float64=True)
    images, labels = inputs.images_and_labels(cell.config, SEED, CPU)
    weights = inputs.weights(cell.config, SEED, CPU)
    ref = compare.reference_readings(cell, images, labels, weights, SEED, 3)
    pinned = dict(READINGS[workload])
    assert {k: len(ref[k]) for k in ("grad", "stats", "change")} == pinned.pop("leaves")
    got = {"loss": ref["loss"], "chunks": ref["chunks"],
           **{k: sum(ref[k].values()) for k in ("grad", "stats", "change")}}
    assert got == pytest.approx(pinned, rel=1e-12)


def test_inputs_depend_on_the_seed_alone():
    cell = tiny(WORKLOADS[0])
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
    for norm in (layers.batch_norm, precision.split_batch_norm):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        stats = {"n.running_mean": torch.zeros(3), "n.running_var": torch.ones(3)}
        y = norm(xs, ws, bs, stats, "n", True)
        outs.append((y, torch.autograd.grad(y, (xs, ws, bs), dy), stats))
    (y0, (dx0, dw0, db0), s0), (y1, (dx1, dw1, db1), s1) = outs
    torch.testing.assert_close(y1, y0)
    torch.testing.assert_close(dw1, dw0)
    torch.testing.assert_close(db1, db0)
    assert all(torch.allclose(s0[k], s1[k]) for k in s0)
    a = (w * torch.rsqrt(x.var(dim=(0, 2, 3), unbiased=False) + layers.BN_EPS))
    step = 3 * 2**-8 * (dy.abs() * a[None, :, None, None]).amax()
    assert (dx1 - dx0).abs().max() <= step
    assert not torch.equal(dx1, precision.round_bf16(dx0))
