"""The port's other model families and norms against the flax models.

VGG (three heads, and the CIFAR head at 64 px), DenseNet (three stems, with
and without ``memory_efficient``), PyramidNet (basic and bottleneck, at odd
widths), NFNet (CIFAR and ImageNet stems), ResNet-20 under every norm of the
zoo (GhostBatchNorm with even and uneven virtual batches, GroupNorm in each
form, LayerNorm, InstanceNorm, none), SkipInit ResNets with both pre-activation
shortcuts, the ``Standardized`` convolution and the linear debugging model.

Each case builds the port's model at a small size, draws its norm scales,
biases and running stats and its 0-d gains at random (so zero inits hide
nothing), exports it to the flax layout and runs the flax model on those
variables. In float64: train-mode logits, updated running stats, eval-mode
logits at rtol 1e-10, and the gradient of a fixed linear functional of the
logits at rtol 1e-9. The tables are shrunk in both packages where a case
needs it (VGG's plans, NFNet's variants, by ``monkeypatch``; DenseNet and
PyramidNet are built at small depths directly). A memory-efficient DenseNet
equals the plain one bitwise. ``tests/test_torch_families_norms.py`` runs
the ResNet cases, and ``tests/test_torch_families_tree.py`` shares them all.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.nfnets as jax_nfnets
import fullbatchtraining_tpu.models.vgg as jax_vgg
from fullbatchtraining_tpu.config import load_config
from fullbatchtraining_tpu.models import construct_model as jax_construct_model
from fullbatchtraining_tpu.models.densenets import DenseNet as JaxDenseNet
from fullbatchtraining_tpu.models.pyramidnets import PyramidNet as JaxPyramidNet
from fullbatchtraining_tpu_torch.convert import export_jax_variables, params_to_jax
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.models import nfnets, vgg
from fullbatchtraining_tpu_torch.models.densenets import DenseNet
from fullbatchtraining_tpu_torch.models.layers import BatchNorm2d, GroupNorm2d, LayerNorm2d
from fullbatchtraining_tpu_torch.models.modules import GhostBatchNorm, Skipper
from fullbatchtraining_tpu_torch.models.nfnets import NFBlock
from fullbatchtraining_tpu_torch.models.pyramidnets import PyramidNet
from fullbatchtraining_tpu_torch.ops import bn as bn_ops

from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

RTOL = 1e-10
GRAD_RTOL = 1e-9
CONFIG = pathlib.Path(__file__).resolve().parent.parent / "config"

TINY_VGG = {"VGG11": [8, "M", 16, "M", 16, 16, "M", 24, "M", 24, "M"]}
# the ImageNet head pools the map to 7x7 first: two pools leave 8x8 of 32 px
TINY_VGG_IMAGENET = {"VGG11": [8, "M", 12, "M"]}
TINY_NFNET = {"F0": {"width": [256, 256], "depth": [1, 1], "train_imsize": 32,
                     "test_imsize": 32, "drop_rate": 0.2}}


def _resnet(*overrides):
    return {"overrides": ["model=resnet20", *overrides]}


# case -> how to build it: "overrides" of config/model through both
# construct_models, or "build" (port, flax) constructors; "batch", "pixels"
CASES = {
    "vgg-cifar": {"overrides": ["model=vgg11"], "plans": TINY_VGG},
    "vgg-cifar-64px": {"overrides": ["model=vgg11"], "plans": TINY_VGG, "pixels": 64},
    "vgg-tinyimagenet": {"overrides": ["model=vgg11", "model.head=TinyImageNet"],
                         "plans": TINY_VGG},
    "vgg-imagenet": {"overrides": ["model=vgg11", "model.head=ImageNet",
                                   "model.classical_weight_init=False"],
                     "plans": TINY_VGG_IMAGENET, "batch": 2},
    **{f"densenet-{stem}{'-memory-efficient' if eff else ''}": {"densenet": (stem, eff)}
       for stem in ("CIFAR", "standard", "efficient") for eff in (False, True)},
    "pyramidnet-basic": {"pyramidnet": (20, 7.0, False)},
    "pyramidnet-bottleneck": {"pyramidnet": (20, 5.0, True)},
    "nfnet-cifar": {"overrides": ["model=nfn"], "nfnet": True, "batch": 3},
    "nfnet-imagenet": {"overrides": ["model=nfn", "model.stem=ImageNet"], "nfnet": True,
                       "batch": 3},
    # 192 images: 3 virtual batches of 64; 200: of 67, 67 and 66
    "ghostnorm-even": {**_resnet("model.normalization=SequentialGhostNorm"), "batch": 192,
                       "pixels": 8},
    "ghostnorm-uneven": {**_resnet("model.normalization=GhostNorm"), "batch": 200,
                         "pixels": 8},
    "groupnorm1": _resnet("model.normalization=GroupNorm1"),
    "groupnorm8": _resnet("model.normalization=GroupNorm8"),
    "groupnorm4th": _resnet("model.normalization=GroupNorm4th"),
    "groupnorm-width32": _resnet("model.normalization=GroupNorm", "model.width=32"),
    "layernorm": _resnet("model.normalization=LayerNorm"),
    "instancenorm": _resnet("model.normalization=InstanceNorm2d"),
    "none": _resnet("model.normalization=none"),
    "skipinit-basic-B": _resnet("model.normalization=SkipInit"),
    "skipinit-basic-C": _resnet("model.normalization=SkipInit", "model.downsample=C"),
    "skipinit-bottleneck-B": {"overrides": ["model=resnet50", "model.width=4",
                                            "model.normalization=SkipInit",
                                            "model.downsample=B"]},
    "skipinit-bottleneck-C": {"overrides": ["model=resnet50", "model.width=4",
                                            "model.normalization=SkipInit"]},
    "standardized": _resnet("model.convolution=Standardized"),
    "linear": {"overrides": ["model=linear"]},
}


def _densenet(stem, memory_efficient, package):
    kwargs = dict(growth_rate=4, block_config=(2, 2, 2), num_init_features=8, bn_size=4,
                  drop_rate=0.0, classes=10, channels=3, memory_efficient=memory_efficient,
                  stem=stem)
    if package == "jax":
        return JaxDenseNet(**kwargs)
    return DenseNet(**kwargs, generator=torch.Generator().manual_seed(0))


def _pyramidnet(depth, alpha, bottleneck, package):
    if package == "jax":
        return JaxPyramidNet(depth=depth, alpha=alpha, channels=3, classes=10,
                             bottleneck=bottleneck)
    return PyramidNet(depth, alpha, 3, 10, bottleneck, torch.Generator().manual_seed(0))


def _shrink(monkeypatch, case):
    spec = CASES[case]
    if "plans" in spec:
        for module in (jax_vgg, vgg):
            monkeypatch.setattr(module, "VGG_PLANS", spec["plans"])
    if spec.get("nfnet"):
        for module in (jax_nfnets, nfnets):
            monkeypatch.setattr(module, "nfnet_params", TINY_NFNET)


def build(case, monkeypatch, package):
    """The flax module (``package="jax"``) or the port's (float32, CPU)."""
    spec = CASES[case]
    _shrink(monkeypatch, case)
    if "densenet" in spec:
        return _densenet(*spec["densenet"], package)
    if "pyramidnet" in spec:
        return _pyramidnet(*spec["pyramidnet"], package)
    cfg = load_config(CONFIG, overrides=spec["overrides"])
    if package == "jax":
        return jax_construct_model(cfg.model, 3, 10)
    return construct_model(cfg.model, 3, 10, pixels=spec.get("pixels", 32))


def randomize_(model, seed=0):
    """Random norm scales, biases and running stats, and random 0-d gains."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (BatchNorm2d, GhostBatchNorm, GroupNorm2d, LayerNorm2d)):
                for name, t in [*module.named_parameters(recurse=False),
                                *module.named_buffers(recurse=False)]:
                    if name == "running_var":
                        values = rng.uniform(0.5, 2.0, t.shape)
                    else:
                        values = (rng.standard_normal(t.shape) * 0.5
                                  + (1.0 if name == "weight" else 0.0))
                    t.copy_(torch.from_numpy(values))
            elif isinstance(module, (Skipper, NFBlock)):
                gain = module.alpha if isinstance(module, Skipper) else module.skip_gain
                gain.fill_(float(rng.uniform(0.5, 1.5)))
    return model


def port_and_variables(case, monkeypatch):
    """The port's float64 channels_last model, randomized, and its variables."""
    model = build(case, monkeypatch, "port").to(torch.float64)
    randomize_(model)
    return model.to(memory_format=torch.channels_last), export_jax_variables(model)


def _jax_apply(jmodel, variables, x, train):
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    if train:
        return jmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    return jmodel.apply(variables, x, train=False), None


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(ours, ref, rtol, what):
    ours, ref = _leaves(ours), _leaves(ref)
    assert ours.keys() == ref.keys(), (what, ours.keys() ^ ref.keys())
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=rtol, atol=1e-12,
                                   err_msg=f"{what} {key}")


def _inputs(case):
    spec = CASES[case]
    shape = (spec.get("batch", 4), spec.get("pixels", 32), spec.get("pixels", 32), 3)
    x = np.random.default_rng(1).standard_normal(shape)
    weights = np.random.default_rng(2).standard_normal((shape[0], 10))
    return x, weights


# ResNets under the zoo's norms and convs: tests/test_torch_families_norms.py
NORM_CASES = [c for c in CASES if CASES[c].get("overrides", [""])[0].startswith("model=resnet")]


@pytest.mark.parametrize("case", [c for c in CASES if c not in NORM_CASES])
def test_family_matches_flax(case, monkeypatch):
    check_case(case, monkeypatch)


def check_case(case, monkeypatch):
    """Train-mode logits, updated running stats and the parameter gradient,
    then eval-mode logits, against the flax model in float64."""
    tmodel, variables = port_and_variables(case, monkeypatch)
    jmodel = build(case, monkeypatch, "jax")
    x, w = _inputs(case)
    with jax.enable_x64(True):
        def functional(params):
            logits, upd = _jax_apply(jmodel, {**variables, "params": params}, jnp.asarray(x),
                                     True)
            return jnp.sum(logits * w), (logits, upd)

        # jitted: flax op by op is several times slower than its compile here
        (_, (logits_ref, upd)), grads_ref = jax.jit(jax.value_and_grad(
            functional, has_aux=True))(variables["params"])
        eval_ref, _ = jax.jit(lambda v: _jax_apply(jmodel, v, jnp.asarray(x), False))(variables)
        logits_ref, grads_ref, eval_ref = jax.device_get((logits_ref, grads_ref, eval_ref))
        stats_ref = jax.device_get(upd.get("batch_stats", {}))

    eval_model = copy.deepcopy(tmodel).eval()
    with torch.no_grad():
        eval_logits = eval_model(torch.from_numpy(x))
    np.testing.assert_allclose(eval_logits.numpy(), eval_ref, rtol=RTOL, atol=1e-12)

    bn_ops.reset_counts()
    logits = tmodel.train()(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).sum().backward()
    assert bn_ops.layout_copies == 0, f"{bn_ops.layout_copies} channels-last copies"
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=RTOL, atol=1e-12)
    _assert_close(export_jax_variables(tmodel)["batch_stats"], stats_ref, RTOL, "stats")
    grads = params_to_jax(tmodel, [p.grad for p in tmodel.parameters()])
    _assert_close(grads, grads_ref, GRAD_RTOL, "grad")


@pytest.mark.parametrize("stem", ["CIFAR", "standard", "efficient"])
def test_memory_efficient_densenet_equals_the_plain_one(stem):
    """Checkpointed dense layers update the running stats once a forward and
    give the plain model's loss and gradient, bitwise."""
    runs = []
    for efficient in (False, True):
        model = _densenet(stem, efficient, "port").to(torch.float64)
        randomize_(model)
        model = model.to(memory_format=torch.channels_last).train()
        x, w = _inputs("densenet-CIFAR")
        out = (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
        out.backward()
        runs.append((out.item(), {k: v.clone() for k, v in model.state_dict().items()},
                     [p.grad.clone() for p in model.parameters()]))
    (loss, state, grads), (loss_e, state_e, grads_e) = runs
    assert loss == loss_e
    assert all(torch.equal(state[k], state_e[k]) for k in state)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_e))
