"""The port's upstream ``.pth`` interop (``fullbatchtraining_tpu_torch/pretrained.py``,
``hub.py``, ``tools/{import,export}_reference_checkpoint.py``) against the
JAX package's ``pretrained.py``, on the CPU.

* For every ``config/model/`` file but ``linear``, the port's
  ``export_torch_state`` of a model (random norm parameters and running
  stats) equals the JAX ``export_torch_state`` of the same weights
  (``convert.export_jax_variables``), key for key, bit for bit, dtype and
  shape; ``convert_torch_state`` fills a fresh model back to the same
  tensors. SkipInit and ``linear`` are refused by both packages.
* The upstream 5-tuple with SGD momentum and the scheduler's state: one
  written by the JAX ``export_reference_training_checkpoint`` imports into
  the port equal to ``convert.load_jax_train_state`` of the same JAX state,
  and one the port writes imports into the JAX package equal to
  ``convert.export_jax_train_state`` of the port's.
* Hub entries load from ``file=`` (the JAX package's exporter writes it);
  ``pretrained=True`` without one raises, naming the asset.
* The two CLI tools carry a port checkpoint to a ``.pth`` and back.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import fullbatchtraining_tpu.models.models as jax_models
import fullbatchtraining_tpu.pretrained as jax_pretrained
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training import training as jax_training
from fullbatchtraining_tpu_torch import hub, pretrained
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import (export_jax_train_state, export_jax_variables,
                                                 load_jax_train_state)
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import TrainState, make_optimizer

from test_torch_families import randomize_
from test_torch_tools import write_port_checkpoint
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = sorted(p.stem for p in (ROOT / "config" / "model").glob("*.yaml") if p.stem != "linear")
# a plain-SGD ResNet run with warm-up and a cosine schedule: momentum and
# scheduler slots are filled
RUN = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
       "data.size=32", "data.batch_size=16", "seed=0", "hyp.steps=10", "hyp.warmup=2"]


def _model(cfg, seed=0):
    return randomize_(construct_model(cfg.model, 3, 10, seed=seed))


def _states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_matches_jax_and_converts_back(family, config_dir):
    cfg = load_config(config_dir, overrides=[f"model={family}"])
    model = _model(cfg)
    ours = pretrained.export_torch_state(model, cfg.model, step=7)
    ref = jax_pretrained.export_torch_state(export_jax_variables(model), cfg.model, step=7)
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        mine = ours[key].numpy()
        assert mine.dtype == value.dtype and mine.shape == value.shape, key
        np.testing.assert_array_equal(mine, value, err_msg=key)
    assert sum(k.endswith("num_batches_tracked") for k in ours) == sum(
        k.endswith("running_mean") for k in ours)
    fresh = construct_model(cfg.model, 3, 10, seed=1)
    pretrained.convert_torch_state(ours, fresh, cfg.model)
    assert _states_equal(fresh, model)


def test_convert_is_strict(config_dir):
    cfg = load_config(config_dir, overrides=["model=resnet20"])
    state = pretrained.export_torch_state(_model(cfg), cfg.model)
    with pytest.raises(KeyError, match="takes"):
        pretrained.convert_torch_state({**state, "extra.weight": torch.zeros(1)},
                                        construct_model(cfg.model, 3, 10), cfg.model)
    del state["fc.bias"]
    with pytest.raises(KeyError, match="no tensor"):
        pretrained.convert_torch_state(state, construct_model(cfg.model, 3, 10), cfg.model)


@pytest.mark.parametrize("downsample", ["B", "C"])
def test_resnet_import_probes_the_downsample_variant(downsample, config_dir):
    """A state dict of the B or C variant loads into the C-configured model:
    the upstream keys are found by shape, as the JAX package probes them."""
    cfg = load_config(config_dir, overrides=["model=resnet18", "model.width=4"])
    model = _model(cfg)
    state = pretrained.export_torch_resnet(model, downsample=downsample)
    assert any(f".downsample.{1 if downsample == 'B' else 2}.weight" in k for k in state)
    fresh = construct_model(cfg.model, 3, 10, seed=1)
    pretrained.convert_torch_resnet(state, fresh)
    assert _states_equal(fresh, model)


@pytest.mark.parametrize("overrides", [["model=resnet18", "model.normalization=SkipInit"],
                                       ["model=linear"]], ids=["skipinit", "linear"])
def test_refused_in_both_packages(overrides, config_dir):
    cfg = load_config(config_dir, overrides=overrides)
    model = construct_model(cfg.model, 3, 10)
    with pytest.raises(ValueError, match="SkipInit|linear"):
        pretrained.export_torch_state(model, cfg.model)
    with pytest.raises(ValueError, match="SkipInit|linear"):
        jax_pretrained.export_torch_state(export_jax_variables(model), cfg.model)


def _port_state(cfg, step=3):
    model = _model(cfg)
    optimizer = make_optimizer(model, cfg.hyp)
    g = torch.Generator().manual_seed(4)
    for p in model.parameters():
        optimizer.state[p]["momentum_buffer"] = 0.01 * torch.randn(p.shape, generator=g)
    return TrainState(step=step, model=model, optimizer=optimizer)


def _jax_template(config_dir, cfg_overrides, variables):
    cfg = jax_load_config(config_dir, overrides=cfg_overrides)
    bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
    model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
    mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
    fns = jax_training.make_train_functions(model, bundle, mesh, cfg)
    return cfg, fns, fns.init_state(variables)


def _fresh_state(cfg):
    model = construct_model(cfg.model, 3, 10, seed=9)
    return TrainState(step=0, model=model, optimizer=make_optimizer(model, cfg.hyp))


def _momentum(state):
    return [state.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]


def test_jax_5_tuple_imports_as_load_jax_train_state(config_dir, tmp_path):
    cfg = load_config(config_dir, overrides=RUN)
    tree = export_jax_train_state(_port_state(cfg))
    jcfg, fns, template = _jax_template(config_dir, RUN, {"params": tree["params"],
                                                          "batch_stats": tree["batch_stats"]})
    jax_state = serialization.from_state_dict(template, {**tree, "extra": None})
    file = jax_pretrained.export_reference_training_checkpoint(jax_state, jcfg,
                                                               tmp_path / "jax.pth")
    optim_state, _, scheduler_state, _, step = pretrained.read_reference_checkpoint(file)
    assert step == 3 and len(optim_state["state"]) == 62 and scheduler_state

    ours, step = pretrained.import_reference_training_checkpoint(file, cfg, _fresh_state(cfg))
    ref = _fresh_state(cfg)
    load_jax_train_state(ref, serialization.to_state_dict(jax.device_get(jax_state)))
    assert step == ours.step == ref.step == 3
    assert _states_equal(ours.model, ref.model)
    assert all(torch.equal(a, b) for a, b in zip(_momentum(ours), _momentum(ref)))


def test_port_5_tuple_imports_into_jax(config_dir, tmp_path):
    cfg = load_config(config_dir, overrides=RUN)
    state = _port_state(cfg)
    file = pretrained.export_reference_training_checkpoint(state, cfg, tmp_path / "port.pth")
    ours = export_jax_train_state(state)
    jcfg, fns, template = _jax_template(config_dir, RUN, {"params": ours["params"],
                                                          "batch_stats": ours["batch_stats"]})
    jax_state, step = jax_pretrained.import_reference_training_checkpoint(
        file, jcfg, template, schedule=fns.schedule)
    ref = serialization.to_state_dict(jax.device_get(jax_state))
    assert step == 3 and int(ref["step"]) == 3
    for key in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref[key]):
            mine = ours[key]
            for part in path:
                mine = mine[part.key]
            np.testing.assert_array_equal(mine, leaf, err_msg=jax.tree_util.keystr(path))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["opt_state"]["momentum"]):
        mine = ours["opt_state"]["momentum"]
        for part in path:
            mine = mine[part.key]
        np.testing.assert_array_equal(mine, leaf, err_msg=jax.tree_util.keystr(path))
    # the scheduler slot is the JAX exporter's, entry for entry
    jax_file = jax_pretrained.export_reference_training_checkpoint(jax_state, jcfg,
                                                                   tmp_path / "jax.pth")
    assert (pretrained.read_reference_checkpoint(file)[2]
            == pretrained.read_reference_checkpoint(jax_file)[2])


@pytest.mark.parametrize("entry", sorted(e for e in pretrained.RELEASE_FILES if "152" not in e))
def test_hub_entry_loads_a_local_file(entry, tmp_path):
    """The JAX package writes a release-format file of ResNet-18 weights;
    the port's hub entry loads it to the same tensors the port converts
    from those weights."""
    source = randomize_(pretrained.load_pretrained(entry, pretrained=False))
    variables = export_jax_variables(source)
    file = jax_pretrained.save_reference_checkpoint(variables, tmp_path / "asset.pth", step=5)
    model = getattr(hub, entry)(pretrained=True, file=file)
    assert _states_equal(model, source)


def test_hub_needs_a_local_file():
    for entry, asset in pretrained.RELEASE_FILES.items():
        with pytest.raises(FileNotFoundError, match=asset):
            getattr(hub, entry)(pretrained=True)
    with pytest.raises(FileNotFoundError, match="Nothing is downloaded"):
        hub.resnet18_fbaug_clip(pretrained=True, file="https://example.invalid/a.pth")
    model = hub.resnet152_fbaug_highreg()   # pretrained=False, as upstream
    assert sum(p.numel() for p in model.parameters()) > 50_000_000
    with pytest.raises(ValueError, match="Unknown entry"):
        pretrained.load_pretrained("resnet9000")


def test_torch_parameter_order_is_the_jax_packages(config_dir):
    for family in ("resnet18", "resnet50"):
        cfg = load_config(config_dir, overrides=[f"model={family}", "model.width=4"])
        state = pretrained.export_torch_state(construct_model(cfg.model, 3, 10), cfg.model)
        assert pretrained.torch_parameter_keys(state) == jax_pretrained.torch_parameter_keys(
            {k: v.numpy() for k, v in state.items()})


def test_cli_tools_round_trip(config_dir, tmp_path):
    """``tools.export_reference_checkpoint`` then
    ``tools.import_reference_checkpoint``: the port checkpoint comes back
    with the same weights, running stats, momentum buffers and step."""
    overrides = RUN + ["impl.checkpoint.name=tiny.ckpt"]
    write_port_checkpoint(config_dir, overrides, tmp_path)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for module, extra in (("export", ["+out=export/tiny.pth"]),
                          ("import", ["+in=export/tiny.pth", "impl.checkpoint.name=back.ckpt"])):
        run = subprocess.run(
            [sys.executable, "-m", f"fullbatchtraining_tpu_torch.tools.{module}_reference_checkpoint",
             *overrides, *extra, "+impl.device=cpu", f"base_dir={tmp_path / 'out'}"],
            cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    a, b = (torch.load(tmp_path / "checkpoints" / name, weights_only=True)
            for name in ("tiny.ckpt", "back.ckpt"))
    assert a["step"] == b["step"] == 3
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert len(sa) == len(sb) == 62
    assert all(torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]) for i in sa)
