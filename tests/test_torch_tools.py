"""The port's CLIs besides training, on the CPU.

* ``verify_model_checkpoint`` on a port checkpoint against the JAX
  script's ``main`` on the same state written as a JAX checkpoint (float64,
  1e-10).
* ``measure_floating_point_accuracy``: the JAX function's six keys, all
  zero here (two passes from one state, the running stats restored and the
  generators seeded afresh).
* Each CLI module runs a dryrun through ``python -m ... +impl.device=cpu``
  and, without ``+impl.device``, refuses to start without a card.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import fullbatchtraining_tpu.models as jax_models_pkg
import fullbatchtraining_tpu.models.models as jax_models
import measure_floating_point_accuracy as jax_measure
import verify_model_checkpoint as jax_verify
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training import training as jax_training
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_train_state
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.measure_floating_point_accuracy import (
    measure_implementation_noise)
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import TrainState, make_optimizer
from fullbatchtraining_tpu_torch.training.utils import state_payload, write_checkpoint
from fullbatchtraining_tpu_torch.verify_model_checkpoint import verify_checkpoint

from test_torch_families import randomize_
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10
TINY = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
        "data.size=64", "data.batch_size=32", "hyp.sub_batch=16", "seed=0",
        "impl.checkpoint.name=tiny.ckpt"]
FP64 = ["data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
        "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1",
        "hyp.warmup=0"]
CLIS = ["crunch_loss_landscape", "verify_model_checkpoint", "measure_floating_point_accuracy",
        "tools.import_reference_checkpoint", "tools.export_reference_checkpoint"]
PACKAGE = "fullbatchtraining_tpu_torch"


def write_port_checkpoint(config_dir, overrides, folder, step=3, dtype=torch.float32):
    """A port checkpoint of ``overrides``'s model (random norm parameters and
    running stats, SGD momentum buffers) at ``<folder>/checkpoints/tiny.ckpt``;
    returns ``(cfg, state)``."""
    cfg = load_config(config_dir, overrides=overrides)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    model = randomize_(construct_model(cfg.model, bundle.channels, bundle.classes,
                                       seed=0).to(dtype))
    optimizer = make_optimizer(model, cfg.hyp)
    g = torch.Generator().manual_seed(2)
    for p in model.parameters():
        optimizer.state[p]["momentum_buffer"] = 0.01 * torch.randn(p.shape, generator=g,
                                                                   dtype=dtype)
    state = TrainState(step=step, model=model, optimizer=optimizer)
    (folder / "checkpoints").mkdir(parents=True, exist_ok=True)
    write_checkpoint(state_payload(state), folder / "checkpoints" / "tiny.ckpt")
    return cfg, state


def test_verify_matches_the_jax_script(config_dir, tmp_path, monkeypatch):
    overrides = TINY + FP64
    cfg, state = write_port_checkpoint(config_dir, overrides, tmp_path / "port", step=3,
                                       dtype=torch.float64)
    ours = verify_checkpoint(cfg, tmp_path / "port" / "checkpoints" / "tiny.ckpt", "cpu")

    # the same state as a JAX checkpoint, evaluated by the JAX script's main
    # (its run directory and logging set-up stubbed: they change the process)
    monkeypatch.chdir(tmp_path)
    with jax.enable_x64(True):
        jcfg = jax_load_config(config_dir, overrides=overrides)
        bundle = jax_databundle(jcfg.data, jcfg.impl, jcfg.hyp, seed=0)
        model = jax_models.construct_model(jcfg.model, bundle.channels, bundle.classes)
        variables = jax.device_get(jax_models.initialize_model(
            model, jax.random.key(0), bundle.pixels, bundle.channels, dtype=jnp.float64))
        mesh = make_mesh(jcfg.impl.setup, devices=np.asarray(jax.devices()[:1]))
        template = jax_training.make_train_functions(model, bundle, mesh, jcfg).init_state(
            variables)
        (tmp_path / "checkpoints").mkdir()
        (tmp_path / "checkpoints" / "tiny.ckpt").write_bytes(serialization.to_bytes(
            serialization.from_state_dict(template, {**export_jax_train_state(state),
                                                     "extra": None})))
        monkeypatch.setattr(jax_models_pkg, "initialize_model", lambda *a, **k: variables)
        monkeypatch.setattr(jax_verify, "job_startup", lambda cfg, *a, **k: cfg)
        monkeypatch.setattr(jax_verify, "system_startup", lambda cfg: make_mesh(
            cfg.impl.setup, devices=np.asarray(jax.devices()[:1])))
        ref = jax.device_get(jax_verify.main(overrides))
    assert set(ours) == set(ref) == {"valid_loss", "valid_acc"}
    for key in ref:
        np.testing.assert_allclose(ours[key], float(ref[key]), rtol=RTOL, err_msg=key)
    assert 0 < ours["valid_loss"] and 0 <= ours["valid_acc"] <= 1


def test_measure_gives_the_jax_keys_all_zero(config_dir):
    """The port on ResNet-18 (BatchNorm, whose running stats the first pass
    moves and the second must not see), augmented: both passes draw the
    same crops and flips. The JAX function on the ``linear`` model gives
    the keys (its compile of a ResNet costs tenfold)."""
    ours = measure_implementation_noise(load_config(config_dir, overrides=TINY), "cpu")
    jcfg = jax_load_config(config_dir, overrides=[o for o in TINY if not o.startswith("model")]
                           + ["model=linear"])
    ref = jax_measure.measure_implementation_noise(
        jcfg, make_mesh(jcfg.impl.setup, devices=np.asarray(jax.devices()[:1])))
    assert list(ours) == list(ref)
    assert all(v == 0.0 for v in ours.values()), ours
    assert all(v == 0.0 for v in ref.values()), ref


def test_measure_sees_a_difference(config_dir, monkeypatch):
    """The audit reads the two passes apart: a second pass one ulp off
    shows in every deviation."""
    from fullbatchtraining_tpu_torch.training.training import Trainer

    real, calls = Trainer.pre_step_gradient, []

    def second_off(self, *args):
        grads = real(self, *args)
        calls.append(1)
        if len(calls) == 2:
            grads = [torch.nextafter(g, torch.full_like(g, float("inf"))) for g in grads]
        return grads

    monkeypatch.setattr(Trainer, "pre_step_gradient", second_off)
    out = measure_implementation_noise(load_config(config_dir, overrides=TINY), "cpu")
    assert len(calls) == 2 and all(v > 0 for v in out.values()), out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, config_dir):
    folder = tmp_path_factory.mktemp("cli")
    write_port_checkpoint(config_dir, TINY, folder)
    return folder


CLI_EXTRA = {
    "crunch_loss_landscape": (["viz=1d", "viz.coordinates.x.num=3"],
                              "Surface complete: 3 positions"),
    "verify_model_checkpoint": ([], "Checkpoint step 3: valid_loss"),
    "measure_floating_point_accuracy": ([], "abs_linf: 0.000e+00"),
    "tools.export_reference_checkpoint": (["+out=export/tiny.pth"], "Exported tiny.ckpt step 3"),
}


@pytest.mark.parametrize("module", list(CLI_EXTRA))
def test_cli_dryrun_on_the_cpu(module, run_dir):
    extra, expected = CLI_EXTRA[module]
    run = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.{module}", *TINY, *extra, "dryrun=True",
         "+impl.device=cpu", f"base_dir={run_dir / 'out'}"],
        cwd=run_dir, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT})
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert expected in run.stdout, run.stdout[-3000:]


@pytest.mark.parametrize("module", CLIS)
def test_cli_needs_a_card_unless_told_otherwise(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = importlib.import_module(f"{PACKAGE}.{module}")
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        cli.main(TINY)


@pytest.mark.parametrize("module", CLIS)
def test_cli_refuses_multirun(module, monkeypatch):
    """Each CLI once refused ``--multirun`` (the name is kept from then); it
    now runs the sweep's jobs in order through ``utils.hydra_main``, each
    with its number and the sweep's one stamp."""
    cli = importlib.import_module(f"{PACKAGE}.{module}")
    calls = []
    monkeypatch.setattr(cli, "_job", lambda overrides, job_num=None, sweep_stamp=None:
                        calls.append((overrides[-1], job_num, sweep_stamp)))
    cli.main(["--multirun", *TINY, "seed=0,1"])
    assert [c[:2] for c in calls] == [("seed=0", 0), ("seed=1", 1)]
    assert calls[0][2] is not None and calls[0][2] == calls[1][2]
