"""The port stands alone: it imports neither JAX nor the JAX package, and
asking it for a card that is absent raises instead of running on the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fullbatchtraining_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = pathlib.Path(fullbatchtraining_tpu_torch.__file__).parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|fullbatchtraining_tpu)(\s|\.|$|,)", re.MULTILINE)
TINY = ["hyp=fb1", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
        "dryrun=True"]


def _modules():
    return sorted("fullbatchtraining_tpu_torch." + ".".join(
        p.relative_to(PACKAGE).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    assert {"fullbatchtraining_tpu_torch.data.baked",
            "fullbatchtraining_tpu_torch.data.policy_augment",
            "fullbatchtraining_tpu_torch.parallel",
            "fullbatchtraining_tpu_torch.parallel.streaming",
            *(f"fullbatchtraining_tpu_torch.models.{name}" for name in (
                "densenets", "layers", "modules", "nfnets", "pyramidnets", "resnets", "vgg")),
            *(f"fullbatchtraining_tpu_torch.training.opt.{name}" for name in (
                "adaptive_clipping", "agc", "closures", "fista", "lars", "lbfgs")),
            *(f"fullbatchtraining_tpu_torch.visualization.{name}" for name in (
                "crunch", "database", "plotting")),
            "fullbatchtraining_tpu_torch.visualization", "fullbatchtraining_tpu_torch.pretrained",
            "fullbatchtraining_tpu_torch.hub", "fullbatchtraining_tpu_torch.data.lmdb_reader",
            *(f"fullbatchtraining_tpu_torch.tools.{name}" for name in (
                "lmdb_import", "import_reference_checkpoint", "export_reference_checkpoint")),
            *(f"fullbatchtraining_tpu_torch.{name}" for name in (
                "crunch_loss_landscape", "verify_model_checkpoint",
                "measure_floating_point_accuracy"))
            } <= set(_modules())
    script = f"""
import importlib, sys
for name in {_modules()!r}:
    importlib.import_module(name.removesuffix("."))
bad = [m for m in sys.modules if m in ("jax", "flax", "optax") or m.split(".")[0] in
       ("jax", "flax", "optax") or m == "fullbatchtraining_tpu"
       or m.startswith("fullbatchtraining_tpu.")]
assert not bad, bad
print("ISOLATED", len({_modules()!r}))
"""
    run = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "ISOLATED" in run.stdout


def test_source_has_no_jax_import():
    files = [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "bn_ab.py",
             ROOT / "f16_matmul.py"]
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_train_on_absent_card_raises(config_dir, monkeypatch):
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(config_dir, overrides=TINY)
    bundle = construct_databundle(cfg.data, dryrun=True)
    model = construct_model(cfg.model, bundle.channels, bundle.classes)
    with pytest.raises(RuntimeError, match="cuda"):
        train(model, bundle, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        train(model, bundle, cfg)  # the default device is the card


@pytest.mark.parametrize("device", ["cpu", "default"])
def test_cli_dryrun(device, tmp_path):
    """``python -m fullbatchtraining_tpu_torch`` runs the main path here with
    +impl.device=cpu, and refuses to start without a card otherwise."""
    args = TINY + [f"base_dir={tmp_path}"] + (["+impl.device=cpu"] if device == "cpu" else [])
    run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if device == "cpu" or torch.cuda.is_available():
        assert run.returncode == 0, run.stdout + run.stderr
        assert "Final validation accuracy" in run.stdout
    else:
        assert run.returncode != 0
        assert "torch.cuda.is_available() is False" in run.stderr


def test_cli_dryrun_distributed_world_of_one(tmp_path):
    """``impl/setup=distributed`` with nothing to rendezvous with runs as a
    gloo group of one process on the CPU."""
    args = TINY + [f"base_dir={tmp_path}", "+impl.device=cpu", "impl/setup=distributed"]
    run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "rank 0 of 1" in run.stdout and "Final validation accuracy" in run.stdout


def test_cli_dryrun_default_recipe(tmp_path):
    """With no ``hyp=`` override the CLI runs ``config/cfg.yaml``'s default,
    ``hyp=base_sgd``: stochastic, shuffled SGD."""
    args = [a for a in TINY if not a.startswith("hyp=")] + [f"base_dir={tmp_path}",
                                                            "+impl.device=cpu"]
    run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "template_name: baseline" in run.stdout and "train_stochastic: true" in run.stdout
    assert "Final validation accuracy" in run.stdout


# full-width families run their dryrun step on blocks of 16 images
SMALL_BLOCK = ["data.batch_size=16"]
# modes that raised until the streamed epochs, other datasets, the optimizer
# zoo, the other model families and norms, analysis, the loss landscape's
# snapshots, the profiler trace and float16 came in
FORMER_BOUNDARIES = {
    "trace": ["impl.trace=True"],
    "float16-compute": ["impl.compute_dtype=float16"],
    "float16-params": ["impl.dtype=float16"],
    "model-snapshots": ["analysis=full", "analysis.save_model_every_nth_step=1"],
    "analysis": ["analysis=full", "analysis.compute_gradient_SNR=True",
                 "analysis.compute_gradient_noise_scale=True", "analysis.compute_flatness=True"],
    "lars": ["hyp/optim_modification=LARS"],
    "larc": ["hyp/optim_modification=LARC"],
    "fista": ["hyp/optim=fista"],
    "gd-agc": ["hyp/optim=gd_agc"],
    "adam": ["hyp/optim=adam"],
    "gd-clip": ["hyp/optim=gd_clip"],
    "lbfgs": ["hyp/optim=lbfgs"],
    # the shuffled epoch above the device gather's limit: gathered on the host
    "shuffle-over-budget": ["hyp.shuffle=True", "impl.device_shuffle_max_bytes=1"],
    "random-resized-crop": ["+data.augmentations_train.RandomResizedCrop=32"],
    "tinyimagenet": ["data=TinyImageNet"],
    "resize-eval": ["+data.augmentations_val.Resize=32"],
    "vgg": ["model=vgg11", *SMALL_BLOCK],
    "densenet": ["model=densenet121", *SMALL_BLOCK],
    # GroupNorm's 32 groups need a width that 32 divides
    "groupnorm": ["model.normalization=GroupNorm", "model.width=32", *SMALL_BLOCK],
    "pyramidnet": ["model=pyramidnet110", *SMALL_BLOCK],
    "nfnet": ["model=nfn", *SMALL_BLOCK],
    "linear": ["model=linear"],
    "ghostnorm": ["model.normalization=SequentialGhostNorm"],
    "skipinit": ["model.normalization=SkipInit"],
    "layernorm": ["model.normalization=LayerNorm"],
    "standardized": ["model.convolution=Standardized"],
}


@pytest.mark.parametrize("case", list(FORMER_BOUNDARIES))
def test_modes_now_in_the_slice_run(case, config_dir, monkeypatch, tmp_path):
    """A mode that once raised NotImplementedError runs a dryrun step and
    its evaluation on the CPU (on one intra-op thread: tiny ops, which
    several test workers with a thread per core each slow down), in a
    working directory of its own (snapshots are written there)."""
    monkeypatch.chdir(tmp_path)
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    swaps_model = any(o.startswith("model=") for o in FORMER_BOUNDARIES[case])
    base = [o for o in TINY if not (swaps_model and o.startswith("model"))]
    cfg = load_config(config_dir, overrides=base + FORMER_BOUNDARIES[case])
    bundle = construct_databundle(cfg.data, dryrun=True)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, pixels=bundle.pixels)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, stats = train(model, bundle, cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(stats["train_loss"]) == 1 and len(stats["valid_loss"]) == 1
    assert all(np.isfinite(stats["train_loss"] + stats["valid_loss"]))
    assert bool(list(tmp_path.glob("*_step_1.pt"))) == (case == "model-snapshots")


BAKED = ["data/db=baked", "data.db.rounds=2", "data.augmentations_train="]


@pytest.mark.parametrize("recipe", ["fb1", "semi-stochastic", "no-card"])
def test_cli_dryrun_baked(recipe, tmp_path):
    """The 10x CIFAR lines of ``train.sh`` (cut to 2 rounds) run here on a
    store baked under ``tmp_path``; without +impl.device=cpu the bake
    refuses to start without a card."""
    hyp = (["hyp=base_sgd", "hyp.train_semi_stochastic=True"] if recipe == "semi-stochastic"
           else ["hyp=fb1"])
    args = ([o for o in TINY if not o.startswith("hyp=")] + hyp + BAKED
            + [f"data.db.path={tmp_path / 'db'}", f"base_dir={tmp_path}"]
            + ([] if recipe == "no-card" else ["+impl.device=cpu"]))
    run = subprocess.run([sys.executable, "-m", "fullbatchtraining_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if recipe != "no-card" or torch.cuda.is_available():
        assert run.returncode == 0, run.stdout + run.stderr
        assert "Final validation accuracy" in run.stdout
        assert len(list((tmp_path / "db").glob("CIFAR10_256_rounds2_*/meta.json"))) == 1
    else:
        assert run.returncode != 0
        assert "torch.cuda.is_available() is False" in run.stderr


def test_semi_stochastic_without_a_store_changes_nothing(config_dir):
    """Without ``data.db`` the flag has nothing to pick rounds from: the run
    is the run without it, bitwise."""
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.data import construct_databundle
    from fullbatchtraining_tpu_torch.models import construct_model
    from fullbatchtraining_tpu_torch.training import train

    runs = []
    for extra in ([], ["hyp.train_semi_stochastic=True"]):
        cfg = load_config(config_dir, overrides=[
            "hyp=base_sgd", "model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__",
            "data.size=32", "data.batch_size=8", "hyp.steps=2", "hyp.warmup=0",
            "seed=0"] + extra)
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=0)
        state, stats = train(model, bundle, cfg, device="cpu")
        runs.append((state.model.state_dict(), stats))
    (ours, ours_stats), (ref, ref_stats) = runs[1], runs[0]
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert {k: v for k, v in ours_stats.items() if k != "train_time"} == {
        k: v for k, v in ref_stats.items() if k != "train_time"}

