"""The port's data parallelism on the CPU: two gloo ranks against the JAX
package's 2-device mesh, and the rank-0 duties of a job.

Each rank is a process of its own: the port's CLI (``python -m
fullbatchtraining_tpu_torch ... impl/setup=distributed
impl.setup.url=127.0.0.1:<port> impl.setup.world_size=2
impl.setup.rank=<r> +impl.device=cpu``) through :data:`RUNNER`, which
imports only the port and records which rank writes a checkpoint, bakes,
opens or removes a store; or :data:`PROBE`, which calls the trainer's step
functions. Every spawn runs with ``OMP_NUM_THREADS=1`` and a hard time
limit, and a failed rank takes the others down with it, so a hung
collective fails one test.

The oracle is the JAX ``train()`` on ``make_mesh(devices=jax.devices()[:2])``
in float64, unaugmented, ``impl.block_grouping=1``, from the port's seed
weights (``convert.export_jax_variables``). Rank 0's checkpoint (params, BN
stats, EMA) and its stats table agree with it to rtol 1e-8, as the
single-device parity tests do: float64 with different summation orders
keeps about 1e-13 relative per op. Each JAX case pays for one compile of
the 2-device program, so its three cases (``fb1``, ``gradreg`` with
``acc_strength``, stochastic SAM) are in
``tests/test_torch_distributed_parity.py``, which calls
:func:`check_jax_case`.
"""

import csv
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import fullbatchtraining_tpu.models.models as jax_models
from fullbatchtraining_tpu.config import load_config as jax_load_config
from fullbatchtraining_tpu.data import construct_databundle as jax_databundle
from fullbatchtraining_tpu.parallel import make_mesh
from fullbatchtraining_tpu.training.training import stage_epoch as jax_stage_epoch
from fullbatchtraining_tpu.training.training import stage_validation as jax_stage_validation
from fullbatchtraining_tpu.training.training import train as jax_train
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.convert import export_jax_variables
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.parallel import World
from fullbatchtraining_tpu_torch.training.training import (TrainState, Trainer, make_optimizer,
                                                           stage_validation)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-8
RANK_TIMEOUT = 240   # seconds for a whole 2-rank job

TINY = ["model=resnet18", "model.width=4", "data.path=/tmp/__torch_nodata__"]
FP64 = ["data.augmentations_train=", "impl.dtype=float64", "impl.accumulation_dtype=float64",
        "impl.mixed_precision=False", "impl.block_grouping=1", "impl.eval_block_chunks=1"]
PARITY = TINY + FP64 + ["hyp.steps=2", "hyp.warmup=0", "impl.validate_every_nth_step=1",
                        "seed=0", "name=dist_parity"]
# per rank: 2 blocks of 16 in chunks of 8 (fb1, gradreg); 2 blocks of 8 in chunks of 4 (SGD)
FB = ["data.size=64", "data.batch_size=16", "hyp.sub_batch=8"]
SGD = ["hyp=base_sgd", "data.size=32", "data.batch_size=8", "hyp.sub_batch=4"]

RUNNER = """
import json, os, sys
from fullbatchtraining_tpu_torch import __main__ as cli
from fullbatchtraining_tpu_torch.data import baked
from fullbatchtraining_tpu_torch.training import utils


def recording(event, fn, where):
    def wrapped(*args, **kwargs):
        with open(os.environ["FBT_TEST_EVENTS"], "a") as out:
            out.write(json.dumps([int(os.environ["FBT_TEST_RANK"]), event,
                                  str(where(*args))]) + "\\n")
        return fn(*args, **kwargs)
    return wrapped


utils.write_checkpoint = recording("write", utils.write_checkpoint, lambda payload, file: file)
baked._bake_rounds = recording("bake", baked._bake_rounds, lambda *args: "")
baked.BakedDataset.__init__ = recording("open", baked.BakedDataset.__init__, lambda s, d: d)
baked.BakedDataset.cleanup = recording("cleanup", baked.BakedDataset.cleanup, lambda s: s.dir)
cli.main(sys.argv[1:])
"""


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(command, cwd, world=2, timeout=RANK_TIMEOUT):
    """Run ``command(rank)`` (an argv) as ``world`` processes in ``cwd``;
    every one is killed once one fails or ``timeout`` s pass. Returns each
    rank's output."""
    cwd = pathlib.Path(cwd)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "FBT_TEST_EVENTS": str(cwd / "events.jsonl"),
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    logs = [cwd / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(command(r), cwd=cwd, stdout=out,
                                              stderr=subprocess.STDOUT,
                                              env={**env, "FBT_TEST_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = [log.read_text() for log in logs]
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return outputs


def run_cli(overrides, cwd, world=2, out="out"):
    """The port's CLI as ``world`` gloo ranks on the CPU, through :data:`RUNNER`,
    with ``base_dir=<cwd>/<out>``."""
    port = free_port()
    return spawn_ranks(lambda r: [
        sys.executable, "-c", RUNNER, *overrides, "+impl.device=cpu", "impl/setup=distributed",
        f"impl.setup.url=127.0.0.1:{port}", f"impl.setup.world_size={world}",
        f"impl.setup.rank={r}", f"base_dir={pathlib.Path(cwd) / out}"], cwd, world)


def events(cwd):
    file = pathlib.Path(cwd) / "events.jsonl"
    return [tuple(json.loads(line)) for line in file.read_text().splitlines()] if file.exists() else []


def read_table(base) -> dict:
    """Rank 0's per-step stats table (``save_summary``'s convergence table)."""
    [file] = pathlib.Path(base).glob("**/table_*_convergence_results.csv")
    with open(file, newline="") as handle:
        rows = list(csv.DictReader(handle, delimiter="\t"))
    return {key: [float(row[key]) for row in rows] for key in rows[0]}


def _assert_trees_close(ours, ref, path=""):
    assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_trees_close(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=RTOL, atol=1e-12,
                                       err_msg=f"{path}/{key}")


def _port_model(cfg, bundle, state_dict=None):
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    if state_dict is not None:
        model.to(torch.float64).load_state_dict(state_dict)
    return model


def check_jax_case(extra, config_dir, monkeypatch, tmp_path):
    """``PARITY + extra`` as two gloo ranks of the port's CLI and on the JAX
    package's 2-device mesh: rank 0's checkpoint and stats table against the
    JAX ``train()``'s state and stats."""
    overrides = PARITY + list(extra)
    run_cli(overrides + ["impl.checkpoint.name=parity.ckpt"], tmp_path)
    writes = [e for e in events(tmp_path) if e[1] == "write"]
    assert writes and {rank for rank, _, _ in writes} == {0}, writes

    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=0, device="cpu")
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             export_jax_variables(_port_model(tcfg, tbundle)))
    with jax.enable_x64(True):
        cfg = jax_load_config(config_dir, overrides=overrides)
        mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:2]))
        bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0)
        model = jax_models.construct_model(cfg.model, bundle.channels, bundle.classes)
        monkeypatch.setattr(jax_models, "initialize_model", lambda *a, **k: variables)
        state, ref_stats = jax_train(model, bundle, mesh, cfg)
        ref_params, ref_bn, ref_ema = jax.device_get(
            (state.params, state.batch_stats, state.ema_params))
    np.testing.assert_array_equal(tbundle.train.images, bundle.train.images)

    payload = torch.load(tmp_path / "checkpoints" / "parity.ckpt", weights_only=True)
    assert payload["step"] == 2
    ours = export_jax_variables(_port_model(tcfg, tbundle, payload["model"]))
    _assert_trees_close(ours["params"], ref_params, "params")
    _assert_trees_close(ours["batch_stats"], ref_bn, "batch_stats")
    if ref_ema is not None:
        ema = export_jax_variables(_port_model(tcfg, tbundle, payload["ema_model"]))
        _assert_trees_close(ema["params"], ref_ema, "ema")

    stats = read_table(tmp_path / "out")
    keys = set(ref_stats) - {"train_time"}
    assert keys == set(stats) - {"train_time"}
    for key in sorted(keys):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=RTOL, atol=1e-12,
                                   err_msg=key)
    return stats


# ---------------------------------------------------------------------------
# the step functions of two ranks: first-step gradients and collective counts
# ---------------------------------------------------------------------------

PROBE = """
import json, sys
import torch
from fullbatchtraining_tpu_torch import parallel
from fullbatchtraining_tpu_torch.__main__ import CONFIG_DIR
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import training

out, overrides = sys.argv[1], sys.argv[2:]
cfg = load_config(CONFIG_DIR, overrides=overrides)
world = parallel.setup_distributed(cfg.impl.setup, "cpu")
bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed, device="cpu")
model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
trainer = training.Trainer(model, bundle, cfg, torch.device("cpu"), world)
state = training.TrainState(step=0, model=model,
                            optimizer=training.make_optimizer(model, cfg.hyp))
images, labels = trainer.stage(0)
grads, metrics, norms = trainer.gradient_eval(state, images, labels)
torch.save({"grads": grads, "norms": norms, "metrics": metrics}, f"{out}.rank{world.rank}")
val = training.stage_validation(bundle, bundle.batch_size, "cpu", world=world)


def count(step):
    parallel.reset_counts()
    step()
    return dict(parallel.calls)


counts = {"full_step": count(lambda: trainer.full_step(state, images, labels)),
          "eval_step": count(lambda: trainer.eval_step(model, *val)),
          "stochastic_step": count(lambda: trainer.stochastic_step(state, images, labels))}
trainer.sam_rho = 0.05
counts["sam_step"] = count(lambda: trainer.sam_step(state, images, labels))
counts["sam_stochastic_step"] = count(lambda: trainer.stochastic_step(state, images, labels))
print("PROBE", json.dumps({"counts": counts, "blocks": trainer.num_blocks,
                           "rank": world.rank, "size": world.size}))
parallel.shutdown(world)
"""
PROBED = TINY + FP64 + FB + ["hyp=fb1", "hyp.warmup=0", "seed=0"]


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """:data:`PROBE` as two gloo ranks: each rank's report and the file
    prefix of their first-step gradients."""
    cwd = tmp_path_factory.mktemp("probe")
    port = free_port()
    outputs = spawn_ranks(lambda r: [
        sys.executable, "-c", PROBE, str(cwd / "grads"), *PROBED, "impl/setup=distributed",
        f"impl.setup.url=127.0.0.1:{port}", "impl.setup.world_size=2",
        f"impl.setup.rank={r}"], cwd)
    reports = [json.loads(out.split("PROBE ", 1)[1].splitlines()[0]) for out in outputs]
    return reports, cwd / "grads"


def test_two_ranks_first_step_gradient_equals_one_process(probe, config_dir):
    """The first full-batch gradient of two ranks, each over 2 of the 4
    blocks, equals one process's over all 4 to 1e-12 in float64; both ranks
    hold the same; chunk norm slot ``(r, b, c)`` is one process's chunk
    ``(2b + r, c)``, and ``grad_norm * sqrt(2)`` its ``grad_norm``."""
    _, prefix = probe
    ranks = [torch.load(f"{prefix}.rank{r}", weights_only=True) for r in range(2)]
    cfg = load_config(config_dir, overrides=PROBED)
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=0, device="cpu")
    model = _port_model(cfg, bundle)
    trainer = Trainer(model, bundle, cfg, torch.device("cpu"), World())
    state = TrainState(step=0, model=model, optimizer=make_optimizer(model, cfg.hyp))
    grads, metrics, norms = trainer.gradient_eval(state, *trainer.stage(0))
    for ours, theirs in zip(ranks[0]["grads"], ranks[1]["grads"]):
        assert torch.equal(ours, theirs)
    for ours, ref in zip(ranks[0]["grads"], grads):
        assert ours.dtype == torch.float64
        assert (ours - ref).norm().item() <= 1e-12 * ref.norm().item()
    blocks, chunks = trainer.num_blocks, trainer.chunks   # 4 blocks of 2 chunks
    slots = ranks[0]["norms"].view(2, blocks // 2, chunks)
    np.testing.assert_allclose(slots.transpose(0, 1).reshape(-1), norms, rtol=1e-12)
    two = ranks[0]["metrics"]
    for key in ("train_loss", "train_acc", "full_loss", "param_norm"):
        np.testing.assert_allclose(two[key], metrics[key], rtol=1e-12, err_msg=key)
    np.testing.assert_allclose(two["grad_norm"] * 2 ** 0.5, metrics["grad_norm"], rtol=1e-12)


def test_collectives_a_step(probe):
    """One all_reduce a full-batch step, two under SAM, one an evaluation; a
    stochastic epoch one an update (two under SAM) and one at its end; no
    broadcast or barrier."""
    reports, _ = probe
    blocks = reports[0]["blocks"]
    expected = {"full_step": 1, "eval_step": 1, "stochastic_step": blocks + 1,
                "sam_step": 2, "sam_stochastic_step": 2 * blocks + 1}
    for report in reports:
        assert report["size"] == 2 and blocks == 2
        assert {k: v["all_reduce"] for k, v in report["counts"].items()} == expected
        assert all(v["broadcast"] == v["barrier"] == 0 for v in report["counts"].values())


# ---------------------------------------------------------------------------
# L-BFGS's flat vectors sharded over the ranks (impl.shard_opt_vectors)
# ---------------------------------------------------------------------------

LBFGS_RUN = """
import sys
import torch
from fullbatchtraining_tpu_torch import parallel
from fullbatchtraining_tpu_torch.__main__ import CONFIG_DIR
from fullbatchtraining_tpu_torch.config import load_config
from fullbatchtraining_tpu_torch.data import construct_databundle
from fullbatchtraining_tpu_torch.models import construct_model
from fullbatchtraining_tpu_torch.training import training

out, overrides = sys.argv[1], sys.argv[2:]
cfg = load_config(CONFIG_DIR, overrides=overrides)
world = parallel.setup_distributed(cfg.impl.setup, "cpu")
drivers = []
make = training.make_closure_step
training.make_closure_step = lambda *args: drivers.append(make(*args)) or drivers[-1]
bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, seed=cfg.seed, device="cpu")
model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
state, stats = training.train(model, bundle, cfg, device="cpu", world=world)
driver = drivers[0]
held = [driver.prev_flat_grad, driver.Bs, driver.d, *driver.s_hist, *driver.y_hist]
torch.save({"params": [p.detach() for p in model.parameters()], "state": driver.get_state(),
            "held": [v.numel() for v in held], "stats": dict(stats)}, f"{out}.rank{world.rank}")
parallel.shutdown(world)
"""
# width 3: 25,297 params, an odd count, so the shards carry one element of padding
LBFGS_SHARDED = ["model=resnet18", "model.width=3", "data.path=/tmp/__torch_nodata__", *FP64,
                 *FB, "hyp=fb1", "hyp/optim=lbfgs", "hyp.steps=3", "hyp.warmup=0", "seed=0",
                 "impl/setup=distributed", "impl.setup.world_size=2"]


def test_sharded_lbfgs_vectors_equal_the_unsharded_run(tmp_path):
    """Two gloo ranks of L-BFGS with ``impl.shard_opt_vectors=True`` against
    two without: params, stats and the driver state agree to rtol 1e-10 (the
    dots reduce in another order); each rank holds ``ceil(n / 2)`` elements
    of every flat vector, and ``get_state()`` carries the ``n`` unpadded."""
    runs = {}
    for sharded in (False, True):
        port = free_port()
        prefix = tmp_path / f"sharded{int(sharded)}"
        spawn_ranks(lambda r: [
            sys.executable, "-c", LBFGS_RUN, str(prefix), *LBFGS_SHARDED,
            f"impl.shard_opt_vectors={sharded}", f"impl.setup.url=127.0.0.1:{port}",
            f"impl.setup.rank={r}"], tmp_path)
        runs[sharded] = [torch.load(f"{prefix}.rank{r}", weights_only=True) for r in range(2)]
    n = sum(p.numel() for p in runs[False][0]["params"])
    assert n % 2 == 1
    for rank in range(2):
        plain, sharded = runs[False][rank], runs[True][rank]
        assert set(plain["held"]) == {n}
        assert set(sharded["held"]) == {(n + 1) // 2}
        for a, b in zip(sharded["params"], plain["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
        assert sharded["stats"].keys() == plain["stats"].keys()
        for key in plain["stats"]:
            if key != "train_time":
                np.testing.assert_allclose(sharded["stats"][key], plain["stats"][key],
                                           rtol=1e-10, err_msg=key)
        ours, ref = sharded["state"], plain["state"]
        assert len(ref["s_hist"]) == 2 and ours.keys() == ref.keys()
        for key in ref:
            a, b = ours[key], ref[key]
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b],
                            strict=True):
                if isinstance(y, torch.Tensor):
                    assert x.shape == y.shape == (n,), key
                np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-14, err_msg=key)


# ---------------------------------------------------------------------------
# rank 0's duties: the seed, checkpoints, the bake
# ---------------------------------------------------------------------------

def test_unset_seed_is_rank_zeros(tmp_path):
    """With ``seed=null`` each rank draws its own seed; rank 0's wins on both."""
    outputs = run_cli(TINY + ["hyp=fb1", "dryrun=True", "seed=null"], tmp_path)
    seeds = [int(out.split("Config name: ", 1)[1].split("seed: ", 1)[1].split(",")[0])
             for out in outputs]
    assert seeds[0] == seeds[1], seeds
    assert [p.name.endswith("_rank1") for p in (tmp_path / "out").glob("*/*")].count(True) == 1


def test_resume_of_two_ranks_is_the_straight_run(tmp_path):
    """Two ranks, 2 steps straight through and as 1 step then a resume: the
    checkpoints (params, running stats, momentum) are bitwise equal, so are
    step 2's stats, and only rank 0 wrote them."""
    base = TINY + FB + ["hyp=fb1", "hyp.scheduler=none", "hyp.warmup=0", "seed=0",
                        "impl.validate_every_nth_step=1"]
    run_cli(base + ["hyp.steps=2", "impl.checkpoint.name=straight.ckpt"], tmp_path,
            out="straight")
    run_cli(base + ["hyp.steps=1", "impl.checkpoint.name=resumed.ckpt"], tmp_path)
    run_cli(base + ["hyp.steps=2", "impl.checkpoint.name=resumed.ckpt"], tmp_path,
            out="resumed")
    writes = [e for e in events(tmp_path) if e[1] == "write"]
    assert [(rank, pathlib.Path(file).name) for rank, _, file in writes] == [
        (0, "straight.ckpt"), (0, "straight.ckpt"), (0, "resumed.ckpt"), (0, "resumed.ckpt")]
    straight, resumed = (torch.load(tmp_path / "checkpoints" / f"{name}.ckpt", weights_only=True)
                         for name in ("straight", "resumed"))
    assert straight["step"] == resumed["step"] == 2
    ours = {**straight["model"], **{f"momentum/{k}": v["momentum_buffer"]
                                    for k, v in straight["optimizer"]["state"].items()}}
    theirs = {**resumed["model"], **{f"momentum/{k}": v["momentum_buffer"]
                                     for k, v in resumed["optimizer"]["state"].items()}}
    assert ours.keys() == theirs.keys()
    assert [k for k in ours if not torch.equal(ours[k], theirs[k])] == []
    full, cut = read_table(tmp_path / "straight"), read_table(tmp_path / "resumed")
    assert {k: v[1:] for k, v in full.items() if k != "train_time"} == {
        k: v for k, v in cut.items() if k != "train_time"}


def test_temporary_bake_of_two_ranks(tmp_path):
    """A temporary store: rank 0 bakes it once under its own pid, rank 1
    finds it there after the barrier, and rank 0 removes it once at exit."""
    db = tmp_path / "db"
    run_cli(TINY + ["hyp=fb1", "dryrun=True", "data/db=baked", "data.db.rounds=2",
                    "data.augmentations_train=", f"data.db.path={db}",
                    "data.db.temporary_database=True"], tmp_path)
    log = events(tmp_path)
    bakes = [rank for rank, event, _ in log if event == "bake"]
    opened = {rank: pathlib.Path(path) for rank, event, path in log if event == "open"}
    cleaned = [(rank, pathlib.Path(path)) for rank, event, path in log if event == "cleanup"]
    assert bakes == [0]
    assert sorted(opened) == [0, 1] and opened[0] == opened[1]
    assert opened[0].parent == db and "_tmp" in opened[0].name
    assert cleaned == [(0, opened[0])]
    assert not opened[0].exists()


# ---------------------------------------------------------------------------
# each rank's rows against the JAX package's 2-device layout
# ---------------------------------------------------------------------------

BAKED = ["data/db=baked", "data.db.rounds=2"]
STAGING = {
    # a semi-stochastic step: one round of the store in the step's order
    "semi-stochastic": ["hyp=base_sgd", "hyp.train_semi_stochastic=True"] + BAKED,
    # a full-batch step over the flat store of both rounds, in order
    "baked-in-order": ["hyp=fb1"] + BAKED,
    "shuffled": ["hyp=fb1", "hyp.shuffle=True"],
}


@pytest.mark.parametrize("case", list(STAGING))
def test_rank_staging_matches_jax_stage_epoch(case, config_dir, tmp_path):
    """Rank ``r``'s staged rows of steps 0-2 are ``[:, r]`` of the JAX
    package's ``stage_epoch`` on a 2-device mesh, bitwise."""
    overrides = TINY + FB + ["data.augmentations_train=", "seed=3"] + STAGING[case]
    if BAKED[0] in overrides:
        overrides.append(f"data.db.path={tmp_path}")
    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, seed=3, device="cpu")
    trainers = [Trainer(_port_model(tcfg, tbundle), tbundle, tcfg, torch.device("cpu"),
                        World(rank, 2)) for rank in range(2)]
    layout = (trainers[0].num_blocks, trainers[0].chunks, trainers[0].sub)
    assert layout == (4 if case == "baked-in-order" else 2, 2, 8)
    cfg = jax_load_config(config_dir, overrides=overrides)
    bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp, seed=3)  # reuses the port's store
    mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:2]))
    fns = SimpleNamespace(layout=layout, num_devices=2, streamed=False)
    cache = {}
    for step in range(3):
        ref_images, ref_labels = (np.asarray(a) for a in
                                  jax_stage_epoch(bundle, fns, mesh, cfg, step, cache))
        for rank, trainer in enumerate(trainers):
            images, labels = trainer.stage(step)
            np.testing.assert_array_equal(images.numpy(), ref_images[:, rank].reshape(
                images.shape))
            np.testing.assert_array_equal(labels.numpy(), ref_labels[:, rank].reshape(
                labels.shape))


def test_rank_validation_matches_jax_stage_validation(config_dir):
    """Rank ``r``'s validation blocks and weights are ``[:, r]`` of the JAX
    package's padded 2-device grid: 12 images padded to 2 x 16, so rank 1
    holds padding only."""
    overrides = TINY + FB + ["hyp=fb1"]
    tcfg = load_config(config_dir, overrides=overrides)
    tbundle = construct_databundle(tcfg.data, tcfg.impl, tcfg.hyp, device="cpu")
    cfg = jax_load_config(config_dir, overrides=overrides)
    bundle = jax_databundle(cfg.data, cfg.impl, cfg.hyp)
    mesh = make_mesh(cfg.impl.setup, devices=np.asarray(jax.devices()[:2]))
    ref = [np.asarray(a) for a in jax_stage_validation(bundle, mesh, 2, 16)]
    for rank in range(2):
        ours = stage_validation(tbundle, 16, "cpu", world=World(rank, 2))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), b[:, rank])
    assert ours[2].sum().item() == 0 and len(ours[0]) == 1
