"""Run directory, logging, seeding, ``--multirun`` sweeps and summary tables
(``fullbatchtraining_tpu/utils.py``: job_startup, hydra_main, save_summary,
save_to_table).
"""

from __future__ import annotations

import csv
import datetime
import logging
import os
import random
import re
import sys
from pathlib import Path

import numpy as np
import torch

from .parallel import World, broadcast

log = logging.getLogger(__name__)

_NOW_PATTERN = re.compile(r"\$\{now:([^}]*)\}")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; asking for CUDA without a card raises instead
    of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' (CLI: +impl.device=cpu) to run on the CPU")
    return device


_EPOCH = datetime.datetime(1970, 1, 1)


def _shared_stamp(world: World, stamp: datetime.datetime) -> datetime.datetime:
    """Rank 0's naive ``stamp``, on every rank, to the microsecond."""
    us = broadcast(world, (stamp - _EPOCH) // datetime.timedelta(microseconds=1))
    return _EPOCH + datetime.timedelta(microseconds=us)


def job_startup(cfg, script_name: str = "job", world: World | None = None, job_num=None,
                sweep_stamp=None):
    """Finalize the config, create and enter the run directory, log to
    stdout and a file, seed. A single run's directory is
    ``<base_dir>/<date>/<time>`` (Hydra's run dir, or ``hydra.run.dir``);
    job ``job_num`` of a ``--multirun`` sweep started at ``sweep_stamp``
    takes ``<sweep dir>/<job_num>`` (``hydra.sweep.dir``, the same pattern
    at the sweep's time). Ranks other than 0 append ``_rank<r>``. An unset
    ``seed`` is drawn from the system's entropy; with several ranks in
    ``world``, rank 0's seed and sweep stamp win on every rank, through one
    broadcast each."""
    world = world if world is not None else World()
    cfg.original_cwd = os.getcwd()
    if cfg.seed is None:
        cfg.seed = random.SystemRandom().randint(0, 2**31 - 1)
    if world.size > 1:
        cfg.seed = broadcast(world, int(cfg.seed))
    hydra = cfg.pop("_hydra", {})
    now = sweep_stamp or datetime.datetime.now()
    if job_num is not None and world.size > 1:
        now = _shared_stamp(world, now)
    dir_key = "run.dir" if job_num is None else "sweep.dir"
    if hydra.get(dir_key) is not None:
        run_dir = Path(_NOW_PATTERN.sub(lambda m: now.strftime(m.group(1)), str(hydra[dir_key])))
    else:
        run_dir = Path(cfg.base_dir) / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S.%f")
    if job_num is not None:
        run_dir = run_dir / str(job_num)
    if world.rank:
        run_dir = run_dir.with_name(f"{run_dir.name}_rank{world.rank}")
    run_dir = run_dir.resolve()  # the log path must survive the chdir below
    run_dir.mkdir(parents=True, exist_ok=True)
    if hydra.get("job.chdir", True):
        os.chdir(run_dir)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(run_dir / f"{script_name}.log")],
        force=True,
    )
    np.random.seed(cfg.seed % 2**32)
    random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    return cfg


def hydra_main(job, argv=None):
    """A CLI's entry, as ``@hydra.main`` with the basic launcher: one run
    of ``job(overrides)``, or under ``--multirun``/``-m`` the jobs of
    :func:`~.config.expand_multirun` in order, ``job(overrides,
    job_num=i, sweep_stamp=t)`` with one stamp for the sweep, each from the
    directory the sweep started in. A failing job ends the sweep. Returns
    the run's result, or the list of the jobs' results."""
    from .config import expand_multirun

    is_multi, jobs = expand_multirun(sys.argv[1:] if argv is None else argv)
    if not is_multi:
        return job(jobs[0])
    launch_cwd = os.getcwd()
    sweep_stamp = datetime.datetime.now()
    results = []
    for i, overrides in enumerate(jobs):
        print(f"[multirun] launching job #{i} : {' '.join(overrides)}", flush=True)
        os.chdir(launch_cwd)
        try:
            results.append(job(overrides, job_num=i, sweep_stamp=sweep_stamp))
        finally:
            os.chdir(launch_cwd)
    return results


def is_main_process() -> bool:
    """Rank 0 of a torch.distributed job, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_summary(cfg, stats, local_time: float):
    """Per-step convergence table + one appended run row in
    ``tables/table_fb_<dataset>_runs.csv`` (tab-separated), the JAX package's
    columns."""
    if not is_main_process():
        return
    num_steps = len(stats.get("train_loss", []))
    for step in range(num_steps):
        iteration = {key: values[step] if step < len(values) else None
                     for key, values in stats.items()}
        save_to_table(".", f"{cfg.name}_convergence_results", dryrun=cfg.dryrun, **iteration)

    def maybe(key):
        return stats[key][-1] if stats.get(key) else ""

    max_val_acc = max(stats["valid_acc"]) if stats.get("valid_acc") else ""
    try:
        # skip warmup, find the validation block with minimal full training
        # loss and report validation accuracy there
        warmup = cfg.hyp.warmup
        every = cfg.impl.validate_every_nth_step
        blocks = np.array(stats["full_loss"][warmup:], dtype=np.float64)
        blocks = blocks[: len(blocks) - len(blocks) % every].reshape(-1, every)
        best = blocks.mean(-1).argmin() + warmup // every
        acc_at_min_loss = stats["valid_acc"][best]
    except (ValueError, IndexError, KeyError):
        acc_at_min_loss = ""

    summary = dict(
        name=cfg.name,
        model=cfg.model.name,
        optimizer=cfg.hyp.optim.name,
        stoch=cfg.hyp.train_stochastic,
        augmentations=bool(cfg.data.augmentations_train),
        valid_acc=maybe("valid_acc"),
        valid_acc_at_min_loss=acc_at_min_loss,
        max_val_acc=max_val_acc,
        train_acc=maybe("train_acc"),
        valid_loss=maybe("valid_loss"),
        train_loss=maybe("train_loss"),
        full_loss=maybe("full_loss"),
        grad_norm=maybe("grad_norm"),
        avg_step_time=float(np.median(np.asarray(stats["train_time"], dtype=np.float64)))
        if stats.get("train_time") else "",
        total_time=str(datetime.timedelta(seconds=int(local_time))).replace(",", ""),
        param_norm=maybe("param_norm"),
        batch_size=cfg.data.batch_size,
        **_flatten(dict(cfg.hyp)),
        **_flatten({k: v for k, v in cfg.impl.items() if k != "setup"}),
        seed=cfg.seed,
        folder=os.getcwd(),
    )
    save_to_table(os.path.join(cfg.original_cwd, "tables"),
                  f"fb_{cfg.data.name}_runs", dryrun=cfg.dryrun, **summary)


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}."))
        else:
            out[key] = v
    return out


def save_to_table(out_dir, table_name, dryrun, **kwargs):
    """Append a row to a tab-separated .csv, writing the header on first use;
    rows go under an existing file's header (missing columns empty, new
    columns dropped with a warning)."""
    if dryrun:
        return
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"table_{table_name}.csv")
    fieldnames = list(kwargs.keys())
    existing = None
    if os.path.exists(fname):
        with open(fname, newline="") as handle:
            existing = next(csv.reader(handle, delimiter="\t"), None)
    if not existing:
        with open(fname, "w", newline="") as handle:
            csv.DictWriter(handle, delimiter="\t", fieldnames=fieldnames).writeheader()
    elif existing != fieldnames:
        dropped = [k for k in fieldnames if k not in existing]
        if dropped:
            log.warning("Summary table %s: dropping columns not in the existing header: %s",
                        fname, dropped)
        fieldnames = existing
    with open(fname, "a", newline="") as handle:
        csv.DictWriter(handle, delimiter="\t", fieldnames=fieldnames,
                       extrasaction="ignore", restval="").writerow(kwargs)
