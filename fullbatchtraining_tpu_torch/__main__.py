"""``python -m fullbatchtraining_tpu_torch [overrides]``: train on the card.

The port's counterpart of ``train_with_gradient_descent.py``, with the same
Hydra-style overrides on the repository's ``config/`` tree, e.g.

    python -m fullbatchtraining_tpu_torch hyp=fb1 model=resnet18 impl.mixed_precision=True

It runs on CUDA unless ``+impl.device=cpu`` is given. With
``impl/setup=distributed`` it is one rank of a data-parallel job, one
process per card:

    torchrun --nproc_per_node=N -m fullbatchtraining_tpu_torch impl/setup=distributed ...

or, one command per rank, ``impl.setup.url=<host>:<port>
impl.setup.world_size=N impl.setup.rank=<r>``. Under torchrun each rank
takes ``cuda:<LOCAL_RANK>`` unless ``+impl.device`` names a device.

The other CLIs share its start (:func:`start_job`, :func:`build_run`):
``python -m fullbatchtraining_tpu_torch.crunch_loss_landscape``,
``.verify_model_checkpoint``, ``.measure_floating_point_accuracy`` and, for
upstream ``.pth`` files, ``.tools.import_reference_checkpoint`` and
``.tools.export_reference_checkpoint``. Each takes ``--multirun`` (or
``-m``): every override with top-level commas sweeps its choices, and the
jobs run one after another, job ``i`` in ``<hydra.sweep.dir>/<i>``:

    python -m fullbatchtraining_tpu_torch --multirun hyp=fb1,gradreg seed=0,1
"""

import logging
import os
import time
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"


def default_device(cfg) -> str:
    """``impl.device`` where given; else ``cuda:<LOCAL_RANK>`` under torchrun;
    else ``cuda``."""
    if cfg.impl.get("device"):
        return str(cfg.impl.device)
    if "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return "cuda"


def start_job(args, script_name: str, job_num=None, sweep_stamp=None):
    """``(cfg, device, world)`` of a CLI run, or of job ``job_num`` of a
    sweep started at ``sweep_stamp``, with the overrides ``args``: the
    config, the card (or ``+impl.device``), the process group of
    ``impl/setup=distributed`` and the run directory, which
    :func:`~.utils.job_startup` enters (``cfg.original_cwd`` is the
    directory the job started in)."""
    from .config import load_config
    from .parallel import setup_distributed, shutdown
    from .utils import job_startup, resolve_device

    cfg = load_config(CONFIG_DIR, overrides=args)
    device = resolve_device(default_device(cfg))
    world = setup_distributed(cfg.impl.setup, device)
    try:
        cfg = job_startup(cfg, script_name, world, job_num, sweep_stamp)
    except BaseException:
        shutdown(world)
        raise
    return cfg, device, world


def build_run(cfg, device, world):
    """``(bundle, model)`` of ``cfg``: the data and the model at its seeded
    initial weights."""
    from .data import construct_databundle
    from .models import construct_model

    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=cfg.dryrun, seed=cfg.seed,
                                  device=device, world=world)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                            pixels=bundle.pixels)
    return bundle, model


def main(overrides=None):
    """A training run of ``overrides`` (the command line by default), or
    the runs of its ``--multirun`` sweep."""
    from .utils import hydra_main

    return hydra_main(train_job, overrides)


def train_job(overrides, job_num=None, sweep_stamp=None):
    from .config import to_yaml
    from .parallel import barrier, shutdown
    from .training import train
    from .utils import save_summary

    cfg, device, world = start_job(overrides, "train_with_gradient_descent", job_num,
                                   sweep_stamp)
    try:
        log = logging.getLogger("train")
        log.info("--------------------------------------------------\n%s", to_yaml(cfg))
        log.info("Config name: %s, seed: %s, dryrun: %s, device: %s, rank %d of %d",
                 cfg.name, cfg.seed, cfg.dryrun, device, world.rank, world.size)

        start = time.time()
        bundle, model = build_run(cfg, device, world)
        _, stats = train(model, bundle, cfg, device=device, world=world)
        elapsed = time.time() - start

        save_summary(cfg, stats, elapsed)
        log.info("Total training time: %.1fs. Job finished. ", elapsed)
        if stats.get("valid_acc"):
            log.info("Final validation accuracy: %.2f%%", 100 * stats["valid_acc"][-1])
        barrier(world)  # every rank is done with the files the ranks share
        return stats
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
