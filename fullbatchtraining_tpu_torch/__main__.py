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
"""

import logging
import os
import sys
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


def main(overrides=None):
    from .config import load_config, to_yaml
    from .data import construct_databundle
    from .models import construct_model
    from .parallel import barrier, setup_distributed, shutdown
    from .training import train
    from .utils import job_startup, resolve_device, save_summary

    args = sys.argv[1:] if overrides is None else overrides
    if any(a in ("--multirun", "-m") for a in args):
        raise NotImplementedError("--multirun is not ported yet (ROADMAP.md, 'Multirun sweeps')")
    cfg = load_config(CONFIG_DIR, overrides=args)
    device = resolve_device(default_device(cfg))
    world = setup_distributed(cfg.impl.setup, device)
    try:
        cfg = job_startup(cfg, "train_with_gradient_descent", world)
        log = logging.getLogger("train")
        log.info("--------------------------------------------------\n%s", to_yaml(cfg))
        log.info("Config name: %s, seed: %s, dryrun: %s, device: %s, rank %d of %d",
                 cfg.name, cfg.seed, cfg.dryrun, device, world.rank, world.size)

        start = time.time()
        bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=cfg.dryrun,
                                      seed=cfg.seed, device=device, world=world)
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                                pixels=bundle.pixels)
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
