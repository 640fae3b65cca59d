"""``python -m fullbatchtraining_tpu_torch [overrides]``: train on the card.

The port's counterpart of ``train_with_gradient_descent.py``, with the same
Hydra-style overrides on the repository's ``config/`` tree, e.g.

    python -m fullbatchtraining_tpu_torch hyp=fb1 model=resnet18 impl.mixed_precision=True

It runs on CUDA unless ``+impl.device=cpu`` is given.
"""

import logging
import sys
import time
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"


def main(overrides=None):
    from .config import load_config, to_yaml
    from .data import construct_databundle
    from .models import construct_model
    from .training import train
    from .utils import job_startup, save_summary

    args = sys.argv[1:] if overrides is None else overrides
    if any(a in ("--multirun", "-m") for a in args):
        raise NotImplementedError("--multirun is not ported yet (ROADMAP.md, 'Multirun sweeps')")
    cfg = load_config(CONFIG_DIR, overrides=args)
    cfg = job_startup(cfg, "train_with_gradient_descent")
    log = logging.getLogger("train")
    log.info("--------------------------------------------------\n%s", to_yaml(cfg))
    device = cfg.impl.get("device", "cuda")
    log.info("Config name: %s, seed: %s, dryrun: %s, device: %s",
             cfg.name, cfg.seed, cfg.dryrun, device)

    start = time.time()
    bundle = construct_databundle(cfg.data, cfg.impl, cfg.hyp, dryrun=cfg.dryrun, seed=cfg.seed,
                                  device=device)
    model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed)
    _, stats = train(model, bundle, cfg, device=device)
    elapsed = time.time() - start

    save_summary(cfg, stats, elapsed)
    log.info("Total training time: %.1fs. Job finished. ", elapsed)
    if stats.get("valid_acc"):
        log.info("Final validation accuracy: %.2f%%", 100 * stats["valid_acc"][-1])
    return stats


if __name__ == "__main__":
    main()
