"""``python -m fullbatchtraining_tpu_torch.crunch_loss_landscape [overrides]``:
the loss surface around a checkpoint (the repository's
``crunch_loss_landscape.py``), e.g.

    python -m fullbatchtraining_tpu_torch.crunch_loss_landscape impl.checkpoint.name=fb.ckpt viz=1d

It loads the port's checkpoint ``checkpoints/<impl.checkpoint.name>`` of the
directory it starts in, or, without a name, takes the seeded initial
weights and names the store after ``name``, and crunches
(:func:`~.visualization.crunch`) into
``checkpoints/<name>_<viz.ignore_layers>_<viz.norm>_losses``. It runs on
CUDA unless ``+impl.device=cpu`` is given; ``impl/setup=distributed``
splits each group's pass across ranks.
"""

import logging
import sys
from pathlib import Path


def main(overrides=None):
    from .__main__ import build_run, start_job
    from .parallel import barrier, shutdown
    from .training.training import Trainer, TrainState, configure_backends
    from .training.utils import load_checkpoint
    from .visualization import crunch

    cfg, device, world = start_job(sys.argv[1:] if overrides is None else overrides,
                                   "crunch_loss_landscape")
    try:
        log = logging.getLogger("crunch")
        bundle, model = build_run(cfg, device, world)
        configure_backends(cfg)
        trainer = Trainer(model, bundle, cfg, device, world)
        state = TrainState(step=0, model=model, optimizer=None)
        if cfg.impl.checkpoint.name is not None:
            file = Path(cfg.original_cwd) / "checkpoints" / str(cfg.impl.checkpoint.name)
            step = load_checkpoint(state, file, float("inf"), require=True)
            log.info("Loaded model checkpoint from step %d successfully.", step)
        else:
            cfg.impl.checkpoint.name = cfg.name
            log.info("No checkpoint supplied! Loss landscape will be computed for the model "
                     "initialization without training.")
        store, positions = crunch(trainer, state)
        log.info("Surface complete: %d positions in %s", len(positions), store.results_file)
        barrier(world)
        return store, positions
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
