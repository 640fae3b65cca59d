"""``python -m fullbatchtraining_tpu_torch.verify_model_checkpoint impl.checkpoint.name=<file>
[overrides]``: the validation loss and accuracy of a checkpoint (the
repository's ``verify_model_checkpoint.py``).

It loads ``checkpoints/<impl.checkpoint.name>`` of the directory it starts
in (the model's params and running stats; the model, data and hyp groups
must be those of the run that wrote it) and evaluates it as the training
loop does. It runs on CUDA unless ``+impl.device=cpu`` is given.
"""

import logging
import sys
from pathlib import Path

log = logging.getLogger("verify")


def verify_checkpoint(cfg, file, device, world=None, bundle=None) -> dict:
    """``{"valid_loss", "valid_acc"}`` of the checkpoint ``file`` under
    ``cfg`` (its data ``bundle`` where given), logged with its step."""
    from .__main__ import build_run
    from .models import construct_model
    from .parallel import current_world
    from .utils import resolve_device
    from .training.training import (Trainer, TrainState, _to_host, configure_backends,
                                    stage_validation)
    from .training.utils import load_checkpoint

    device = resolve_device(device)
    world = world if world is not None else current_world()
    if bundle is None:
        bundle, model = build_run(cfg, device, world)
    else:
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                                pixels=bundle.pixels)
    configure_backends(cfg)
    trainer = Trainer(model, bundle, cfg, device, world)
    state = TrainState(step=0, model=model, optimizer=None)
    step = load_checkpoint(state, file, float("inf"), require=True)
    val = stage_validation(bundle, bundle.batch_size, device, dryrun=cfg.dryrun, world=world,
                           cfg_impl=cfg.impl)
    metrics = _to_host(trainer.eval_step(state.model, *val))
    log.info("Checkpoint step %d: valid_loss %.4f, valid_acc %.2f%%", step,
             metrics["valid_loss"], 100 * metrics["valid_acc"])
    return metrics


def main(overrides=None):
    from .__main__ import start_job
    from .parallel import shutdown

    cfg, device, world = start_job(sys.argv[1:] if overrides is None else overrides,
                                   "verify_model_checkpoint")
    try:
        if cfg.impl.checkpoint.name is None:
            raise SystemExit("Set impl.checkpoint.name=<file> to choose a checkpoint.")
        file = Path(cfg.original_cwd) / "checkpoints" / str(cfg.impl.checkpoint.name)
        return verify_checkpoint(cfg, file, device, world)
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
