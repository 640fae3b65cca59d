"""``python -m fullbatchtraining_tpu_torch.tools.import_reference_checkpoint
+in=<file.pth> impl.checkpoint.name=<name> [overrides]``: an upstream
``.pth`` 5-tuple as the port's checkpoint ``checkpoints/<name>``, so

    python -m fullbatchtraining_tpu_torch impl.checkpoint.name=<name> ...

continues the upstream run. The weights and running stats import for every
family, the SGD momentum for plain-SGD ResNets
(:func:`~..pretrained.import_reference_training_checkpoint`); the model and
hyp groups must be the run's. Paths are taken from the directory the
command starts in. It runs on CUDA unless ``+impl.device=cpu`` is given.
"""

import copy
import logging
from pathlib import Path


def main(overrides=None):
    """The import of ``overrides`` (the command line by default), or one job
    after another of its ``--multirun`` sweep."""
    from ..utils import hydra_main

    return hydra_main(_job, overrides)


def _job(overrides, job_num=None, sweep_stamp=None):
    from ..__main__ import build_run, start_job
    from ..parallel import shutdown
    from ..pretrained import import_reference_training_checkpoint
    from ..training.optimizers import optim_interface
    from ..training.training import TrainState, _DTYPES, place_model
    from ..training.utils import state_payload, write_checkpoint

    cfg, device, world = start_job(overrides, "import_reference_checkpoint", job_num,
                                   sweep_stamp)
    try:
        if cfg.get("in") is None:
            raise SystemExit("Set +in=<file.pth> to choose the upstream checkpoint.")
        if cfg.impl.checkpoint.name is None:
            raise SystemExit("Set impl.checkpoint.name=<file> to name the imported checkpoint.")
        source = Path(cfg.original_cwd) / str(cfg.get("in"))
        target = Path(cfg.original_cwd) / "checkpoints" / str(cfg.impl.checkpoint.name)
        _, model = build_run(cfg, device, world)
        place_model(model, device, _DTYPES[cfg.impl.dtype])
        optimizer, _ = optim_interface(model, cfg.hyp)
        ema = None
        if cfg.hyp.evaluate_ema:
            ema = copy.deepcopy(model)
        state = TrainState(step=0, model=model, optimizer=optimizer, ema_model=ema)
        state, step = import_reference_training_checkpoint(source, cfg, state)
        target.parent.mkdir(parents=True, exist_ok=True)
        write_checkpoint(state_payload(state), target)
        logging.getLogger("import").info("Imported %s step %d -> %s", source.name, step, target)
        return target
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
