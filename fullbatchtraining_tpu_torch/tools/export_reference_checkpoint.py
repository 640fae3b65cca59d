"""``python -m fullbatchtraining_tpu_torch.tools.export_reference_checkpoint
impl.checkpoint.name=<name> +out=<file.pth> [+ema=True] [overrides]``: the
port's checkpoint ``checkpoints/<name>`` as the upstream ``.pth`` 5-tuple
(:func:`~..pretrained.export_reference_training_checkpoint`: the weights,
and for plain-SGD ResNets the momentum and scheduler state). ``+ema=True``
exports the EMA weights alone. The model, data and hyp groups must be the
run's. Paths are taken from the directory the command starts in. It runs
on CUDA unless ``+impl.device=cpu`` is given.
"""

import copy
import logging
import sys
from pathlib import Path

import torch


def main(overrides=None):
    from ..__main__ import build_run, start_job
    from ..parallel import shutdown
    from ..pretrained import export_reference_training_checkpoint, save_reference_checkpoint
    from ..training.optimizers import optim_interface
    from ..training.training import TrainState, _DTYPES
    from ..training.utils import load_checkpoint

    cfg, device, world = start_job(sys.argv[1:] if overrides is None else overrides,
                                   "export_reference_checkpoint")
    try:
        if cfg.impl.checkpoint.name is None:
            raise SystemExit("Set impl.checkpoint.name=<file> to choose a checkpoint.")
        if cfg.get("out") is None:
            raise SystemExit("Set +out=<file.pth> to choose the export target.")
        source = Path(cfg.original_cwd) / "checkpoints" / str(cfg.impl.checkpoint.name)
        target = Path(cfg.original_cwd) / str(cfg.get("out"))
        _, model = build_run(cfg, device, world)
        model.to(device=device, dtype=_DTYPES[cfg.impl.dtype])
        optimizer, _ = optim_interface(model, cfg.hyp)
        use_ema = bool(cfg.get("ema", False))
        ema = None
        if use_ema:
            if torch.load(source, map_location="cpu", weights_only=True).get("ema_model") is None:
                raise SystemExit("+ema=True but the checkpoint holds no EMA weights "
                                 "(hyp.evaluate_ema was off).")
            ema = copy.deepcopy(model)
        state = TrainState(step=0, model=model, optimizer=optimizer, ema_model=ema)
        step = load_checkpoint(state, source, float("inf"), require=True)
        if use_ema:
            # the EMA weights never pair with the live optimizer state
            file = save_reference_checkpoint(state.ema_model, target, cfg.model, step=step)
        else:
            file = export_reference_training_checkpoint(state, cfg, target)
        logging.getLogger("export").info("Exported %s step %d -> %s%s", source.name, step, file,
                                         " (EMA weights)" if use_ema else "")
        return file
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
