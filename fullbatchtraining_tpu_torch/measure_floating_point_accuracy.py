"""``python -m fullbatchtraining_tpu_torch.measure_floating_point_accuracy [overrides]``:
how far two evaluations of the full-batch gradient from one state differ
(the repository's ``measure_floating_point_accuracy.py``), e.g.

    python -m fullbatchtraining_tpu_torch.measure_floating_point_accuracy hyp=fb1 data.size=512

Both passes are :meth:`~.training.training.Trainer.pre_step_gradient` at
step 0 of the seeded model: each starts from the same running stats and
draws the same augmentations. The six deviations are the absolute and
relative L-inf, L2 and L1 norms of their difference. On cuDNN the
difference is what ``impl.deterministic`` and the algorithms chosen make
it, a measurement, not a promise of zero. It runs on CUDA unless
``+impl.device=cpu`` is given.
"""

import logging
import sys

import numpy as np

log = logging.getLogger("fp_audit")


def measure_implementation_noise(cfg, device, world=None, bundle=None) -> dict:
    """The six deviations between two full-batch gradients of ``cfg``'s
    model at step 0 (on ``bundle`` where given)."""
    from .__main__ import build_run
    from .models import construct_model
    from .parallel import current_world
    from .utils import resolve_device
    from .training.training import Trainer, TrainState, configure_backends

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
    images, labels = trainer.stage(0)
    grads_a = trainer.pre_step_gradient(state, images, labels)
    grads_b = trainer.pre_step_gradient(state, images, labels)

    flat_a = np.concatenate([g.detach().cpu().numpy().ravel() for g in grads_a])
    flat_b = np.concatenate([g.detach().cpu().numpy().ravel() for g in grads_b])
    diff = np.abs(flat_a - flat_b)
    denom = np.abs(flat_a) + 1e-12
    results = {
        "abs_linf": float(diff.max()),
        "abs_l2": float(np.linalg.norm(diff)),
        "abs_l1": float(diff.sum()),
        "rel_linf": float((diff / denom).max()),
        "rel_l2": float(np.linalg.norm(diff) / np.linalg.norm(flat_a)),
        "rel_l1": float(diff.sum() / np.abs(flat_a).sum()),
    }
    for key, value in results.items():
        log.info("%s: %.3e", key, value)
    if results["abs_linf"] == 0.0:
        log.info("Gradient computation is bitwise reproducible on this platform.")
    return results


def main(overrides=None):
    from .__main__ import start_job
    from .parallel import shutdown

    cfg, device, world = start_job(sys.argv[1:] if overrides is None else overrides,
                                   "measure_floating_point_accuracy")
    try:
        return measure_implementation_noise(cfg, device, world)
    finally:
        shutdown(world)


if __name__ == "__main__":
    main()
