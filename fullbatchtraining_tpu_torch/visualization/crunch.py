"""The loss surface around a state (``fullbatchtraining_tpu/visualization/crunch.py``).

The surface is the mean training loss, accuracy and full loss at the grid
positions ``params + x*dx + y*dy`` of ``viz.coordinates`` (``linspace`` in
x and y), ``dx`` and ``dy`` two random directions (``viz.norm``, the
``viz.ignore_layers`` rule) drawn from a generator seeded with ``seed``.
The directions and the base state live in the store
(:mod:`.database`), the results go there row by row, so a job that stops
resumes, and jobs that share a store split the grid by claims.

Positions go in groups of ``viz.vmap_positions``; each group costs one pass
over the unshuffled, unaugmented train split, laid out in blocks of
``data.batch_size`` (:meth:`~..training.training.Trainer.sweep_rows`;
above ``impl.hbm_epoch_max_bytes`` streamed from the host in segments).
Within a segment every position of the group runs over the segment's
blocks with its params swapped in once. A block is one eval-mode forward
(BatchNorm from the running stats through ``ops.bn.BNEval``) in the
training forward's compute dtype (bf16 autocast under
``impl.mixed_precision``, else the params' dtype), its loss in at least
float32; with ``viz.compute_full_loss`` and ``hyp.grad_reg.block_strength``
also the squared norm of the block's gradient with respect to the params.
The sums of loss, correct predictions and squared norms are a ``[3, G]``
float32 carry added block by block in dataset order, as the JAX package's
scan carry, so a streamed surface is the resident one bit for bit; one
``all_reduce`` of it a group joins the ranks.

``full_loss = train_loss + weight_decay/2 * ||p||^2`` (plus ``lr/4 *
block_strength`` times the mean squared block gradient norm, ``lr`` the
schedule's at the state's step). Under ``impl/setup=distributed`` rank 0
draws the directions and creates the store, and rank 0's view of which
positions are pending is every rank's; rank 0 alone claims and records.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..analysis import directions
from ..parallel import all_reduce, barrier, broadcast_flags
from ..training.grad_reg import tree_sqnorm
from .database import SurfaceStore, surface_path

log = logging.getLogger(__name__)


def _agreed(world, positions, pending) -> list:
    """The entries of ``positions`` that rank 0 sees in ``pending``."""
    pending = set(map(tuple, pending))
    flags = broadcast_flags(world, [tuple(p) in pending for p in positions])
    return [p for p, keep in zip(positions, flags) if keep]


def surface_sums(trainer, model, offsets, images, labels, compute_grads: bool) -> torch.Tensor:
    """``[3, G]`` float32 sums over this rank's rows (``images``,
    ``labels`` as :meth:`~..training.training.Trainer.sweep_rows` gives
    them, a block a row) of each block's loss, correct predictions and
    squared gradient norm (0 without ``compute_grads``), at each of the
    ``G`` parameter lists ``offsets``."""
    sums = torch.zeros((3, len(offsets)), dtype=torch.float32, device=trainer.device)
    zero = torch.zeros((), dtype=torch.float32, device=trainer.device)
    model.eval()
    try:
        for _, seg_images, seg_labels in trainer.segments(images, labels):
            for g, values in enumerate(offsets):
                with trainer.params_at(values):
                    for row in range(len(seg_images)):
                        lbls = seg_labels[row]
                        with torch.set_grad_enabled(compute_grads):
                            logits = trainer.forward(model, trainer._normalize(seg_images[row]))
                            loss = trainer.criterion(logits, lbls)
                        sq_norm = (tree_sqnorm(torch.autograd.grad(loss, trainer.params))
                                   if compute_grads else zero)
                        correct = (logits.argmax(-1) == lbls).to(torch.float32).sum()
                        sums[:, g] += torch.stack([loss.detach().to(torch.float32), correct,
                                                   sq_norm.to(torch.float32)])
    finally:
        model.train()
    return sums


def crunch(trainer, state):
    """Evaluate the surface around ``state``'s params into its store;
    returns ``(store, positions)``. ``trainer`` is the run's
    :class:`~..training.training.Trainer`, its model ``state.model``."""
    cfg = trainer.cfg
    viz, hyp, world = cfg.viz, cfg.hyp, trainer.world
    params = [p.detach().clone() for p in trainer.params]
    compute_grads = bool(viz.compute_full_loss) and hyp.grad_reg.block_strength != 0
    if viz.compute_full_loss and hyp.grad_reg.acc_strength != 0:
        raise ValueError("Loss landscape does not contain acc_strength!")

    store = SurfaceStore(surface_path(cfg.impl, viz, cfg.get("original_cwd", ".")))
    lead = world.rank == 0
    if viz.rebuild_existing_database and lead:
        store.remove()
    barrier(world)
    store.refuse_foreign()
    if lead and not store.exists():
        seed = int(cfg.seed) if cfg.seed is not None else 0
        generator = torch.Generator(device=trainer.device).manual_seed(seed)
        dx = directions.create_random_direction(params, generator, norm=viz.norm,
                                                ignore=viz.ignore_layers)
        dy = directions.create_random_direction(params, generator, norm=viz.norm,
                                                ignore=viz.ignore_layers)
        store.create(params, dx, dy)
        log.info("Created new surface database at %s.", store.path)
    barrier(world)   # the other ranks read rank 0's directions from the store
    loaded = store.verify_model(params)
    if loaded is None:
        raise ValueError(f"The stored surface at {store.path} belongs to a different model "
                         "state.")
    dx, dy = ([d.to(trainer.device) for d in tensors] for tensors in loaded[1:])

    c = viz.coordinates
    xcoords = np.linspace(c.x.min, c.x.max, c.x.num)
    ycoords = np.linspace(c.y.min, c.y.max, c.y.num)
    positions = [(float(x), float(y)) for x in xcoords for y in ycoords]
    ttl = float(viz.get("claim_ttl", 3600.0))
    todo = _agreed(world, positions, store.pending(positions, ttl=ttl))
    log.info("Crunching %d of %d positions (%d cached/claimed).", len(todo), len(positions),
             len(positions) - len(todo))
    if not todo:
        _report_completion(store, positions)
        return store, positions

    num_blocks, chunks, sub, images, labels = trainer.sweep_rows(trainer.bundle.batch_size,
                                                                 "Surface epoch")
    lr = float(trainer.schedule(state.step))
    group = max(int(viz.get("vmap_positions", 8)), 1)
    datapoints = num_blocks * chunks * sub * world.size
    for start in range(0, len(todo), group):
        # a cooperating job may have claimed or finished some since the
        # first read; rank 0's view wins
        batch = todo[start:start + group]
        batch = _agreed(world, batch, store.pending(batch, ttl=ttl))
        if not batch:
            continue
        if lead:
            store.claim(batch)
        t0 = time.time()
        offsets = [directions.set_parameter_offset(params, dx, x, dy, y) for x, y in batch]
        sums = all_reduce(world, surface_sums(trainer, state.model, offsets, images, labels,
                                              compute_grads))
        package = sums.cpu().tolist()
        for idx, position in enumerate(batch):
            loss_sum, correct_sum, gn_sum = (package[k][idx] for k in range(3))
            train_loss = loss_sum / num_blocks / world.size
            train_acc = correct_sum / datapoints
            full_loss = train_loss + 0.5 * trainer.weight_decay * float(tree_sqnorm(offsets[idx]))
            if compute_grads:
                # the mean over the blocks of their squared gradient norms
                full_loss += (lr / 4 * hyp.grad_reg.block_strength
                              * gn_sum / num_blocks / world.size)
            if lead:
                store.record(position, train_loss=train_loss, train_acc=train_acc,
                             full_loss=full_loss)
            log.info(status_message(train_loss, train_acc, full_loss,
                                    (time.time() - t0) / len(batch), position))
        if cfg.dryrun:
            break
    _report_completion(store, positions)
    return store, positions


def _report_completion(store, positions) -> None:
    results = store.results()
    computed = sum(1 for p in positions
                   if (row := results.get(store._key(p))) and not row.get("claim"))
    if computed < len(positions):
        log.warning("Surface has %d/%d computed positions; %d are claimed by other jobs or "
                    "missing (set viz.claim_ttl=0 to retake).", computed, len(positions),
                    len(positions) - computed)
    else:
        log.info("Surface complete: all %d positions computed.", len(positions))


def status_message(train_loss, train_acc, full_loss, time_stamp, position) -> str:
    msg = f"Pos: [{position[0]:4.2f}, {position[1]:4.2f}] | Time: {time_stamp:4.2f}s |"
    msg += f"TRAIN loss {train_loss:7.4f} | TRAIN Acc: {train_acc:7.2%} |"
    msg += f"Full loss {full_loss:7.4f} |"
    return msg
