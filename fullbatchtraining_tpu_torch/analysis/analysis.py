"""Statistics of the model's state (``fullbatchtraining_tpu/analysis/analysis.py``):
parameter and gradient norms, momentum alignment, per-batch gradient norms,
gradient SNR, McCandlish's noise scale and empirical flatness.

The per-chunk sweep runs over the unshuffled, unaugmented train split laid
out ``(blocks, ranks, chunks, sub)`` with ``sub = data.batch_size //
analysis.internal_batch_size_chunks``: on each of this rank's chunks, an
eval-mode forward (BatchNorm from its running stats through
``ops.bn.BNEval``, in ``promote(param dtype, float32)``, no autocast), the
loss over this rank's ``num_blocks``, its gradient flattened, one Welford
update, and the chunk's gradient norm kept on the device. Above
``impl.hbm_epoch_max_bytes`` the rows stream from the host in segments,
the Welford state carried from one to the next, so the streamed sweep is
the resident one bit for bit. Across ranks one ``all_gather`` brings every
rank's state and norms, and each rank merges the states in rank order, so
all hold the same statistics.
"""

from __future__ import annotations

import logging

import torch

from ..data.augmentations import normalize as normalize_images
from ..parallel import all_gather
from ..training.grad_reg import tree_sqnorm
from ..training.opt.adaptive_clipping import AdaptiveClippedSGD
from ..training.opt.lars import LARS
from ..training.training import stage_validation
from .directions import perturb2threshold
from .welford import WelfordState, welford_finalize, welford_init, welford_merge, welford_update

log = logging.getLogger(__name__)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def grad_norm(grads, norm_type) -> float:
    """The ``norm_type`` norm of the per-tensor ``norm_type`` norms (the
    largest magnitude for ``inf``)."""
    if norm_type == "inf" or norm_type == float("inf"):
        return max(float(g.abs().max()) for g in grads)
    p = float(norm_type)
    norms = torch.stack([torch.linalg.vector_norm(g, ord=p) for g in grads])
    return float(torch.linalg.vector_norm(norms, ord=p))


def sgd_momentum(optimizer, params):
    """The momentum buffers of an SGD-type optimizer (SGD, GD-AGC, either
    under LARS/LARC), zeros before its first update: what the JAX package
    keeps in an ``SGDState``. None for the others."""
    if isinstance(optimizer, LARS):
        optimizer = optimizer.inner
    if not isinstance(optimizer, torch.optim.SGD) or isinstance(optimizer, AdaptiveClippedSGD):
        return None
    bufs = [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
    return [torch.zeros_like(p) if b is None else b for p, b in zip(params, bufs)]


def analyze(trainer, state, stats, grads=None):
    """Append this step's ``analysis_*`` entries to ``stats``.

    ``grads`` is the gradient that produced the step (the training loop
    takes it before the step); without it the gradient is evaluated at the
    current params, leaving the running stats as they are."""
    cfg = trainer.cfg
    a = cfg.analysis
    params = [p.detach() for p in trainer.params]

    if a.measure_param_norm:
        stats["analysis_param_norm"] += [float(torch.sqrt(tree_sqnorm(params)))]

    if (a.measure_grad_norm or a.check_momentum) and grads is None:
        grads = trainer.pre_step_gradient(state, *trainer.stage(state.step))

    if a.measure_grad_norm:
        stats["analysis_grad_norm"] += [grad_norm(grads, cfg.hyp.grad_clip_norm)]

    if a.check_momentum and cfg.hyp.optim.get("momentum", 0):
        momentum = sgd_momentum(state.optimizer, trainer.params)
        if momentum is not None:
            g, m = _flat(grads), _flat(momentum).to(grads[0].dtype)
            stats["analysis_momentum_dist"] += [float(torch.linalg.vector_norm(g - m))]
            stats["analysis_momentum_sim"] += [float(
                torch.dot(g, m)
                / (torch.linalg.vector_norm(g) * torch.linalg.vector_norm(m) + 1e-12))]

    if a.compute_gradient_SNR or a.compute_gradient_noise_scale or a.record_gradient_norm_per_batch:
        wf, norms, sub = gradient_sweep(trainer, state.model)
        grad_mean, _, grad_std, _, squared_norm = welford_finalize(wf)

        if a.record_gradient_norm_per_batch:
            for i, entry in enumerate(norms.tolist()):
                stats[f"analysis_grad_norm_{i}"] += [entry]

        if a.compute_gradient_SNR:
            stats["analysis_grad_mean_mean"] += [float(grad_mean.mean())]
            stats["analysis_grad_mean_norm"] += [float(torch.linalg.vector_norm(grad_mean))]
            stats["analysis_grad_std_mean"] += [float(grad_std.mean())]
            stats["analysis_grad_std_norm"] += [float(torch.linalg.vector_norm(grad_std))]
            snr = stats["analysis_grad_mean_norm"][-1] / (stats["analysis_grad_std_norm"][-1]
                                                          + 1e-10)
            stats["analysis_grad_SNR"] += [snr]
            log.info("Gradient SNR is %g", snr)

        if a.compute_gradient_noise_scale:
            # McCandlish et al.'s simple noise scale; b_local is the samples a
            # chunk really holds (epoch_layout may shrink the requested size)
            b_local = sub
            b_full = max(len(trainer.bundle.train), cfg.data.size)
            g_local = float(squared_norm)
            g_full = float(torch.sum(grad_mean ** 2))
            candlish_s = 1 / (1 / b_local - 1 / b_full + 1e-10) * (g_local - g_full)
            candlish_g = 1 / (b_full - b_local + 1e-10) * (b_full * g_full - b_local * g_local)
            scale = candlish_s / (candlish_g if candlish_g != 0 else 1e-10)
            stats["analysis_grad_noise_scale"] += [scale]
            log.info("Gradient Noise Scale is %g", scale)

    if a.compute_flatness:
        value = flatness(trainer, state)
        stats["analysis_empirical_flatness"] += [value]
        log.info("Empirical flatness from random directions with threshold %g is %g",
                 a.flatness_threshold, value)
    return stats


def gradient_sweep(trainer, model):
    """The per-chunk gradient sweep over the train split: ``(Welford state of
    every rank's chunk gradients, their norms in dataset order, samples a
    chunk)``."""
    cfg, bundle, world, device = trainer.cfg, trainer.bundle, trainer.world, trainer.device
    a_chunks = max(int(cfg.analysis.internal_batch_size_chunks), 1)
    num_blocks, chunks, sub, images, labels = trainer.sweep_rows(
        max(bundle.batch_size // a_chunks, 1), "Analysis sweep")
    rows = num_blocks * chunks

    acc = torch.promote_types(trainer.param_dtype, torch.float32)
    params = trainer.params
    wf = welford_init(sum(p.numel() for p in params), acc, device)
    norms = []
    model.eval()
    try:
        for _, seg_images, seg_labels in trainer.segments(images, labels):
            for row in range(len(seg_images)):
                x = (normalize_images(seg_images[row], trainer.mean, trainer.std, acc)
                     if bundle.normalize else seg_images[row].to(acc) / 255.0)
                loss = trainer.criterion(model(x), seg_labels[row]) / num_blocks
                vec = _flat(torch.autograd.grad(loss, params))
                norms.append(torch.linalg.vector_norm(vec).to(acc))
                wf = welford_update(wf, vec.to(acc))
    finally:
        model.train()
    norms = torch.stack(norms)
    if world.group is not None:
        # one all_gather of [count, norm sums, chunk norms, mean, m2] a rank;
        # every rank merges them in rank order
        head = torch.stack([wf.count.to(acc), wf.norm_estimate, wf.squared_norm_estimate])
        parts = all_gather(world, torch.cat([head, norms, wf.mean, wf.m2])).view(world.size, -1)
        states = []
        for part in parts:
            mean, m2 = part[3 + rows:].chunk(2)
            states.append(WelfordState(part[0].to(torch.float32), mean, m2, part[1], part[2]))
        wf = states[0]
        for other in states[1:]:
            wf = welford_merge(wf, other)
        # (ranks, blocks, chunks) -> dataset order (blocks, ranks, chunks)
        norms = parts[:, 3:3 + rows].view(world.size, num_blocks, chunks).transpose(0, 1)
    return wf, norms.reshape(-1), sub


def flatness(trainer, state) -> float:
    """Step along a random direction (``analysis.flatness_norm``) from the
    params, ``analysis.flatness_step_size`` at a time, until the mean loss
    over the train split crosses ``analysis.flatness_threshold``: the
    distance walked."""
    cfg, bundle = trainer.cfg, trainer.bundle
    val = stage_validation(bundle, bundle.batch_size, trainer.device, dryrun=cfg.dryrun,
                           world=trainer.world, cfg_impl=cfg.impl, split=bundle.train)

    def loss_at(values):
        with trainer.params_at(values):
            return trainer.eval_step(state.model, *val)["valid_loss"]

    generator = torch.Generator(device=trainer.device).manual_seed(int(state.step) + 777)
    value, _ = perturb2threshold(trainer.params, loss_at, generator,
                                 step_size=cfg.analysis.flatness_step_size,
                                 threshold=cfg.analysis.flatness_threshold,
                                 norm=cfg.analysis.flatness_norm)
    return value
