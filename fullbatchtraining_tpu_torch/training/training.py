"""Full-batch and stochastic training on one card or across ranks
(``fullbatchtraining_tpu/training/training.py``).

One full-batch optimizer step averages the gradient of the whole training
set, chunk by chunk, then applies the gradient modifiers and one SGD step:

    with hyp.grad_reg.acc_strength: streaming mean of per-block gradients
    for each chunk (sub_batch samples, in epoch order):
        crop+flip, normalize, forward + backward (train-mode BN, whose
        running stats carry on from chunk to chunk), loss
        squared gradient norm (before the regularizer and clipping)
        gradient regularizer (hyp.grad_reg), optional per-chunk clip
        streaming mean  avg += (g - avg) / (chunk + 1)  in accumulation dtype
    norm bias, full-gradient clip, gradient noise
    SGD step at lr = schedule(step), EMA

One stochastic step (``hyp.train_stochastic``, the SGD baseline) makes one
SGD update per block at ``lr = schedule(step)``, each on the gradient of one
forward over the block's ``chunks * sub`` images (regularized with no
pre-pass, clipped to ``hyp.grad_clip`` in the 2-norm), then one EMA update.
``hyp/optim_modification=SAM`` takes the update's gradient at
``params + rho * g / ||g||``: a second block gradient in a stochastic step, a
second full pass in a full-batch one. A closure optimizer (a line search,
FISTA's backtracking, L-BFGS; :mod:`.opt.closures`) replaces the update: its
driver evaluates the full-batch gradient, or in a stochastic step each
block's, as often as its search needs, and the EMA updates after it.
``hyp.train_switch_stochastic`` inverts the mode from that step on. With
``hyp.shuffle`` each step reads the epoch in the order
:func:`~..data.pipeline.epoch_order` draws for it, gathered on the device
from the resident epoch. On a baked store
(``data.db``) a full-batch step reads all ``rounds x size`` images; with
``hyp.train_semi_stochastic`` step ``s`` reads round ``s % rounds`` alone.

An epoch laid out above ``impl.hbm_epoch_max_bytes``
(:func:`~..data.pipeline.stream_plan`) stays in host memory: a step's rows
stream to the device segment by segment (:mod:`..parallel.streaming`), the
host gathering a shuffled or semi-stochastic step's rows a segment at a
time, and every pass walks the segments in the resident pass's order, so a
streamed step is the resident step bit for bit. A validation set above the
budget streams the same way, and ``impl.eval_block_chunks`` splits each
evaluation block into sub-chunks (the metrics are sums).

These are the JAX package's semantics for a mesh of ``W`` devices with
``impl.block_grouping=1`` (its grouped scan is exact, so it computes the same
thing), ``W`` the size of the run's :class:`~..parallel.World`. Rank ``r``
trains on ``[:, r]`` of the step's rows laid out ``(blocks, W, chunks,
sub)`` with its own augmentation draws and BN running stats; a full-batch
pass ends in one ``all_reduce`` over a bucket of the gradient mean, the BN
stats, the scalar stats and per-chunk norm slots, and a stochastic update
takes the mean of the ranks' block gradients.

Dropout and stochastic depth draw from a generator seeded per chunk (per
block in a stochastic step or the regularizer's pre-pass) from the step's
generator (:meth:`Trainer.layer_seed`), opened around each forward
(``models.modules.layer_draws``); the regularizer's second gradient, a SAM
pass and a closure driver's re-evaluations of a block open it with the same
seed, so they see the first pass's masks, as the JAX package hands them the
chunk's key. ``impl.mixed_precision`` runs
the forward under bf16 autocast with fp32 parameters and accumulators;
logits are cast to the stat dtype.

With ``analysis.type`` set, a step after which analysis is due and reads
gradients first takes :meth:`Trainer.pre_step_gradient`, the gradient that
produces the step, in a pass that leaves the running stats as they were;
:func:`~..analysis.analyze` runs after the validation and again at the
``hyp.stop_at_full_training_accuracy`` stop, as in the JAX loop. With
``analysis.save_model_every_nth_step`` the steps ``k`` with ``(k - 1) %
every == 0`` and the last write ``<name>_<model>_step_<k>.pt`` in the
working directory (rank 0; :func:`~.utils.save_state_for_visualization`):
the model after the step, the pre-step gradient (one pass serves analysis
and the snapshot where both are due) and the update direction, the SGD
momentum buffers or, under Nesterov, ``g + momentum * buffer``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from collections import defaultdict

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..convert import jax_param_paths
from ..data.augmentations import normalize as normalize_images
from ..data.pipeline import DataBundle, epoch_layout, epoch_order, rank_rows, stream_plan
from ..models.models import estimate_activation_bytes
from ..models.modules import get_loss_fn, layer_draws
from ..parallel import World, all_reduce, all_reduce_parts, barrier, current_world
from ..parallel.streaming import HostRows, host_tensor, stream_segments
from ..utils import resolve_device
from .grad_reg import make_grad_regularizer, tree_add_scaled, tree_sqnorm
from .opt.closures import DriverState, make_closure_step, make_stochastic_closure_step
from .optimizers import make_lr_schedule, make_optimizer, optim_interface
from .utils import (CheckpointWriter, checkpoint_file, load_checkpoint,
                    save_state_for_visualization)

log = logging.getLogger(__name__)

_DTYPES = {"float": torch.float32, "float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "double": torch.float64}
# Generator streams: rank r draws its augmentations from stream r, the
# gradient noise comes from one stream that no rank reaches
_NOISE_STREAM = 1 << 32
_STREAM_STRIDE = 0x9E3779B97F4A7C15   # an odd 64-bit constant
# the stochastic layers' seeds of the acc_strength pre-pass's blocks, apart
# from the chunks' (the JAX package's 7_000_000 + block)
_PRE_PASS_DRAWS = 7_000_000


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer | None   # None for L-BFGS
    ema_model: nn.Module | None = None  # hyp.evaluate_ema: EMA of params and BN stats


def check_slice(cfg) -> None:
    """Raise for modes the port does not run yet, naming their ROADMAP item."""
    hyp = cfg.hyp
    missing = [
        (cfg.impl.get("trace", False), "impl.trace", "Profiler trace"),
        ("float16" in (cfg.impl.dtype, cfg.impl.compute_dtype, cfg.impl.accumulation_dtype),
         "float16 parameters or compute", "Float16 compute"),
    ]
    for active, what, item in missing:
        if active:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, '{item}')")


def tree_clip_by_norm(tensors, max_norm, norm_type, eps=1e-6):
    """Clip a list of tensors to total norm ``max_norm`` (2, p or inf).

    Returns (clipped list, was_clipped, pre-clip norm); no host sync."""
    if norm_type == float("inf") or norm_type == "inf":
        norm = torch.stack([t.abs().max() for t in tensors]).max()
    elif norm_type == 2:
        norm = torch.sqrt(tree_sqnorm(tensors))
    else:
        p = float(norm_type)
        norm = torch.stack([(t.abs() ** p).sum() for t in tensors]).sum() ** (1.0 / p)
    clipped = norm > max_norm
    scale = torch.where(clipped, max_norm / (norm + eps), torch.ones_like(norm))
    return [t * scale for t in tensors], clipped, norm


def upload_rows(images, rows: np.ndarray, device, piece: int) -> torch.Tensor:
    """Rows ``rows`` (indices, in order) of the host array ``images`` (a
    baked store's memmap too) as one uint8 tensor on ``device``, copied
    ``piece`` rows at a time: the host holds one piece, never the whole set,
    in RAM. A piece of consecutive rows is read as a slice."""
    out = torch.empty((len(rows), *images.shape[1:]), dtype=torch.uint8, device=device)
    for start in range(0, len(rows), piece):
        sel = rows[start:start + piece]
        if np.all(np.diff(sel) == 1):
            host = np.array(images[sel[0]:sel[-1] + 1])
        else:
            host = np.asarray(images[sel])
        out[start:start + len(sel)].copy_(torch.from_numpy(host))
    return out


def stage_validation(bundle: DataBundle, batch: int, device, dryrun: bool = False,
                     world: World | None = None, cfg_impl=None, split=None):
    """This rank's part of the validation set (or of ``split``, another
    split of the bundle: flatness reads the train set): the set padded to a
    ``(blocks, W, batch)`` grid (``ceil(n / W)`` samples a rank in whole
    blocks of ``batch``) with per-sample weights, 0 on padding, and
    ``[:, rank]`` of it. Labels and weights go to ``device``; the images
    too, unless ``cfg_impl`` is given and the grid is above its
    ``hbm_epoch_max_bytes``: then they stay in host memory as
    :class:`HostRows` of a block a row, which :meth:`Trainer.eval_step`
    streams."""
    world = world if world is not None else World()
    split = bundle.valid if split is None else split
    images, labels = split.images, split.labels
    n, ranks = len(images), world.size
    per_rank = -(-n // ranks)
    blocks = 1 if dryrun else -(-per_rank // batch)
    total = ranks * blocks * batch
    keep = min(n, total)
    pad = total - keep
    weights = np.concatenate([np.ones(keep, np.float32), np.zeros(pad, np.float32)])
    if pad:
        images = np.concatenate([images[:keep], np.zeros((pad, *images.shape[1:]), images.dtype)])
        labels = np.concatenate([labels[:keep], np.zeros(pad, labels.dtype)])
    else:   # a memmap stays one
        images, labels = images[:total], labels[:total]

    def mine(a):
        return np.ascontiguousarray(a.reshape(blocks, ranks, batch, *a.shape[1:])[:, world.rank])

    staged_labels = torch.from_numpy(mine(labels)).long().to(device)
    staged_weights = torch.from_numpy(mine(weights)).to(device)
    item = int(np.prod(images.shape[1:])) * images.dtype.itemsize
    streamed, seg_blocks, nbytes = (stream_plan(blocks, 1, batch, ranks, item, cfg_impl)
                                    if cfg_impl is not None else (False, blocks, 0))
    if streamed:
        log.info("Validation set (%.2f GB padded) above impl.hbm_epoch_max_bytes: streamed from "
                 "the host in segments of %d blocks.", nbytes / 1e9, seg_blocks)
        host = HostRows(mine(images).reshape(blocks * batch, *images.shape[1:]), None, blocks,
                        batch, seg_blocks)
        return host, staged_labels, staged_weights
    return host_tensor(mine(images)).to(device), staged_labels, staged_weights


def _resolve_eval_chunking(spec, batch: int, act_bytes_per_sample=None, act_budget=None,
                           double: bool = False) -> int:
    """Sub-chunks per evaluation block (``impl.eval_block_chunks``), the JAX
    package's function as it is: ``auto`` (or True) takes the smallest
    divisor of ``batch`` whose sub-chunk's activations (``batch / k``
    samples of ``act_bytes_per_sample``, twice that with ``double``: the
    test-time flips keep two forwards alive) fit ``act_budget`` (default 9
    GiB); an integer is rounded up to the next divisor of ``batch``; None,
    False, 0 and 1 split nothing."""
    if spec is True:
        spec = "auto"
    if spec is None or spec is False or spec in (0, 1):
        return 1
    if spec == "auto":
        if not act_bytes_per_sample:
            return 1
        budget = int(act_budget or (9 << 30))
        per_sample = int(act_bytes_per_sample) * (2 if double else 1)
        need = -(-(batch * per_sample) // max(budget, 1))
        if need <= 1:
            return 1
    else:
        need = max(1, int(spec))
    for k in range(min(need, batch), batch + 1):
        if batch % k == 0:
            return k
    return batch


def status_message(stats, step):
    def last(key):
        return stats[key][-1] if stats.get(key) else float("nan")

    return (f"Step: {step:<4}| lr: {last('lr'):.4f} | Time: {last('train_time'):4.2f}s |"
            f"TRAIN loss {last('train_loss'):7.4f} | TRAIN Acc: {last('train_acc'):7.2%} |"
            f"VAL loss {last('valid_loss'):7.4f} | VAL Acc: {last('valid_acc'):7.2%} |")


class Trainer:
    """The step functions of one run: ``full_step``, ``sam_step``,
    ``stochastic_step`` and ``eval_step``, on the rows ``stage(step)`` gives,
    for one rank of ``world`` (the default process group's by default)."""

    def __init__(self, model: nn.Module, bundle: DataBundle, cfg, device,
                 world: World | None = None):
        hyp, impl = cfg.hyp, cfg.impl
        self.cfg, self.bundle, self.device = cfg, bundle, device
        self.world = world if world is not None else current_world()
        self.param_dtype = _DTYPES[impl.dtype]
        self.acc_dtype = _DTYPES[impl.accumulation_dtype]
        compute = (_DTYPES[impl.compute_dtype] if impl.compute_dtype
                   else (torch.bfloat16 if impl.mixed_precision else self.param_dtype))
        self.compute_dtype = compute
        self.autocast_dtype = None if compute == self.param_dtype else compute
        if self.autocast_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"compute dtype {compute} with parameters in "
                                      f"{self.param_dtype} has no autocast form")
        # loss and stat scalars: at least float32, float64 in float64 runs
        self.stat_dtype = torch.promote_types(self.param_dtype, torch.float32)
        # semi-stochastic: a step reads one round of the baked store
        baked = bundle.baked
        self.semi = bool(hyp.train_semi_stochastic) and baked is not None
        self.round_size = baked.meta["size"] if self.semi else bundle.size
        self.num_blocks, self.chunks, self.sub = epoch_layout(
            self.round_size, bundle.batch_size, hyp.sub_batch, self.world.size,
            dryrun=cfg.dryrun)
        self.criterion = get_loss_fn(hyp, bundle.batch_size)
        self.schedule = make_lr_schedule(hyp)
        self.weight_decay = float(hyp.optim.get("weight_decay", 0.0) or 0.0)
        self.mean = torch.as_tensor(bundle.mean, device=device)
        self.std = torch.as_tensor(bundle.std, device=device)

        model.to(device=device, dtype=self.param_dtype, memory_format=torch.channels_last)
        self.model = model
        self.param_names = [name for name, _ in model.named_parameters()]
        self.params = list(model.parameters())
        # the seed of the stochastic layers' draws in the current chunk or block
        self.draw_seed = None
        self.reg_fn = make_grad_regularizer(hyp.grad_reg, self.regrad)
        self.sam_rho = (float(hyp.optim_modification.rho)
                        if hyp.optim_modification.name == "SAM" else None)
        spec = impl.get("eval_block_chunks", "auto")
        act_bytes = (estimate_activation_bytes(model, bundle.pixels, bundle.channels, compute)
                     if spec == "auto" or spec is True else None)
        self.eval_chunks = _resolve_eval_chunking(spec, bundle.batch_size, act_bytes,
                                                  impl.get("activation_budget_bytes"),
                                                  double=bool(hyp.test_time_flips))

        # Where the epoch lives (the JAX package's stage_epoch). Laid out
        # above impl.hbm_epoch_max_bytes it stays on the host, and stage()
        # hands out this rank's rows of the step as HostRows that stream in
        # segments of seg_blocks blocks. Else it is resident on the device as
        # uint8: in order, this rank's rows, one per chunk; shuffled or
        # semi-stochastic, as the flat [N, H, W, C] set (a baked store's
        # rounds x size) that stage() gathers this rank's rows from in each
        # step's order, as long as impl.device_shuffle is on and the set is
        # within impl.device_shuffle_max_bytes. Otherwise stage() gathers the
        # step's rows on the host and uploads them. A baked store goes up one
        # round at a time from its memmap.
        self.shuffle = bool(hyp.shuffle)
        images, labels = bundle.train.images, bundle.train.labels
        piece = baked.meta["size"] if baked is not None else len(images)
        item = int(np.prod(images.shape[1:])) * images.dtype.itemsize
        self.streamed, self.seg_blocks, epoch_bytes = stream_plan(
            self.num_blocks, self.chunks, self.sub, self.world.size, item, impl)
        if self.streamed:
            log.info("Epoch (%.2f GB laid out) above impl.hbm_epoch_max_bytes: streamed from "
                     "the host in segments of %d blocks.", epoch_bytes / 1e9, self.seg_blocks)
        device_gather = (not self.streamed and bool(impl.get("device_shuffle", True))
                         and images.nbytes <= int(impl.get("device_shuffle_max_bytes", 8 << 30)))
        if self.streamed or ((self.semi or self.shuffle) and not device_gather):
            self.images = self.labels = None
        elif self.semi or self.shuffle:
            self.images = upload_rows(images, np.arange(len(images)), device, piece)
            self.labels = torch.from_numpy(labels).long().to(device)
        else:
            rows = self.num_blocks * self.chunks
            mine = self.rank_rows(np.arange(len(images)))
            self.images = upload_rows(images, mine, device, piece).view(
                rows, self.sub, *images.shape[1:])
            self.labels = torch.from_numpy(labels[mine]).long().to(device).view(rows, self.sub)

    def rank_rows(self, order) -> np.ndarray:
        """The entries of the step order ``order`` that this rank trains on."""
        return rank_rows(order, self.num_blocks, self.chunks, self.sub, self.world.size,
                         self.world.rank)

    def stage(self, step: int):
        """``(images, labels)`` of step ``step`` on this rank, one row of
        ``sub`` samples a chunk: this rank's part of the step's order
        (``arange`` when unshuffled; semi-stochastic, into round ``step %
        rounds``). Resident in order, the fixed rows; resident shuffled or
        semi-stochastic, a gather from the resident set on the device, only
        the order (int64) going there. Else the rows of the host set (or
        round) in that order: streamed, as :class:`HostRows` that
        :meth:`segments` brings to the device; not streamed, gathered on the
        host and uploaded. The labels are on the device in every case. With
        several ranks a step draws without replacement, as the JAX package's
        multi-process runs do."""
        if not (self.shuffle or self.semi) and self.images is not None:
            return self.images, self.labels
        hyp = self.cfg.hyp
        rows = self.num_blocks * self.chunks
        n = self.round_size
        replace = bool(hyp.get("sample_with_replacement", False)) and self.world.size == 1
        order = self.rank_rows(epoch_order(self.cfg.seed, step, n, replace)
                               if self.shuffle else np.arange(n))
        if self.images is not None:
            if self.semi:
                order = order + (step % self.bundle.baked.rounds) * n
            idx = torch.from_numpy(order).to(self.device)
            images = self.images.index_select(0, idx)
            labels = self.labels.index_select(0, idx)
            return images.view(rows, self.sub, *images.shape[1:]), labels.view(rows, self.sub)
        source = self.bundle.baked.round(step) if self.semi else self.bundle.train
        labels = torch.from_numpy(source.labels[order]).long().to(self.device).view(rows, self.sub)
        if self.streamed:
            return HostRows(source.images, order, rows, self.sub,
                            self.seg_blocks * self.chunks), labels
        images = upload_rows(source.images, order, self.device, len(order))
        return images.view(rows, self.sub, *images.shape[1:]), labels

    def segments(self, images, labels):
        """``(first row, images, labels)`` of each segment of the staged
        rows on the device: one segment of all of them where they are
        resident, else :func:`~..parallel.streaming.stream_segments` of the
        :class:`HostRows`, whole blocks a segment. A segment is valid until
        the next one is asked for."""
        if not isinstance(images, HostRows):
            yield 0, images, labels
            return
        for start, segment in stream_segments(images, self.device):
            yield start, segment, labels[start:start + len(segment)]

    def sweep_rows(self, sub_batch: int, what: str):
        """The unshuffled, unaugmented train split laid out ``(blocks, ranks,
        chunks, sub)`` in blocks of ``data.batch_size`` and chunks of
        ``sub_batch``, for the sweeps of analysis and the loss surface:
        ``(num_blocks, chunks, sub, images, labels)`` with this rank's rows,
        one a chunk, resident or, above ``impl.hbm_epoch_max_bytes``, as
        :class:`HostRows` that :meth:`segments` streams (``what`` names the
        sweep in the log)."""
        cfg, bundle, world = self.cfg, self.bundle, self.world
        train = bundle.train
        num_blocks, chunks, sub = epoch_layout(len(train), bundle.batch_size, sub_batch,
                                               world.size, dryrun=cfg.dryrun)
        rows = num_blocks * chunks
        order = rank_rows(np.arange(len(train)), num_blocks, chunks, sub, world.size, world.rank)
        labels = torch.from_numpy(train.labels[order]).long().to(self.device).view(rows, sub)
        item = int(np.prod(train.images.shape[1:])) * train.images.dtype.itemsize
        streamed, seg_blocks, nbytes = stream_plan(num_blocks, chunks, sub, world.size, item,
                                                   cfg.impl)
        if streamed:
            log.info("%s (%.2f GB laid out) above impl.hbm_epoch_max_bytes: streamed from the "
                     "host in segments of %d blocks.", what, nbytes / 1e9, seg_blocks)
            images = HostRows(train.images, order, rows, sub, seg_blocks * chunks)
        else:
            images = upload_rows(train.images, order, self.device, len(order)).view(
                rows, sub, *train.images.shape[1:])
        return num_blocks, chunks, sub, images, labels

    # -- inputs and forward -------------------------------------------------
    def _normalize(self, images):
        if self.bundle.normalize:
            return normalize_images(images, self.mean, self.std, self.compute_dtype)
        return images.to(self.compute_dtype) / 255.0

    def forward(self, model, x):
        """Logits of ``model`` on ``x`` in ``stat_dtype``; stochastic layers
        draw from ``self.draw_seed``."""
        with torch.autocast(self.device.type, dtype=self.autocast_dtype or torch.bfloat16,
                            enabled=self.autocast_dtype is not None), layer_draws(self.draw_seed):
            logits = model(x)
        return logits.to(self.stat_dtype)

    @staticmethod
    def layer_seed(gen: torch.Generator, index: int) -> int:
        """The stochastic layers' seed of chunk (or block) ``index`` of the
        step whose generator is ``gen``: a function of ``gen``'s seed and
        ``index`` alone, so it draws nothing from ``gen``."""
        return (gen.initial_seed() ^ ((index + 1) * _STREAM_STRIDE)) % 2**64

    def generator(self, step: int, stream: int | None = None) -> torch.Generator:
        """The generator of step ``step`` and ``stream``, by default this
        rank's: stream ``s`` is seeded ``seed * 1_000_003 + step + s *
        _STREAM_STRIDE`` (mod 2^64), so rank 0 draws as a single process does
        and each rank differs, as the JAX package folds in the device."""
        seed = self.cfg.seed if self.cfg.seed is not None else 0
        stream = self.world.rank if stream is None else stream
        value = (int(seed) * 1_000_003 + step + stream * _STREAM_STRIDE) % 2**64
        return torch.Generator(device=self.device).manual_seed(value)

    def regrad(self, params, x, labels, create_graph=False):
        """Gradient of the chunk loss with respect to ``params`` (a list in
        ``self.params`` order, requiring grad) on the prepared inputs ``x``:
        the regularizer's ``grad_fn``. BatchNorm runs in train mode on clones
        of the running stats, so the model's own see one update per chunk;
        stochastic layers draw the masks of the chunk's own forward."""
        state = dict(zip(self.param_names, params))
        state.update({name: b.clone() for name, b in self.model.named_buffers()})
        logits = self.forward(lambda inputs: functional_call(self.model, state, (inputs,)), x)
        loss = self.criterion(logits, labels)
        return list(torch.autograd.grad(loss, params, create_graph=create_graph))

    def _add_to_mean(self, avg, grads, count):
        """``avg += (grads - avg) / count`` after the optional per-block clip;
        returns the clip flag or None."""
        hyp = self.cfg.hyp
        grads = [g.to(self.acc_dtype) for g in grads]
        was_clipped = None
        if hyp.batch_clip is not None:
            grads, was_clipped, _ = tree_clip_by_norm(grads, hyp.batch_clip, hyp.grad_clip_norm)
        diff = torch._foreach_sub(grads, avg)
        torch._foreach_div_(diff, count)
        torch._foreach_add_(avg, diff)
        return was_clipped

    def block(self, images, labels, bidx: int, gen):
        """Block ``bidx`` of the rows ``images`` (a segment's), flat,
        augmented from ``gen`` and normalized: ``(x, labels)``."""
        rows = slice(bidx * self.chunks, (bidx + 1) * self.chunks)
        images, labels = images[rows].flatten(0, 1), labels[rows].flatten(0, 1)
        if self.bundle.augmentations_active:
            images = self.bundle.augment(images, gen)
        return self._normalize(images), labels

    def pre_gradient(self, gen, images, labels):
        """The ``hyp.grad_reg.acc_strength`` pre-pass over the staged rows:
        streaming mean of the gradients of whole blocks (one forward over
        ``chunks * sub`` images each) at the step's parameters, with the
        step's running stats, whose updates it discards. Its augmentations
        are drawn from the step's generator ``gen``, before those of the main
        pass."""
        avg = [torch.zeros_like(p, dtype=self.acc_dtype) for p in self.params]
        for start, seg_images, seg_labels in self.segments(images, labels):
            for b in range(len(seg_images) // self.chunks):
                x, lbls = self.block(seg_images, seg_labels, b, gen)
                index = start // self.chunks + b
                self.draw_seed = self.layer_seed(gen, _PRE_PASS_DRAWS + index)
                self._add_to_mean(avg, self.regrad(self.params, x, lbls), index + 1)
        return avg

    # -- one full-batch step --------------------------------------------------
    def accumulate(self, model, gen, lr, images, labels):
        """Streaming mean of the chunk gradients over the staged rows
        ``images``, ``labels``, BN stats carried along, each chunk's gradient
        regularized at learning rate ``lr``; then :meth:`reduce_pass`.
        Returns (avg grads, metrics, squared chunk norms of every rank)."""
        hyp = self.cfg.hyp
        model.train()
        pre_grads = (self.pre_gradient(gen, images, labels)
                     if hyp.grad_reg.acc_strength != 0 else None)
        avg = [torch.zeros_like(p, dtype=self.acc_dtype) for p in self.params]
        sloss = torch.zeros((), dtype=self.stat_dtype, device=self.device)
        spreds = torch.zeros((), dtype=self.stat_dtype, device=self.device)
        sq_norms, clipped = [], []
        for start, seg_images, seg_labels in self.segments(images, labels):
            for row in range(len(seg_images)):
                chunk, lbls = seg_images[row], seg_labels[row]
                if self.bundle.augmentations_active:
                    chunk = self.bundle.augment(chunk, gen)
                x = self._normalize(chunk)
                self.draw_seed = self.layer_seed(gen, start + row)
                logits = self.forward(model, x)
                loss = self.criterion(logits, lbls)
                grads = torch.autograd.grad(loss, self.params)
                sq_norms.append(tree_sqnorm(grads))
                if self.reg_fn is not None:
                    grads = self.reg_fn(grads, self.params, x, lbls, pre_grads, lr)
                was_clipped = self._add_to_mean(avg, grads, start + row + 1)
                if was_clipped is not None:
                    clipped.append(was_clipped.to(torch.float32))
                sloss = sloss + loss.detach() / self.chunks
                spreds = spreds + (logits.argmax(-1) == lbls).to(self.stat_dtype).sum()

        sq_norms = torch.stack(sq_norms)
        full_loss, param_norm = self.full_loss(lr, sloss, sq_norms)
        if pre_grads is not None:
            full_loss = full_loss + lr / 4 * hyp.grad_reg.acc_strength * tree_sqnorm(pre_grads)
        clipped = torch.stack(clipped).sum() if clipped else torch.zeros_like(sloss)
        return self.reduce_pass(model, avg, sloss, spreds, full_loss, sq_norms, clipped,
                                param_norm)

    def full_loss(self, lr, sloss, sq_norms):
        """This rank's full loss of the pass (the JAX package's
        ``_finalize_stats``, without the ``acc_strength`` term) and the
        squared parameter norm."""
        hyp = self.cfg.hyp
        param_norm = tree_sqnorm([p.detach() for p in self.params])
        full_loss = sloss / self.num_blocks + 0.5 * self.weight_decay * param_norm
        if hyp.grad_reg.block_strength != 0:
            full_loss = full_loss + lr / 4 * hyp.grad_reg.block_strength * sq_norms.mean()
        return full_loss, param_norm

    def reduce_pass(self, model, avg, sloss, spreds, full_loss, sq_norms, clipped, param_norm):
        """The pass's one ``all_reduce`` (JAX ``_local_accumulate``): the sum
        over the ranks of one bucket holding the gradient mean ``avg`` (or
        nothing, for ``[]``), the model's BN running stats, the scalars
        ``[loss, correct, full loss, mean squared chunk norm, clip count]``
        and a ``[W, chunks]`` slot of squared chunk norms, zero but for this
        rank's row. The gradient and the running stats are then divided by
        ``W``, and the metrics read from the sums as the JAX package's
        ``_metrics_from_package`` reads them, ``grad_norm`` included. Returns
        (avg, metrics, every rank's squared chunk norms, rank-major)."""
        world, ranks = self.world, self.world.size
        buffers = [b for b in model.buffers() if b.is_floating_point()]
        scalars = torch.stack([t.to(self.stat_dtype) for t in
                               (sloss, spreds, full_loss, sq_norms.mean(), clipped)])
        slots = sq_norms.new_zeros((ranks, len(sq_norms)))
        slots[world.rank] = sq_norms
        summed = all_reduce_parts(world, [*avg, *buffers, scalars, slots])
        avg, scalars, slots = summed[:len(avg)], summed[-2], summed[-1]
        if world.group is not None:
            if avg:
                torch._foreach_div_(avg, ranks)
            with torch.no_grad():
                for b, total in zip(buffers, summed[len(avg):-2]):
                    b.copy_(total / ranks)
        metrics = {
            "train_loss": scalars[0] / self.num_blocks / ranks,
            "train_acc": scalars[1] / (self.num_blocks * self.chunks * self.sub * ranks),
            "param_norm": param_norm,
            "grad_norm": torch.sqrt(scalars[3]) / ranks,
            "full_loss": scalars[2] / ranks,
            "clipped_batches": scalars[4],
        }
        return avg, metrics, slots.flatten()

    def modify_gradient(self, grads, gen, metrics):
        """Norm bias, full-gradient clip and gradient noise, drawn from
        ``gen``, a generator that every rank seeds alike."""
        hyp = self.cfg.hyp
        params = [p.detach() for p in self.params]
        if hyp.norm_bias.strength > 0.0:
            pn = tree_sqnorm(params)
            if hyp.norm_bias.norm_type == 1:
                sign = torch.sign(pn - hyp.norm_bias.bias ** 2)
                grads = [g + hyp.norm_bias.strength * sign for g in grads]
            else:
                factor = 2 * (pn - hyp.norm_bias.bias ** 2)
                grads = [g + hyp.norm_bias.strength * factor * p for g, p in zip(grads, params)]
        if hyp.grad_clip is not None:
            grads, was_clipped, pre_norm = tree_clip_by_norm(grads, hyp.grad_clip,
                                                             hyp.grad_clip_norm)
            metrics["preclip_gradnorm"] = pre_norm
            metrics["clipped_step"] = was_clipped.to(torch.float32)
        if hyp.grad_noise.additive is not None:
            grads = [g + hyp.grad_noise.additive
                     * torch.randn(g.shape, generator=gen, dtype=g.dtype, device=g.device)
                     for g in grads]
        if hyp.grad_noise.multiplicative is not None:
            grads = [g * (1 + hyp.grad_noise.multiplicative
                          * torch.randn(g.shape, generator=gen, dtype=g.dtype, device=g.device))
                     for g in grads]
        return grads, metrics

    def gradient_eval(self, state: TrainState, images, labels):
        """The modified full-batch gradient at the model's params, from the
        step's generators; the running stats carry on through the pass and
        are then the ranks' mean. Returns (grads, metrics, squared chunk
        norms of every rank)."""
        lr = self.schedule(state.step)
        gen = self.generator(state.step)
        grads, metrics, sq_norms = self.accumulate(state.model, gen, lr, images, labels)
        grads, metrics = self.modify_gradient(grads, self.generator(state.step, _NOISE_STREAM),
                                              metrics)
        return grads, metrics, sq_norms

    def pre_step_gradient(self, state: TrainState, images, labels):
        """:meth:`gradient_eval` at the step's params for analysis, taken
        before the step: every buffer of the model is as it was after it,
        and the step's generators are seeded afresh, so the step that
        follows is the one it would be without this pass."""
        buffers = list(state.model.buffers())
        saved = [b.detach().clone() for b in buffers]
        grads, _, _ = self.gradient_eval(state, images, labels)
        with torch.no_grad():
            for b, value in zip(buffers, saved):
                b.copy_(value)
        return grads

    def sgd_update(self, optimizer, grads, lr) -> None:
        for group in optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    def ema_update(self, state: TrainState) -> None:
        if state.ema_model is not None:
            m = self.cfg.hyp.eval_ema_momentum
            with torch.no_grad():
                for e, t in zip(state.ema_model.state_dict().values(),
                                state.model.state_dict().values()):
                    e.copy_(m * e + (1 - m) * t)

    def full_step(self, state: TrainState, images, labels):
        """One optimizer step on the full-batch gradient of the staged rows;
        returns metrics as device scalars plus the per-chunk gradient norms."""
        lr = self.schedule(state.step)
        grads, metrics, sq_norms = self.gradient_eval(state, images, labels)
        self.sgd_update(state.optimizer, grads, lr)
        self.ema_update(state)
        state.step += 1
        metrics["lr"] = lr
        metrics["grad_norms_per_chunk"] = torch.sqrt(sq_norms)
        return metrics

    @contextlib.contextmanager
    def params_at(self, values):
        """The model's params hold ``values`` inside the block and their own
        values again after it (copies, so the restore is exact)."""
        with torch.no_grad():
            saved = [p.detach().clone() for p in self.params]
            for p, v in zip(self.params, values):
                p.copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, v in zip(self.params, saved):
                    p.copy_(v)

    def sam_step(self, state: TrainState, images, labels):
        """One full-batch SAM step (``training/opt/sam.py``): the modified
        gradient ``g`` at the params, then the modified gradient at
        ``params + rho * g / ||g||``, whose pass carries on from the first
        one's running stats; SGD steps on that second gradient from the
        original params. Metrics are the second pass's; no per-chunk norms.
        Two ``all_reduce`` a step: the second pass starts from the ranks'
        mean of the first pass's running stats."""
        lr = self.schedule(state.step)
        grads, _, _ = self.gradient_eval(state, images, labels)
        norm = torch.sqrt(tree_sqnorm(grads))
        params = [p.detach() for p in self.params]
        with self.params_at(tree_add_scaled(params, grads, self.sam_rho / (norm + 1e-12))):
            grads, metrics, _ = self.gradient_eval(state, images, labels)
        self.sgd_update(state.optimizer, grads, lr)
        self.ema_update(state)
        state.step += 1
        metrics["lr"] = lr
        return metrics

    # -- one stochastic step ----------------------------------------------------
    def block_grads(self, params, x, labels, lr, reduce_stats=False):
        """The SGD update's gradient of one block: one train-mode forward over
        this rank's part of the block at ``params`` (a list in
        ``self.params`` order), which updates the model's running stats; the
        regularizer with no pre-pass; the ranks' mean, through one
        ``all_reduce``; ``hyp.grad_clip`` in the 2-norm. Returns (grads, loss,
        correct, squared norm before the regularizer). With ``reduce_stats``
        the same ``all_reduce`` also sums loss and correct over the ranks and
        averages the running stats (a closure driver's block evaluation)."""
        hyp = self.cfg.hyp
        state = dict(zip(self.param_names, params))
        logits = self.forward(lambda inputs: functional_call(self.model, state, (inputs,)), x)
        loss = self.criterion(logits, labels)
        grads = torch.autograd.grad(loss, params)
        sq_norm = tree_sqnorm(grads)
        if self.reg_fn is not None:
            grads = self.reg_fn(grads, params, x, labels, None, lr)
        loss = loss.detach()
        correct = (logits.argmax(-1) == labels).to(self.stat_dtype).sum()
        if self.world.group is not None:
            n = len(grads)
            buffers = ([b for b in self.model.buffers() if b.is_floating_point()]
                       if reduce_stats else [])
            scalars = [torch.stack([loss.to(self.stat_dtype), correct])] if reduce_stats else []
            summed = all_reduce_parts(self.world, [*grads, *buffers, *scalars])
            grads = summed[:n]
            torch._foreach_div_(grads, self.world.size)
            if reduce_stats:
                loss, correct = summed[-1]
                with torch.no_grad():
                    for b, total in zip(buffers, summed[n:-1]):
                        b.copy_(total / self.world.size)
        if hyp.grad_clip is not None:
            grads, _, _ = tree_clip_by_norm(grads, hyp.grad_clip, 2)
        return grads, loss, correct, sq_norm

    def stochastic_step(self, state: TrainState, images, labels):
        """One epoch of SGD, one update per block of the staged rows, all at
        ``lr = schedule(step)``; under SAM each update takes its gradient at
        ``params + rho * g / ||g||``, a second pass over the block that
        carries on from the first one's running stats. One EMA update after
        the epoch. Metrics as ``full_step``'s, with one gradient norm per
        block and no clipping count. The running stats stay this rank's
        through the epoch; one :meth:`reduce_pass` at its end averages them
        and sums the stats."""
        lr = self.schedule(state.step)
        gen = self.generator(state.step)
        state.model.train()
        sloss = torch.zeros((), dtype=self.stat_dtype, device=self.device)
        spreds = torch.zeros((), dtype=self.stat_dtype, device=self.device)
        sq_norms = []
        for start, seg_images, seg_labels in self.segments(images, labels):
            for b in range(len(seg_images) // self.chunks):
                x, lbls = self.block(seg_images, seg_labels, b, gen)
                self.draw_seed = self.layer_seed(gen, start // self.chunks + b)
                grads, loss, correct, sq_norm = self.block_grads(self.params, x, lbls, lr)
                if self.sam_rho is not None:
                    norm = torch.sqrt(tree_sqnorm(grads))
                    perturbed = tree_add_scaled([p.detach() for p in self.params], grads,
                                                self.sam_rho / (norm + 1e-12))
                    grads, _, _, _ = self.block_grads([p.requires_grad_() for p in perturbed],
                                                      x, lbls, lr)
                self.sgd_update(state.optimizer, grads, lr)
                sloss = sloss + loss
                spreds = spreds + correct
                sq_norms.append(sq_norm)

        sq_norms = torch.stack(sq_norms)
        full_loss, param_norm = self.full_loss(lr, sloss, sq_norms)
        _, metrics, sq_norms = self.reduce_pass(state.model, [], sloss, spreds, full_loss,
                                                sq_norms, torch.zeros_like(sloss), param_norm)
        self.ema_update(state)
        state.step += 1
        metrics["lr"] = lr
        metrics["grad_norms_per_chunk"] = torch.sqrt(sq_norms)
        return metrics

    # -- one closure-optimizer step --------------------------------------------
    def load_params(self, values) -> None:
        """Copy ``values`` (a list in ``self.params`` order) into the params."""
        with torch.no_grad():
            for p, v in zip(self.params, values):
                if p is not v:
                    p.copy_(v)

    def driver_state(self, state: TrainState) -> DriverState:
        """The closure drivers' view of ``state``: copies of the params and
        the SGD momentum buffers (None before the first update)."""
        opt_state = state.optimizer.state if state.optimizer is not None else {}
        bufs = [opt_state.get(p, {}).get("momentum_buffer") for p in self.params]
        return DriverState(state.step, [p.detach().clone() for p in self.params],
                           None if any(b is None for b in bufs) else bufs)

    def commit(self, state: TrainState, new: DriverState) -> None:
        """Write a driver's result into the model, the SGD state and the step."""
        self.load_params(new.params)
        if new.momentum is not None and float(self.cfg.hyp.optim.get("momentum", 0) or 0):
            for p, b in zip(self.params, new.momentum):
                state.optimizer.state[p]["momentum_buffer"] = b
        state.step = new.step

    def closure_step(self, state: TrainState, driver, images, labels):
        """One full-batch step of a closure ``driver``: as many full passes
        as its search takes, each at the params it asks for."""
        state.model.train()
        new, metrics = driver.step(self.driver_state(state), images, labels)
        self.commit(state, new)
        return metrics

    def stochastic_closure_step(self, state: TrainState, step_fn, images, labels):
        """One stochastic epoch of a closure optimizer: ``step_fn``
        (:func:`~.opt.closures.make_stochastic_closure_step`) runs the driver
        once per block of the staged rows, each block augmented once."""
        gen = self.generator(state.step)
        state.model.train()

        def blocks():
            for start, seg_images, seg_labels in self.segments(images, labels):
                for b in range(len(seg_images) // self.chunks):
                    block = self.block(seg_images, seg_labels, b, gen)
                    # every evaluation of this block draws the same masks
                    self.draw_seed = self.layer_seed(gen, start // self.chunks + b)
                    yield block

        new, metrics = step_fn(self.driver_state(state), blocks())
        self.commit(state, new)
        return metrics

    # -- evaluation ------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, model, images, labels, weights):
        """Weighted loss and accuracy over the staged validation blocks of
        every rank (resident, or :class:`HostRows` streamed in segments),
        each block in ``eval_chunks`` sub-chunks: this rank's sums, then one
        ``all_reduce``."""
        model.eval()
        sums = torch.zeros(3, dtype=self.stat_dtype, device=self.device)
        for start, seg_images, seg_labels in self.segments(images, labels):
            for row in range(len(seg_images)):
                block = torch.zeros(3, dtype=self.stat_dtype, device=self.device)
                piece = seg_images.shape[1] // self.eval_chunks
                for x, lbls, w in zip(seg_images[row].split(piece), seg_labels[row].split(piece),
                                      weights[start + row].split(piece)):
                    block += self._eval_sums(model, x, lbls, w)
                sums += block
        model.train()
        all_reduce(self.world, sums)
        return {"valid_loss": sums[0] / sums[2], "valid_acc": sums[1] / sums[2]}

    def _eval_sums(self, model, images, lbls, w):
        """``[weighted loss, weighted correct, weight]`` sums of some
        validation samples."""
        x = self._normalize(self.bundle.eval_transform(images))
        logits = self.forward(model, x)
        if self.cfg.hyp.test_time_flips:
            flipped = self.forward(model, x.flip(2))
            outputs = torch.softmax(logits, -1) + torch.softmax(flipped, -1)
        else:
            outputs = logits
        picked = torch.arange(lbls.shape[0], device=lbls.device)
        losses = -torch.log_softmax(outputs, -1)[picked, lbls]
        correct = (outputs.argmax(-1) == lbls).to(torch.float32) * w
        return torch.stack([(losses * w).sum(), correct.sum(), w.sum()]).to(self.stat_dtype)


class ClosureEvals:
    """The closure drivers' evaluation hook over a :class:`Trainer`
    (``fns`` of :mod:`.opt.closures`): ``gradient_eval`` is the modified
    full-batch gradient at ``state.params``, which it loads into the model;
    ``block_gradient_eval`` one block's gradient at them (the block's inputs
    prepared once by the caller), with the loss and accuracy summed and the
    running stats averaged over the ranks."""

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.schedule = trainer.schedule
        self.param_paths = jax_param_paths(trainer.model)
        self.world = trainer.world
        self.device = trainer.device

    def gradient_eval(self, state, images, labels):
        t = self.trainer
        t.load_params(state.params)
        grads, metrics, _ = t.gradient_eval(TrainState(state.step, t.model, None), images, labels)
        return grads, metrics

    def block_gradient_eval(self, state, x, labels):
        t = self.trainer
        params = [p.detach().requires_grad_() for p in state.params]
        grads, loss, correct, _ = t.block_grads(params, x, labels, t.schedule(state.step),
                                                reduce_stats=True)
        ranks = t.world.size
        return grads, {"train_loss": loss / ranks,
                       "train_acc": correct / (t.chunks * t.sub * ranks)}


def _to_host(metrics: dict) -> dict:
    """One device-to-host transfer for every metric of a step."""
    tensors = [v.reshape(-1).to(torch.float64) for v in metrics.values()
               if isinstance(v, torch.Tensor)]
    host = iter(torch.cat(tensors).tolist() if tensors else [])
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            values = [next(host) for _ in range(v.numel())]
            out[k] = values if k == "grad_norms_per_chunk" else values[0]
        else:
            out[k] = float(v)
    return out


def configure_backends(cfg) -> None:
    """cuDNN flags from ``impl.deterministic``/``impl.benchmark``; TF32 off for
    convolutions and matmuls, so float32 means float32 (bf16 speed comes from
    ``impl.mixed_precision``)."""
    torch.backends.cudnn.deterministic = bool(cfg.impl.get("deterministic", True))
    torch.backends.cudnn.benchmark = bool(cfg.impl.get("benchmark", False))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def train(model: nn.Module, bundle: DataBundle, cfg, device="cuda", stats=None,
          world: World | None = None):
    """Train ``model`` from its current weights per ``cfg.hyp``/``cfg.impl``,
    or from the checkpoint ``impl.checkpoint.name`` where one exists, as one
    rank of ``world`` (the default process group's by default; every rank
    starts from the same weights).

    Returns ``(state, stats)``: the final :class:`TrainState` and the stats
    dict of lists (the JAX package's keys, ``grad_norm_train_{i}`` per chunk
    or, in a stochastic step, per block, every rank's in rank-major order).
    Only rank 0 writes checkpoints; every rank resumes from the same file."""
    device = resolve_device(device)
    world = world if world is not None else current_world()
    check_slice(cfg)
    configure_backends(cfg)
    trainer = Trainer(model, bundle, cfg, device, world)
    optimizer, info = optim_interface(model, cfg.hyp)
    # one driver object for the run: its scratch spans full-batch and
    # stochastic steps, mode switches and resume
    driver = (make_closure_step(ClosureEvals(trainer), cfg, info["closure"])
              if info["closure"] is not None else None)
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       ema_model=copy.deepcopy(model) if cfg.hyp.evaluate_ema else None)
    file = writer = None
    if cfg.impl.checkpoint.name is not None:
        file = checkpoint_file(cfg)
        if world.rank == 0:
            writer = CheckpointWriter(file, bool(cfg.impl.checkpoint.get("async_save", False)))
        # rank 0 writes only after its first step's collectives, which every
        # rank enters after this load
        load_checkpoint(state, file, cfg.hyp.steps, driver)
    try:
        result = _train_loop(trainer, state, bundle, cfg, writer,
                             stats if stats is not None else defaultdict(list), driver)
    finally:
        if writer is not None:
            writer.close()
    if file is not None:
        barrier(world)  # the last checkpoint is on disk when train() returns, on every rank
    return result


def save_snapshot(trainer: Trainer, state: TrainState, grads, cfg):
    """``<name>_<model>_step_<step>.pt`` in the working directory: the model
    after the step, its pre-step gradient ``grads`` and its update direction
    (the SGD momentum buffers, ``g + momentum * buffer`` under Nesterov,
    None for an optimizer without them)."""
    from ..analysis.analysis import sgd_momentum

    update_directions = sgd_momentum(state.optimizer, trainer.params)
    if update_directions is not None and cfg.hyp.optim.get("nesterov", False):
        mu = float(cfg.hyp.optim.momentum)
        update_directions = [g + mu * m for g, m in zip(grads, update_directions)]
    return save_state_for_visualization(state, grads, update_directions, cfg,
                                        f"{cfg.name}_{cfg.model.name}_step_{state.step}.pt")


def _train_loop(trainer: Trainer, state: TrainState, bundle: DataBundle, cfg, writer, stats,
                driver=None):
    hyp = cfg.hyp
    stochastic_closure = make_stochastic_closure_step(driver) if driver is not None else None
    val_data = stage_validation(bundle, bundle.batch_size, trainer.device, dryrun=cfg.dryrun,
                                world=trainer.world, cfg_impl=cfg.impl)
    analysis = cfg.analysis
    if analysis.type is not None:
        from ..analysis import analyze
    reads_grads = analysis.type is not None and (analysis.get("measure_grad_norm", False)
                                                 or analysis.get("check_momentum", False))
    snapshot_every = analysis.get("save_model_every_nth_step")
    while state.step < hyp.steps:
        t0 = time.time()
        # the configured mode before hyp.train_switch_stochastic, the other
        # from it on (the JAX package's condition, not the reference's latch)
        stochastic = hyp.train_stochastic
        if hyp.train_switch_stochastic is not None and state.step >= hyp.train_switch_stochastic:
            stochastic = not hyp.train_stochastic
        images, labels = trainer.stage(state.step)
        # analysis and the snapshots read the gradient that produced the
        # step, so it is taken before the step when either is due after it
        snapshot_due = snapshot_every is not None and (state.step % snapshot_every == 0
                                                       or state.step + 1 >= hyp.steps)
        grads = None
        if snapshot_due or (reads_grads and ((state.step + 1) % analysis.check_every_nth_step
                                             == 0 or state.step + 1 >= hyp.steps or cfg.dryrun)):
            grads = trainer.pre_step_gradient(state, images, labels)
        if stochastic and (driver is None or trainer.sam_rho is not None):
            # SAM's stochastic epoch stays the fused one, as in the JAX package
            metrics = trainer.stochastic_step(state, images, labels)
        elif driver is not None:
            if stochastic:
                metrics = trainer.stochastic_closure_step(state, stochastic_closure, images,
                                                          labels)
            else:
                metrics = trainer.closure_step(state, driver, images, labels)
            trainer.ema_update(state)
        elif trainer.sam_rho is not None:
            metrics = trainer.sam_step(state, images, labels)
        else:
            metrics = trainer.full_step(state, images, labels)
        metrics = _to_host(metrics)
        step = state.step
        for k, v in metrics.items():
            if k == "grad_norms_per_chunk":
                for idx, entry in enumerate(v):
                    stats[f"grad_norm_train_{idx}"] += [entry]
            else:
                stats[k] += [v]
        stats["train_time"] += [time.time() - t0]

        eval_model = state.ema_model if state.ema_model is not None else state.model
        if ((step - 1) % cfg.impl.validate_every_nth_step == 0
                or step >= hyp.steps or cfg.dryrun):
            vm = _to_host(trainer.eval_step(eval_model, *val_data))
            stats["valid_loss"] += [vm["valid_loss"]]
            stats["valid_acc"] += [vm["valid_acc"]]

        log.info(status_message(stats, step))

        if analysis.type is not None and (step % analysis.check_every_nth_step == 0
                                          or step >= hyp.steps or cfg.dryrun):
            analyze(trainer, state, stats, grads=grads)

        if snapshot_due and trainer.world.rank == 0:
            save_snapshot(trainer, state, grads, cfg)

        # every rank reads the same reduced metrics, so all take one branch
        if not np.isfinite(stats["train_loss"][-1]):
            log.info("Terminating iterations due to divergence of loss...")
            break
        if hyp.stop_at_full_training_accuracy > 0:
            last_n = stats["train_acc"][-hyp.stop_at_full_training_accuracy:]
            if min(last_n) == 1:
                log.info("Terminating training after fitting all datapoints.")
                vm = _to_host(trainer.eval_step(eval_model, *val_data))
                stats["valid_loss"] += [vm["valid_loss"]]
                stats["valid_acc"] += [vm["valid_acc"]]
                if analysis.type is not None:
                    analyze(trainer, state, stats, grads=grads)
                break
        if cfg.impl.checkpoint.name is not None and (
                (step - 1) % cfg.impl.checkpoint.save_every_nth_step == 0 or step >= hyp.steps):
            # every rank: a sharded driver's state is gathered (a collective)
            driver_state = driver.get_state() if driver is not None else None
            if writer is not None:
                writer.save(state, driver_state)
        if cfg.dryrun:
            break
    return state, stats
