"""Custom layers, the stochastic layers' draws, and the loss functions
(``fullbatchtraining_tpu/models/modules.py``).

``Skipper`` (SkipInit's gain) and ``GhostBatchNorm`` hold their leaves
directly, with no inner flax module. Dropout and stochastic depth draw their
masks from the generator of the innermost :func:`layer_draws` block: the
trainer opens one per chunk (or block) with a seed derived from the step's
generator, and the regularizer's second pass over the chunk opens one with
the same seed, so both passes see the same masks, as the JAX package hands
both the chunk's key. A layer that draws in train mode outside such a block
raises, as a flax module without its rng does.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from ..ops import bn as bn_ops
from .layers import ema_, eval_affine, half_affine, stat_updates_on


class Skipper(nn.Module):
    """SkipInit scalar gain: ``x * alpha * gain``, ``alpha`` a 0-d param from 0."""

    def __init__(self, initial_scale: float = 0.0, gain: float = 0.2):
        super().__init__()
        self.gain = gain
        self.alpha = nn.Parameter(torch.tensor(float(initial_scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.alpha * self.gain).to(x.dtype)


class GhostBatchNorm(nn.Module):
    """Ghost batch normalization (the JAX package's ``GhostBatchNorm``, the
    reference's SequentialGhostNorm): the batch splits into ``num_chunks =
    max(N // virtual_batch_size, 1)`` virtual batches of ``ceil(N /
    num_chunks)`` samples, the last one possibly smaller; each is normalized
    with its own statistics and the shared ``weight``/``bias``, and the
    running stats fold sequentially, one EMA per virtual batch in order,
    each with torch's unbiased factor. Every virtual batch is a contiguous
    row range of the channels-last ``[M, C]`` view and runs
    ``ops.bn.bn_train``: one launch of each kernel per virtual batch. Eval
    mode runs the ``apply`` kernel from the running stats, as
    ``BatchNorm2d`` does."""

    jax_inner = None

    def __init__(self, channels: int, virtual_batch_size: int = 64, momentum: float = 0.9,
                 epsilon: float = 1e-5, scale_init: float = 1.0):
        super().__init__()
        self.channels = channels
        self.virtual_batch_size = virtual_batch_size
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def chunk_size(self, batch: int) -> int:
        return -(-batch // max(batch // self.virtual_batch_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = half_affine(x, self.weight, self.bias)
        if not self.training:
            return eval_affine(x, scale, bias, self.running_mean, self.running_var,
                               self.epsilon)
        rows = x.permute(0, 2, 3, 1)  # NHWC: contiguous when x is channels_last
        outs = []
        for part in rows.split(self.chunk_size(x.shape[0])):
            y, mean, var = bn_ops.bn_train(part, scale, bias, self.epsilon)
            outs.append(y)
            if stat_updates_on():
                n = part.numel() / self.channels
                ema_(self.running_mean, mean, self.momentum)
                ema_(self.running_var, var, self.momentum, n / max(n - 1, 1))
        return torch.cat(outs).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the stochastic layers' draws
# ---------------------------------------------------------------------------

_draw_seed: int | None = None
_generators: dict = {}


@contextlib.contextmanager
def layer_draws(seed: int | None):
    """Dropout and stochastic depth inside the block draw from fresh
    generators seeded ``seed`` (one a device), in the order the layers run."""
    global _draw_seed, _generators
    previous = _draw_seed, _generators
    _draw_seed, _generators = seed, {}
    try:
        yield
    finally:
        _draw_seed, _generators = previous


def _generator(device: torch.device) -> torch.Generator:
    if _draw_seed is None:
        raise RuntimeError("a stochastic layer in train mode draws outside layer_draws(seed)")
    if device not in _generators:
        _generators[device] = torch.Generator(device=device).manual_seed(_draw_seed)
    return _generators[device]


def keep_mask(shape, keep: float, like: torch.Tensor) -> torch.Tensor:
    """A Bernoulli(``keep``) mask of ``shape`` in ``like``'s dtype, drawn from
    the current :func:`layer_draws` block (all ones on the ``meta`` device,
    where only shapes count)."""
    if like.device.type == "meta":
        return torch.ones(shape, dtype=like.dtype, device=like.device)
    u = torch.rand(shape, generator=_generator(like.device), device=like.device)
    return (u < keep).to(like.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode, ``x * mask / keep``; rate 0 and
    eval mode pass ``x`` through."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        return x * keep_mask(x.shape, keep, x) / keep


def stochastic_depth(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """NFNet's stochastic depth: each sample's branch kept with probability
    ``1 - rate``, not rescaled; off outside ``0 < rate < 1`` and in eval mode."""
    if not training or not 0.0 < rate < 1.0:
        return x
    return x * keep_mask((x.shape[0], 1, 1, 1), 1.0 - rate, x)


def _smoothed_nll(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Per-sample label-smoothed cross-entropy: off-target weight
    smoothing/(C-1), target weight 1 - smoothing. Logits are promoted to at
    least float32 first (bf16 upcasts, float64 stays float64)."""
    log_prob = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    classes = logits.shape[-1]
    weight = torch.full_like(log_prob, smoothing / (classes - 1.0))
    weight[torch.arange(labels.shape[0], device=labels.device), labels] = 1.0 - smoothing
    return -(weight * log_prob).sum(dim=-1)


def label_smooth_cross_entropy(logits, labels, smoothing: float = 0.0):
    return _smoothed_nll(logits, labels, smoothing).mean()


def incorrect_cross_entropy(logits, labels, smoothing: float = 0.0):
    """Cross-entropy on the misclassified examples only, masked (not
    filtered), mean over the full batch."""
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    loss = _smoothed_nll(logits, labels, smoothing)
    return (loss * (1.0 - correct)).mean()


def maxup_loss(logits, labels, ntrials: int = 10):
    """Per group of ``ntrials`` augmented copies, the largest loss."""
    batch = logits.shape[0] // ntrials
    loss = _smoothed_nll(logits, labels, 0.0).reshape(batch, ntrials)
    return loss.max(dim=1).values.mean()


def get_loss_fn(cfg_hyp, batch_size=None) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Loss dispatch on ``hyp.loss_modification`` and ``hyp.label_smoothing``."""
    smoothing = float(cfg_hyp.label_smoothing or 0.0)
    modification = cfg_hyp.loss_modification
    if smoothing and modification is not None and modification != "incorrect-xent":
        raise ValueError(
            "Loss modification not implemented in conjunction with label smoothing.")

    if modification is None:
        def loss_fn(logits, labels):
            return label_smooth_cross_entropy(logits, labels, smoothing)
    elif modification == "incorrect-xent":
        def loss_fn(logits, labels):
            return incorrect_cross_entropy(logits, labels, smoothing)
    elif modification == "batch-maxup":
        if batch_size is None:
            raise ValueError("loss_modification=batch-maxup needs the batch size.")
        ntrials = int(batch_size)

        def loss_fn(logits, labels):
            return maxup_loss(logits, labels, ntrials)
    elif "maxup" in str(modification):
        spec = str(modification)
        ntrials = int(spec.split("maxup-")[1]) if "maxup-" in spec else 10

        def loss_fn(logits, labels):
            return maxup_loss(logits, labels, ntrials)
    else:
        raise ValueError(f"Invalid loss modification {modification}.")
    return loss_fn
