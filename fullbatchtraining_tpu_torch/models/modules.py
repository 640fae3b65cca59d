"""Loss functions on logits (``fullbatchtraining_tpu/models/modules.py``)."""

from __future__ import annotations

from typing import Callable

import torch


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
