"""Full-batch training steps in plain PyTorch, from the recipe's description
(Geiping et al. 2022, arXiv:2109.14119, and the upstream project's
``hyp`` settings).

One step at step counter ``s``:

1. Lay the training set out in order, dropping the rows past the last whole
   block of ``batch_size``, in chunks of ``sub_batch``.
2. For each chunk, in order: random crop (zero padding) and horizontal flip
   drawn from the step's generator, seeded ``seed * 1_000_003 + s``: per
   chunk the row offsets, the column offsets (each uniform over the padded
   range) and the flips (uniform below ``p``). Normalise with the data
   set's mean and std. Forward in train mode (the running statistics move
   once a chunk), mean cross-entropy, its gradient.
3. With a gradient-norm penalty of strength ``block_strength``: add the
   forward-difference Hessian-vector product ``(lr / 4) (g(w + e v) -
   g(w)) / e`` along ``v = block_strength * g``, ``e = eps / |v|``; the
   second gradient sees the chunk's own batch statistics and moves no
   running statistic.
4. Average the chunk gradients; clip the average to ``grad_clip`` in the
   2-norm (scale ``grad_clip / (norm + 1e-6)`` where the norm is larger).
5. SGD with coupled weight decay, momentum and Nesterov: ``d = g + wd w``;
   ``m = d`` on the first step, else ``m = mu m + (1 - dampening) d``;
   ``w -= lr (d + mu m)``.

The learning rate follows the recipe's schedule: linear warmup from 0 over
``warmup`` steps, then cosine decay to 0 over ``steps`` (``cosine-decay``)
or over 4000 steps (``cosine-4000``). Everything is float32 (``dtype``)
with TF32 off, unless a control asks for a lower precision
(:mod:`.precision`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..cells import family
from . import precision as precision_mod

FAULTS = (None, "half", "no_penalty")


def learning_rate(recipe: dict, step: int) -> float:
    base, warmup = float(recipe["hyp.optim.lr"]), int(recipe["hyp.warmup"])
    name = recipe["hyp.scheduler"]
    if name == "cosine-decay":
        period = int(recipe["hyp.steps"])
    elif name == "cosine-4000":
        period = 4000
    else:
        raise ValueError(f"the reference has no schedule {name!r}")
    if warmup > 0:
        if step < warmup:
            return base * step / warmup
        step = max(step - warmup - 1, 0)
    return 0.5 * base * (1 + math.cos(math.pi * step / period))


def crop_flip(images: torch.Tensor, generator: torch.Generator, size: int, pad: int,
              flip_p: float) -> torch.Tensor:
    """uint8 NHWC ``images`` cropped and flipped from ``generator``'s draws."""
    b, h, w, _ = images.shape
    dev = images.device
    oy = torch.randint(0, h + 2 * pad - size + 1, (b,), generator=generator, device=dev)
    ox = torch.randint(0, w + 2 * pad - size + 1, (b,), generator=generator, device=dev)
    flip = torch.rand((b,), generator=generator, device=dev) < flip_p
    padded = torch.zeros((b, h + 2 * pad, w + 2 * pad, images.shape[3]), dtype=images.dtype,
                         device=dev)
    padded[:, pad:pad + h, pad:pad + w] = images
    idx = torch.arange(size, device=dev)
    rows = (oy[:, None] + idx)[:, :, None].expand(b, size, size)
    cols = ox[:, None] + idx
    cols = torch.where(flip[:, None], cols.flip(1), cols)[:, None, :].expand(b, size, size)
    n = torch.arange(b, device=dev)[:, None, None].expand(b, size, size)
    return padded[n, rows, cols]


class ReferenceTraining:
    """The steps of one run: parameters, running statistics and momentum from
    the benchmark's initial values, on the benchmark's images and labels.

    ``precision`` (:mod:`.precision`: ``float32``, ``tf32``, ``bf16``,
    ``fp8``, ``bf16split``) computes in a lower precision, for a control or a
    look. A ``fault`` plants a fault of the program in the reference, for
    the check that it is caught: ``"half"`` trains each chunk on its first
    half only, the mean taken over it; ``"no_penalty"`` leaves the
    gradient penalty out."""

    def __init__(self, config: dict, recipe: dict, images: torch.Tensor, labels: torch.Tensor,
                 params: dict, seed: int, precision: str = "float32", fault: str | None = None,
                 dtype: torch.dtype = torch.float32):
        if precision not in precision_mod.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.recipe, self.seed, self.fault = recipe, int(seed), fault
        self.device = images.device
        self.family = family(config)
        self.plan = self.family.architecture(config)
        self.dtype = dtype
        self.params = {k: v.detach().to(dtype, copy=True).requires_grad_()
                       for k, v in params.items()}
        self.stats = {k: v.to(dtype)
                      for k, v in self.family.initial_stats(self.plan, self.device).items()}
        # float32 means float32: no TF32 in convolutions or products
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.momentum = None
        self.conv, self.linear, self.act, self.norm = precision_mod.layer_functions(precision)
        crop = config["data.augmentations_train"]
        self.crop_size, self.pad = crop["RandomCrop"]
        self.flip_p = float(crop["RandomHorizontalFlip"])
        self.mean = torch.tensor(config["data.mean"], device=self.device, dtype=dtype)
        self.std = torch.tensor(config["data.std"], device=self.device, dtype=dtype)
        batch, sub = int(recipe["data.batch_size"]), int(recipe["hyp.sub_batch"])
        rows = (len(images) // batch) * batch
        self.images = images[:rows].reshape(-1, sub, *images.shape[1:])
        self.labels = labels[:rows].reshape(-1, sub)

    def loss(self, params, x, labels, update_stats):
        logits = self.family.forward(self.plan, params, self.stats, x, update_stats, self.conv,
                                     self.linear, self.act, self.norm)
        return F.cross_entropy(logits, labels)

    def gradient(self, params, x, labels, update_stats):
        names = list(params)
        loss = self.loss(params, x, labels, update_stats)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, list(params.values()))))

    def chunk_gradient(self, x, labels, lr):
        """The chunk's loss, its gradient after the penalty, and the norm of
        its gradient before it."""
        loss, g = self.gradient(self.params, x, labels, True)
        norm = torch.sqrt(sum(t.double().square().sum() for t in g.values()))
        strength = (0.0 if self.fault == "no_penalty"
                    else float(self.recipe["hyp.grad_reg.block_strength"]))
        if strength:
            v = {k: strength * t for k, t in g.items()}
            e = float(self.recipe["hyp.grad_reg.eps"]) / torch.sqrt(
                sum(t.square().sum() for t in v.values()))
            with torch.no_grad():
                moved = {k: (self.params[k] + e * v[k]).requires_grad_() for k in self.params}
            _, offset = self.gradient(moved, x, labels, False)
            g = {k: g[k] + lr / 4 * (offset[k] - g[k]) / e for k in g}
        return loss, g, norm

    def step(self, step: int):
        """One step; returns the mean chunk loss, the clipped gradient and
        each chunk's gradient norm."""
        lr = learning_rate(self.recipe, step)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + step) % 2**64)
        total = {k: torch.zeros_like(p) for k, p in self.params.items()}
        losses, norms = [], []
        for chunk, labels in zip(self.images, self.labels):
            chunk = crop_flip(chunk, gen, self.crop_size, self.pad, self.flip_p)
            if self.fault == "half":
                chunk, labels = chunk[:len(chunk) // 2], labels[:len(labels) // 2]
            x = ((chunk.to(self.dtype) / 255.0 - self.mean) / self.std).permute(0, 3, 1, 2)
            if self.act is not None:
                x = self.act(x)
            loss, g, norm = self.chunk_gradient(x.contiguous(), labels, lr)
            losses.append(loss)
            norms.append(norm)
            for k in total:
                total[k] += g[k]
        grad = {k: t / len(self.images) for k, t in total.items()}
        clip = self.recipe["hyp.grad_clip"]
        if clip is not None:
            norm = torch.sqrt(sum(t.square().sum() for t in grad.values()))
            scale = torch.where(norm > clip, clip / (norm + 1e-6), torch.ones_like(norm))
            grad = {k: t * scale for k, t in grad.items()}
        self.sgd(grad, lr)
        return float(torch.stack(losses).mean()), grad, torch.stack(norms).tolist()

    @torch.no_grad()
    def sgd(self, grad, lr):
        wd = float(self.recipe["hyp.optim.weight_decay"])
        mu = float(self.recipe["hyp.optim.momentum"])
        damp = float(self.recipe["hyp.optim.dampening"])
        nesterov = bool(self.recipe["hyp.optim.nesterov"])
        d = {k: grad[k] + wd * self.params[k] for k in grad}
        if self.momentum is None:
            self.momentum = {k: t.clone() for k, t in d.items()}
        else:
            self.momentum = {k: mu * self.momentum[k] + (1 - damp) * d[k] for k in d}
        for k, p in self.params.items():
            p -= lr * (d[k] + mu * self.momentum[k] if nesterov else self.momentum[k])
