"""The system under test: the PyTorch port's training step, built as
``training.train`` builds it, on the benchmark's inputs.

The port composes its configuration from the repository's ``config/`` tree
with the cell's overrides; every setting the configuration file and the
traffic state is then checked against what the port resolved, so the port
runs as the cell says. The step the window drives is the body of the port's
training loop for a full-batch step: ``Trainer.stage``, ``Trainer.full_step``
and ``_to_host``, which copies the step's metrics to the host and so waits
for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs
from .cells import ROOT

# keys of a configuration file that are not settings of the port
_NOT_SETTINGS = ("name", "source", "reduced", "assumed", "architecture", "model", "data")


def settings(cell) -> dict:
    """Every dotted setting the cell states: its configuration's and its
    traffic's recipe."""
    out = {k: v for k, v in cell.config.items() if k not in _NOT_SETTINGS}
    out.update(cell.traffic["recipe"])
    return out


def overrides(cell, seed: int) -> list[str]:
    out = [f"model={cell.config['model']}", f"data={cell.config['data']}"]
    out += list(cell.traffic["groups"])
    for key, value in settings(cell).items():
        if not isinstance(value, (dict, list)):
            out.append(f"{key}={'' if value is None else value}")
    return out + [f"seed={int(seed)}", "name=portbench"]


def resolved(cfg, key: str):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def check_settings(cfg, wanted: dict) -> None:
    """Raise where the port resolved a setting otherwise than the cell states."""
    wrong = {}
    for key, value in wanted.items():
        got = resolved(cfg, key)
        if isinstance(value, list):
            got = list(got)
        same = (got == value if not isinstance(value, float)
                else got is not None and float(got) == value)
        if not same:
            wrong[key] = (value, got)
    if wrong:
        raise ValueError(f"the port resolved settings otherwise than the cell states "
                         f"(stated, resolved): {wrong}")


class Program:
    """One run of the port: its ``Trainer`` and ``TrainState`` at the
    benchmark's initial weights, and the step of its training loop."""

    def __init__(self, cell, seed: int, device):
        from fullbatchtraining_tpu_torch.config import load_config
        from fullbatchtraining_tpu_torch.data.augmentations import (make_augment_fn,
                                                                   make_eval_transform)
        from fullbatchtraining_tpu_torch.data.datasets import ArrayDataset
        from fullbatchtraining_tpu_torch.data.pipeline import DataBundle
        from fullbatchtraining_tpu_torch.models import construct_model
        from fullbatchtraining_tpu_torch.training import training
        from fullbatchtraining_tpu_torch.training.optimizers import optim_interface

        self.training = training
        cfg = load_config(ROOT / "config", overrides=overrides(cell, seed))
        check_settings(cfg, settings(cell))
        if cfg.hyp.train_stochastic or cfg.hyp.optim_modification.name != "none":
            raise ValueError("the benchmark drives the full-batch step alone")
        self.cfg, self.device = cfg, torch.device(device)
        images, labels = inputs.images_and_labels(cell.config, seed, self.device)
        images, labels = images.cpu().numpy(), labels.cpu().numpy()
        data = cfg.data
        bundle = DataBundle(
            train=ArrayDataset(images, labels, data.classes),
            valid=ArrayDataset(images[:1], labels[:1], data.classes),   # never evaluated
            augment=make_augment_fn(data.augmentations_train),
            eval_transform=make_eval_transform(data.augmentations_val),
            mean=np.asarray(data.mean, np.float32), std=np.asarray(data.std, np.float32),
            normalize=bool(data.normalize), classes=data.classes, channels=data.channels,
            pixels=data.pixels, batch_size=int(data.batch_size), name=data.name)
        model = construct_model(cfg.model, bundle.channels, bundle.classes, seed=cfg.seed,
                                pixels=bundle.pixels)
        training.configure_backends(cfg)
        self.trainer = training.Trainer(model, bundle, cfg, self.device)
        optimizer, info = optim_interface(model, cfg.hyp)
        if info["closure"] is not None:
            raise ValueError("the benchmark drives a per-step optimizer alone")
        self.state = training.TrainState(step=0, model=model, optimizer=optimizer)
        self.initial = inputs.weights(cell.config, seed, self.device)
        names = dict(model.named_parameters())
        if set(names) != set(self.initial):
            raise ValueError(f"parameters differ from the configuration's: "
                             f"{sorted(set(names) ^ set(self.initial))[:8]}")
        with torch.no_grad():
            for name, p in names.items():
                p.copy_(self.initial[name])
        self.weight_decay = float(cfg.hyp.optim.weight_decay)

    def step(self) -> dict:
        """One step of the training loop; returns its metrics on the host."""
        images, labels = self.trainer.stage(self.state.step)
        metrics = self.trainer.full_step(self.state, images, labels)
        return self.training._to_host(metrics)

    @torch.no_grad()
    def first_gradient_norms(self) -> dict:
        """After the first step: each parameter's gradient as the optimizer
        took it, ``momentum buffer - weight_decay * initial weight``, by its
        norm (0 where the optimizer holds no buffer)."""
        state = self.state.optimizer.state
        out = {}
        for name, p in self.state.model.named_parameters():
            buf = state.get(p, {}).get("momentum_buffer")
            out[name] = (0.0 if buf is None else
                         float((buf.double() - self.weight_decay * self.initial[name].double())
                               .norm()))
        return out

    @torch.no_grad()
    def change_norms(self) -> dict:
        """Each parameter's change since the initial weights, by its norm."""
        return {name: float((p.double() - self.initial[name].double()).norm())
                for name, p in self.state.model.named_parameters()}

    @torch.no_grad()
    def stats_norms(self) -> dict:
        """Each running statistic's change since its initial value (mean 0,
        variance 1), by its norm."""
        return {name: float((b.double() - (1.0 if name.endswith("running_var") else 0.0)).norm())
                for name, b in self.state.model.named_buffers()
                if name.endswith(("running_mean", "running_var"))}
