"""Checkpoints of the train state (``fullbatchtraining_tpu/training/utils.py``).

A checkpoint is ``<original_cwd>/checkpoints/<impl.checkpoint.name>``, the
JAX package's place, so a resumed job with the same name finds it. It holds
``torch.save`` of

    {"step": int, "model": state_dict, "optimizer": state_dict or None,
     "ema_model": state_dict or None[, "driver": driver state]}

with every tensor on the CPU, and loads with ``torch.load(weights_only=True)``
(no pickled code). The lr schedule is a function of the step, so it needs no
state. A closure optimizer's driver (line-search loss windows, FISTA's lr,
``t_k`` and ``x_prev``, L-BFGS's curvature memory) rides in the same file
under ``"driver"``, so it is on disk exactly when the checkpoint it belongs
to is, async writes included, and is restored when a run resumes. Writes are
atomic: a temporary file, then a rename.

``impl.checkpoint.async_save`` moves the copy to the host and the write to one
writer thread, one write in flight. ``torch.optim`` and BatchNorm update
params and buffers in place, so the step after a save would overwrite what
the thread reads: the snapshot is a clone on the device, taken before the save
returns (the port's counterpart of the JAX package's donation safety).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch

log = logging.getLogger(__name__)


def checkpoint_file(cfg) -> Path:
    folder = Path(cfg.get("original_cwd", os.getcwd())) / "checkpoints"
    folder.mkdir(parents=True, exist_ok=True)
    return folder / str(cfg.impl.checkpoint.name)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def state_payload(state, driver_state=None) -> dict:
    """The checkpoint's dict of ``state`` (a ``TrainState``) and a closure
    driver's ``get_state()``; its tensors are the state's own, not copies."""
    payload = {"step": int(state.step), "model": state.model.state_dict(),
               "optimizer": None if state.optimizer is None else state.optimizer.state_dict(),
               "ema_model": None if state.ema_model is None else state.ema_model.state_dict()}
    if driver_state is not None:
        payload["driver"] = driver_state
    return payload


def write_checkpoint(payload: dict, file: Path) -> None:
    """``torch.save`` of ``payload`` with its tensors on the CPU, written to
    ``<file>.<pid>.tmp`` and renamed onto ``file``."""
    # with_name, not with_suffix, which would replace a dotted name's last part
    tmp = file.with_name(f"{file.name}.{os.getpid()}.tmp")
    torch.save(_tree_map(lambda t: t.detach().cpu(), payload), tmp)
    tmp.replace(file)


class CheckpointWriter:
    """Saves a ``TrainState`` to ``file``, at once or (``async_save``) on one
    writer thread with one write in flight. :meth:`close` waits for the last
    write and re-raises its error."""

    def __init__(self, file: Path, async_save: bool = False):
        self.file = Path(file)
        self.async_save = async_save
        self._pool: ThreadPoolExecutor | None = None
        self._pending: Future | None = None

    def save(self, state, driver_state=None) -> Path:
        # the older write lands first and never shares the temporary file
        self.wait()
        payload = state_payload(state, driver_state)
        if not self.async_save:
            write_checkpoint(payload, self.file)
            return self.file
        snapshot = _tree_map(lambda t: t.detach().clone(), payload)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-write")
        self._pending = self._pool.submit(write_checkpoint, snapshot, self.file)
        return self.file

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


def load_checkpoint(state, file: Path, max_steps: int, driver=None) -> int:
    """Fill ``state`` (model, optimizer, EMA model) and ``driver`` (a closure
    optimizer's) from ``file`` and return its step: 0, and ``state``
    untouched, where there is no file. Raises ``ValueError`` when the
    checkpoint has reached ``max_steps``."""
    file = Path(file)
    if not file.exists():
        log.info("No existing checkpoint found. Starting to train from step 0.")
        return 0
    payload = torch.load(file, map_location="cpu", weights_only=True)
    step = int(payload["step"])
    if step >= max_steps:
        raise ValueError("Maximum step size reached. Terminating computations.")
    state.model.load_state_dict(payload["model"])
    if state.optimizer is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    if state.ema_model is not None:
        state.ema_model.load_state_dict(payload["ema_model"])
    if driver is not None and step > 0 and payload.get("driver") is not None:
        driver.set_state(payload["driver"])
        log.info("Closure-optimizer driver state restored from %s.", file.name)
    state.step = step
    log.info("Existing checkpoint loaded successfully. Continuing from step %d.", step)
    return step
