"""Training of the port: the full-batch step, schedules and SGD."""

from .optimizers import make_lr_schedule, make_optimizer
from .training import TrainState, Trainer, train

__all__ = ["TrainState", "Trainer", "train", "make_lr_schedule", "make_optimizer"]
