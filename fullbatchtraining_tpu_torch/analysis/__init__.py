"""Analysis of the model's state during training (``analysis=full|limited|final``)."""

from .analysis import analyze

__all__ = ["analyze"]
