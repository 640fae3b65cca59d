"""Model zoo of the port: ResNets on the port's BatchNorm kernels."""

from .models import construct_model
from .modules import (get_loss_fn, incorrect_cross_entropy, label_smooth_cross_entropy,
                      maxup_loss)

__all__ = ["construct_model", "get_loss_fn", "label_smooth_cross_entropy",
           "incorrect_cross_entropy", "maxup_loss"]
