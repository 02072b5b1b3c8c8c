"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""

from . import fused_step, lr
from .algorithms import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars, Momentum,
                         RMSProp)
from .optimizer import Optimizer

__all__ = ["fused_step", "lr", "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb", "Lars", "Optimizer"]
