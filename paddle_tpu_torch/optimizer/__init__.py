"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""

from . import lr
from .algorithms import SGD, Adam, AdamW
from .optimizer import Optimizer

__all__ = ["lr", "SGD", "Adam", "AdamW", "Optimizer"]
