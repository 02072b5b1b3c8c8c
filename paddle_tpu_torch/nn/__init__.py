"""nn of the port (counterpart of ``paddle_tpu/nn``): layers as
``torch.nn.Module``s with Paddle's parameter names and layouts, functionals
on torch tensors, and the gradient clippers."""

from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "Linear", "RMSNorm"]
