"""nn of the port (counterpart of ``paddle_tpu/nn``): layers as
``torch.nn.Module``s with Paddle's parameter names and layouts, functionals
on torch tensors, the gradient clippers, and weight-only quantization
(``nn.quant``)."""

from . import functional, quant
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "quant", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "Linear", "RMSNorm"]
