"""nn of the port (counterpart of ``paddle_tpu/nn``): layers as
``torch.nn.Module``s with Paddle's parameter names and layouts, functionals
on torch tensors, the gradient clippers, and weight-only quantization
(``nn.quant``)."""

from . import functional, quant
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .layer import *  # noqa: F403
from .layer import __all__ as _layers

__all__ = ["functional", "quant", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", *_layers]
