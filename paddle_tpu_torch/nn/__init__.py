"""nn of the port (counterpart of ``paddle_tpu/nn``): ``Layer`` and the
layers (``torch.nn.Module``s with Paddle's methods, parameter names and
layouts), ``ParamAttr`` and the initializers, functionals on torch
tensors, the gradient clippers, and weight-only quantization
(``nn.quant``)."""

from . import functional, initializer, quant
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_
from .layer import *  # noqa: F403
from .layer import __all__ as _layers
from .param_attr import ParamAttr

__all__ = ["functional", "initializer", "quant", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "ParamAttr", *_layers]
