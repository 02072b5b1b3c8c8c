"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``) as
``torch.nn.Module``s."""

from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm"]
