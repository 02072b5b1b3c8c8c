"""RMSNorm layer (counterpart of ``paddle_tpu/nn/layer/norm.py:36``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _no_attr, make_parameter

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """The Llama norm: ``weight [hidden]`` of ones, ``F.rms_norm``."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        _no_attr(weight_attr, "weight_attr")
        self._epsilon = epsilon
        self.weight = make_parameter((hidden_size,), "ones", device=device, dtype=dtype)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
