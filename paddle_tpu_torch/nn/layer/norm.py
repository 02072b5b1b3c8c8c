"""LayerNorm and RMSNorm layers (counterpart of
``paddle_tpu/nn/layer/norm.py:15-49``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _no_attr, make_parameter

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """``F.layer_norm`` over the trailing ``normalized_shape`` axes:
    ``weight`` of ones and ``bias`` of zeros, each of that shape;
    ``weight_attr=False`` / ``bias_attr=False`` drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None, *, device="cuda", dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        for what, attr in (("weight_attr", weight_attr), ("bias_attr", bias_attr)):
            if attr is not False:
                _no_attr(attr, what)
        shape = self._normalized_shape
        self.weight = (None if weight_attr is False else
                       make_parameter(shape, "ones", device=device, dtype=dtype))
        self.bias = (None if bias_attr is False else
                     make_parameter(shape, "zeros", device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


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
