"""Linear and Embedding layers (counterpart of
``paddle_tpu/nn/layer/common.py``), with Paddle's parameter names, layouts
and initializers, drawn from an explicit ``torch.Generator``."""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ["Linear", "Embedding", "make_parameter"]


def make_parameter(shape, init, *, device, dtype, generator=None):
    """A trainable parameter: ``"xavier"`` uniform over
    ``+-sqrt(6 / (fan_in + fan_out))`` of a 2-D ``[in, out]`` shape,
    ``"normal"`` N(0, 1), ``"ones"`` or ``"zeros"``."""
    w = torch.empty(shape, device=resolve_device(device), dtype=dtype)
    if init == "xavier":
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5
        w.uniform_(-bound, bound, generator=generator)
    elif init == "normal":
        w.normal_(0.0, 1.0, generator=generator)
    elif init == "ones":
        w.fill_(1.0)
    elif init == "zeros":
        w.zero_()
    else:
        raise ValueError(f"unknown initializer {init!r}")
    return nn.Parameter(w)


def _no_attr(attr, what):
    if attr is not None:
        raise NotImplementedError(f"{what} (ParamAttr) comes with a later slice of the "
                                  "port; pass None")


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in, out]`` Xavier-uniform and
    ``bias [out]`` zeros; ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        _no_attr(weight_attr, "weight_attr")
        if bias_attr is not False:
            _no_attr(bias_attr, "bias_attr")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = make_parameter((in_features, out_features), "xavier", device=device,
                                     dtype=dtype, generator=generator)
        self.bias = (None if bias_attr is False else
                     make_parameter((out_features,), "zeros", device=device, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """``weight [num_embeddings, embedding_dim]`` drawn N(0, 1); the row of
    ``padding_idx`` starts at zero and is looked up as zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        _no_attr(weight_attr, "weight_attr")
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = make_parameter((num_embeddings, embedding_dim), "normal",
                                     device=device, dtype=dtype, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx, sparse=self._sparse)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"
