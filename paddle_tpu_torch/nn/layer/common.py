"""Linear, Embedding and the dropout layers (counterpart of
``paddle_tpu/nn/layer/common.py``), with Paddle's parameter names, layouts
and initializers, drawn from an explicit ``torch.Generator``.

A dropout layer draws its masks from the ``generator`` it was given (None:
torch's default generator of the device). A model hands every dropout
layer one generator that it owns, so its layers draw different masks from
one stream, as the reference's draw from its one global key.
``copy.deepcopy`` clones a generator with its state, and clones would
repeat each other's masks: ``nn.layer.transformer`` copies layers with
their generators shared (``clones``)."""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "make_parameter"]


def make_parameter(shape, init, *, device, dtype, generator=None, bound=None):
    """A trainable parameter: ``"xavier"`` uniform over
    ``+-sqrt(6 / (fan_in + fan_out))`` of a 2-D ``[in, out]`` shape,
    ``"uniform"`` over ``+-bound``, ``"normal"`` N(0, 1), ``"ones"`` or
    ``"zeros"``."""
    w = torch.empty(shape, device=resolve_device(device), dtype=dtype)
    if init == "xavier":
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5
        w.uniform_(-bound, bound, generator=generator)
    elif init == "uniform":
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


class Dropout(nn.Module):
    """``F.dropout`` with this layer's ``p``, ``axis`` and ``mode``, in
    training mode only as the module's ``training`` says."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(nn.Module):
    """``F.dropout2d``: whole channels of a 4-D input."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(nn.Module):
    """``F.dropout3d``: whole channels of a 5-D input."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(nn.Module):
    """``F.alpha_dropout``, for SELU networks."""

    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training, generator=self.generator)
