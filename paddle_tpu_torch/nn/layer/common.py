"""Linear, Embedding and the dropout layers (counterpart of
``paddle_tpu/nn/layer/common.py``), with Paddle's parameter names, layouts
and initializers. Each parameter comes from ``Layer.create_parameter``:
its ``weight_attr`` / ``bias_attr``, else the global initializer, else the
layer's default, drawn from the ``generator`` given (None: the port's
generator of the device, which ``paddle_tpu_torch.seed`` reseeds).

A dropout layer draws its masks from the ``generator`` it was given (None:
the port's generator of the device). A model hands every dropout
layer one generator that it owns, so its layers draw different masks from
one stream, as the reference's draw from its one global key.
``copy.deepcopy`` clones a generator with its state, and clones would
repeat each other's masks: ``nn.layer.transformer`` copies layers with
their generators shared (``clones``)."""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"]


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight [in, out]`` Xavier-uniform and
    ``bias [out]`` zeros unless ``weight_attr`` / ``bias_attr`` say
    otherwise; ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter((in_features, out_features), weight_attr, dtype,
                                            device=device, generator=generator)
        self.bias = self.create_parameter((out_features,), bias_attr, dtype, is_bias=True,
                                          device=device, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """``weight [num_embeddings, embedding_dim]`` drawn N(0, 1); the row of
    ``padding_idx`` starts at zero and is looked up as zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter((num_embeddings, embedding_dim), weight_attr, dtype,
                                            default_initializer=I.Normal(), device=device,
                                            generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx, sparse=self._sparse)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
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


class Dropout2D(Layer):
    """``F.dropout2d``: whole channels of a 4-D input."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Layer):
    """``F.dropout3d``: whole channels of a 5-D input."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(Layer):
    """``F.alpha_dropout``, for SELU networks."""

    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training, generator=self.generator)
