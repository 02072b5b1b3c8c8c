"""LayerNorm, RMSNorm and the batch norms (counterpart of
``paddle_tpu/nn/layer/norm.py:15-118``)."""

from __future__ import annotations

import torch

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm"]


class LayerNorm(Layer):
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
        shape = self._normalized_shape
        self.weight = self.create_parameter(shape, weight_attr, dtype,
                                            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(shape, bias_attr, dtype, is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    """The Llama norm: ``weight [hidden]`` of ones, ``F.rms_norm``."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter((hidden_size,), weight_attr, dtype,
                                            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    """``F.batch_norm`` with ``weight`` of ones and ``bias`` of zeros
    ``[num_features]`` (``weight_attr=False`` / ``bias_attr=False`` drop
    them) and the running statistics as the buffers ``_mean`` (zeros) and
    ``_variance`` (ones), f32, the reference's names: no
    ``num_batches_tracked`` as ``torch.nn.BatchNorm2d`` would add.
    ``momentum`` is Paddle's (the running statistics keep that share)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        shape = (num_features,)
        self.weight = self.create_parameter(shape, weight_attr, dtype,
                                            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(shape, bias_attr, dtype, is_bias=True, device=device)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(shape, device=dev))
        self.register_buffer("_variance", torch.ones(shape, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    """``data_format`` "NCDHW" normalises axis 1, as "NCHW" does."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None, *,
                 device="cuda", dtype=torch.float32):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format == "NCDHW" else data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """``paddle.nn.SyncBatchNorm``: in one process, the local batch's
    statistics (world size 1)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm under it (itself included) replaced
        by a ``SyncBatchNorm`` holding the same weight, bias and running
        statistics (the same tensors), as the reference's
        (``norm.py:99-118``: momentum, epsilon and data format carried,
        ``use_global_stats`` not)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            w = layer.weight if layer.weight is not None else layer._mean
            new = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                data_format=layer._data_format, device=w.device, dtype=w.dtype)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer
