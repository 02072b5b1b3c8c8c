"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``), with
Paddle's parameter names and layouts: ``weight [out, in/groups, *k]`` (a
transpose's ``[in, out/groups, *k]``) and ``bias [out]``."""

from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


class _ConvNd(Layer):
    """The reference's ``_ConvNd`` (``conv.py:17-49``): the weight drawn
    Kaiming-uniform with ``negative_slope = sqrt(5)``, that is uniform in
    ``+-1/sqrt(fan_in)``, and the bias uniform in the same bound, both from
    ``generator``, unless ``weight_attr`` / ``bias_attr`` say otherwise;
    ``bias_attr=False`` drops the bias."""

    _spatial = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, self._spatial)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        shape = ((in_channels, out_channels // groups) if self._transpose
                 else (out_channels, in_channels // groups)) + self._kernel_size
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        kw = dict(default_initializer=I.Uniform(-bound, bound), device=device,
                  generator=generator)
        self.weight = self.create_parameter(shape, weight_attr, dtype, **kw)
        self.bias = self.create_parameter((out_channels,), bias_attr, dtype, is_bias=True, **kw)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}")


class _Conv(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None, *, device="cuda", dtype=torch.float32, generator=None):
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r}: the reference pads "
                                      "with zeros only")
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, 0, dilation,
                         groups, weight_attr, bias_attr, data_format or self._format,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self._functional(x, self.weight, self.bias, self._stride, self._padding,
                                self._dilation, self._groups, self._data_format)


class _ConvTranspose(_ConvNd):
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format=None, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, dilation, groups, weight_attr, bias_attr,
                         data_format or self._format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x, output_size=None):
        return self._functional(x, self.weight, self.bias, self._stride, self._padding,
                                self._output_padding, self._groups, self._dilation,
                                output_size, self._data_format)


class Conv1D(_Conv):
    _spatial, _format, _functional = 1, "NCL", staticmethod(F.conv1d)


class Conv2D(_Conv):
    _spatial, _format, _functional = 2, "NCHW", staticmethod(F.conv2d)


class Conv3D(_Conv):
    _spatial, _format, _functional = 3, "NCDHW", staticmethod(F.conv3d)


class Conv1DTranspose(_ConvTranspose):
    """Takes ``groups`` before ``dilation``, as Paddle's does."""

    _spatial, _format, _functional = 1, "NCL", staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL", *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, dilation, groups, weight_attr, bias_attr, data_format,
                         device=device, dtype=dtype, generator=generator)


class Conv2DTranspose(_ConvTranspose):
    _spatial, _format, _functional = 2, "NCHW", staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvTranspose):
    _spatial, _format, _functional = 3, "NCDHW", staticmethod(F.conv3d_transpose)
