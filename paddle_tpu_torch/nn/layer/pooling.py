"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py:1-128``):
each calls its functional with the arguments it was built with."""

from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D"]


class _Pool(Layer):
    def __init__(self, kernel_size, stride, padding, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def forward(self, x):
        return self._functional(x, self.kernel_size, self.stride, self.padding, **self.kw)

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}, padding={self.padding}"


class MaxPool1D(_Pool):
    _functional = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 data_format="NCL", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool2D(_Pool):
    _functional = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    _functional = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
                 data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    _functional = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
                 data_format="NCL", name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool2D(_Pool):
    """``divisor_override`` is taken and ignored, as in the reference."""

    _functional = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)


class AvgPool3D(_Pool):
    """``divisor_override`` is taken and ignored, as in the reference."""

    _functional = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 divisor_override=None, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)


class _Adaptive(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return self._functional(x, self.output_size, **self.kw)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_Adaptive):
    _functional = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Adaptive):
    _functional = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format=data_format)


class AdaptiveAvgPool3D(_Adaptive):
    _functional = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format=data_format)


class AdaptiveMaxPool1D(_Adaptive):
    _functional = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)


class AdaptiveMaxPool2D(_Adaptive):
    _functional = staticmethod(F.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)


class AdaptiveMaxPool3D(_Adaptive):
    _functional = staticmethod(F.adaptive_max_pool3d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)
