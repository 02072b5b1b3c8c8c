"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each calls the functional of the same name with the arguments it was
built with."""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _no_attr, make_parameter

__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Mish", "Hardswish", "Hardsigmoid",
           "Softsign", "Tanhshrink", "LogSigmoid", "GLU", "GELU", "LeakyReLU", "ELU", "CELU",
           "SELU", "PReLU", "RReLU", "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
           "Maxout", "Softmax", "LogSoftmax", "Swish", "ThresholdedReLU"]


def _layer(cls_name, fn, doc, **params):
    """A layer class whose forward is ``fn(x, **kwargs)``: ``params`` (the
    functional's keywords, in its order, with their defaults) taken
    positionally or by name at construction."""
    names = tuple(params)

    def __init__(self, *args, name=None, **kw):
        nn.Module.__init__(self)
        unknown = sorted(set(kw) - set(names))
        if len(args) > len(names) or unknown:
            raise TypeError(f"{cls_name} takes {names}, got {len(args)} positional and "
                            f"{unknown}")
        self._kw = {**params, **dict(zip(names, args)), **kw}

    def forward(self, x):
        return fn(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    return type(cls_name, (nn.Module,), {"__init__": __init__, "forward": forward,
                                         "extra_repr": extra_repr, "__doc__": doc,
                                         "__module__": __name__})


ReLU = _layer("ReLU", F.relu, "``F.relu``.")
ReLU6 = _layer("ReLU6", F.relu6, "``F.relu6``.")
Sigmoid = _layer("Sigmoid", F.sigmoid, "``F.sigmoid``.")
Tanh = _layer("Tanh", F.tanh, "``F.tanh``.")
Silu = _layer("Silu", F.silu, "``F.silu``.")
Swish = _layer("Swish", F.silu, "``F.silu``.")
Mish = _layer("Mish", F.mish, "``F.mish``.")
Hardswish = _layer("Hardswish", F.hardswish, "``F.hardswish``.")
Hardsigmoid = _layer("Hardsigmoid", F.hardsigmoid, "``F.hardsigmoid``.")
Softsign = _layer("Softsign", F.softsign, "``F.softsign``.")
Tanhshrink = _layer("Tanhshrink", F.tanhshrink, "``F.tanhshrink``.")
LogSigmoid = _layer("LogSigmoid", F.log_sigmoid, "``F.log_sigmoid``.")
GLU = _layer("GLU", F.glu, "``F.glu``.", axis=-1)
GELU = _layer("GELU", F.gelu, "``F.gelu``.", approximate=False)
LeakyReLU = _layer("LeakyReLU", F.leaky_relu, "``F.leaky_relu``.", negative_slope=0.01)
ELU = _layer("ELU", F.elu, "``F.elu``.", alpha=1.0)
CELU = _layer("CELU", F.celu, "``F.celu``.", alpha=1.0)
SELU = _layer("SELU", F.selu, "``F.selu``.", scale=1.0507009873554805,
              alpha=1.6732632423543772)
Hardtanh = _layer("Hardtanh", F.hardtanh, "``F.hardtanh``.", min=-1.0, max=1.0)
Hardshrink = _layer("Hardshrink", F.hardshrink, "``F.hardshrink``.", threshold=0.5)
Softshrink = _layer("Softshrink", F.softshrink, "``F.softshrink``.", threshold=0.5)
Softplus = _layer("Softplus", F.softplus, "``F.softplus``.", beta=1.0, threshold=20.0)
Softmax = _layer("Softmax", F.softmax, "``F.softmax``.", axis=-1)
LogSoftmax = _layer("LogSoftmax", F.log_softmax, "``F.log_softmax``.", axis=-1)
ThresholdedReLU = _layer("ThresholdedReLU", F.thresholded_relu,
                         "``F.thresholded_relu``: ``x`` above the threshold, else 0.",
                         threshold=1.0)
Maxout = _layer("Maxout", F.maxout, "``F.maxout``.", groups=None, axis=1)


class PReLU(nn.Module):
    """``F.prelu`` with a learned ``weight [num_parameters]``, every entry
    ``init`` at the start."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None, *, device="cuda", dtype=torch.float32):
        super().__init__()
        _no_attr(weight_attr, "weight_attr")
        self._data_format = data_format
        self.weight = make_parameter((num_parameters,), "zeros", device=device, dtype=dtype)
        with torch.no_grad():
            self.weight.fill_(init)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(nn.Module):
    """``F.rrelu``: random slopes in training, drawn from ``generator``."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *, generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training, generator=self.generator)
