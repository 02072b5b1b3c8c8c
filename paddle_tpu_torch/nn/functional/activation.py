"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``).

Each is one elementwise expression on torch tensors, with the
reference's formula where torch's own op rounds or clips another way
(``hardsigmoid``, ``selu``, ``thresholded_relu``). Under
``amp.auto_cast`` every one first casts its tensor inputs as the
reference's op of the same name (``softmax`` and ``log_softmax`` are
black-list ops: to f32). The random ones (``rrelu`` in training,
``gumbel_softmax``) draw from the caller's ``generator``, else from the
port's generator of the input's device (torch bits, not the
reference's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...dtype import convert_dtype
from ...framework.random import generator_for

__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish", "hardswish",
           "hardsigmoid", "softsign", "tanhshrink", "log_sigmoid", "gelu", "leaky_relu",
           "elu", "celu", "selu", "prelu", "rrelu", "hardtanh", "hardshrink", "softshrink",
           "softplus", "maxout", "softmax", "log_softmax", "gumbel_softmax", "glu", "swiglu",
           "softmax_", "thresholded_relu"]


def _unary(op_name, fn):
    def op(x, name=None):
        x, = cast_inputs(op_name, x)
        return fn(x)

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"Paddle's ``{op_name}``, elementwise."
    return op


relu = _unary("relu", torch.relu)
relu6 = _unary("relu6", F.relu6)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
silu = _unary("silu", F.silu)
swish = silu
mish = _unary("mish", F.mish)
hardswish = _unary("hardswish", F.hardswish)
hardsigmoid = _unary("hardsigmoid", lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
softsign = _unary("softsign", F.softsign)
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x))
log_sigmoid = _unary("log_sigmoid", F.logsigmoid)


def gelu(x, approximate=False, name=None):
    """GELU: exact (``x * Phi(x)``, through erf) by default, the tanh
    approximation with ``approximate=True``."""
    x, = cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = cast_inputs("leaky_relu", x)
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    x, = cast_inputs("elu", x)
    return F.elu(x, alpha)


def celu(x, alpha=1.0, name=None):
    x, = cast_inputs("celu", x)
    return F.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """``scale * (x if x > 0 else alpha * expm1(x))`` with the caller's
    ``scale`` and ``alpha``."""
    x, = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x if x > 0 else weight * x``; a weight of more than one element
    runs along the channel axis (axis 1 for NCHW, the last otherwise)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    elif data_format == "NCHW" and x.dim() > 1:
        w = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    else:
        w = weight.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None, *, generator=None):
    """Randomized leaky ReLU: in training each element's slope is drawn
    uniform in ``[lower, upper)``; otherwise the slope is their mean."""
    x, = cast_inputs("rrelu", x)
    if training:
        slope = torch.empty_like(x).uniform_(lower, upper,
                                             generator=generator_for(x.device, generator))
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    x, = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros((), dtype=x.dtype, device=x.device))


def softshrink(x, threshold=0.5, name=None):
    x, = cast_inputs("softshrink", x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log(1 + exp(beta * x)) / beta``."""
    x, = cast_inputs("softplus", x)
    return F.softplus(x, beta, threshold)


def maxout(x, groups, axis=1, name=None):
    """The maximum over each run of ``groups`` consecutive channels of
    ``axis``."""
    x, = cast_inputs("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(x.shape[ax + 1:])
    return x.reshape(shape).amax(dim=ax + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``; with ``dtype`` x is cast to it first."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    x, = cast_inputs("softmax", x)
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis``; with ``dtype`` x is cast to it first."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    x, = cast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=int(axis))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *, generator=None):
    """``softmax((x + g) / temperature)`` with standard Gumbel noise ``g``;
    ``hard`` gives the one-hot of the argmax in the forward and the soft
    gradient (straight-through)."""
    x, = cast_inputs("gumbel_softmax", x)
    u = torch.rand(x.shape, generator=generator_for(x.device, generator), device=x.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp_min(tiny)))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    one_hot = torch.zeros_like(y).scatter_(axis, y.argmax(dim=axis, keepdim=True), 1.0)
    return one_hot + y - y.detach()


def glu(x, axis=-1, name=None):
    """``a * sigmoid(b)`` of the two halves ``a, b`` of ``axis``."""
    x, = cast_inputs("glu", x)
    return F.glu(x, dim=axis)


def swiglu(x, y=None, name=None):
    """``silu(x) * y``, the Llama MLP gate; with ``y`` None, x's last axis
    is split in halves ``[gate, up]``. Composed on purpose, as in the
    reference (``activation.py:167-179``): an elementwise product has no
    reduction to fuse, and the fused TPU kernel is for explicit use only.
    Under ``amp.auto_cast`` the inputs are first cast as the op
    ``swiglu``."""
    x, y = cast_inputs("swiglu", x, y)
    if y is None:
        half = x.shape[-1] // 2
        x, y = x[..., :half], x[..., half:]
    return F.silu(x) * y


def softmax_(x, axis=-1, dtype=None, name=None):
    """:func:`softmax` written into ``x``; returns ``x``."""
    return x.copy_(softmax(x, axis, dtype))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """``x`` where ``x > threshold``, else ``value``."""
    x, = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full((), value, dtype=x.dtype, device=x.device))
