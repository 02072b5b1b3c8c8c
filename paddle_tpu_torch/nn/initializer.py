"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

An initializer is a callable ``init(shape, dtype=None, *, device=None,
generator=None) -> torch.Tensor``: a new tensor of ``shape`` on ``device``
(None: the default device of :mod:`paddle_tpu_torch.device`) in ``dtype``
(None: the default dtype), drawn from ``generator`` (None: the port's
generator of that device, :func:`paddle_tpu_torch.framework.random.
default_generator`). Fans are the reference's: a 2-D ``[in, out]`` weight
has fan-in ``in`` and fan-out ``out``; a convolution's ``[out, in, *k]``
has ``in * prod(k)`` and ``out * prod(k)``; a 1-D shape ``n`` both.

``Dirac`` is Paddle's: each group's first ``min(out, in)`` output channels
pass their input channel through the kernel's centre.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import dtype as _dt

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "calculate_gain", "set_global_initializer", "global_initializer"]


class Initializer:
    def __call__(self, shape, dtype=None, *, device=None, generator=None) -> torch.Tensor:
        from ..device import place_device
        from ..framework.random import default_generator

        dev = place_device(device)
        out = torch.empty(tuple(int(s) for s in shape), device=dev,
                          dtype=_dt.convert_dtype(dtype) or _dt.get_default_dtype())
        with torch.no_grad():
            self._fill(out, generator if generator is not None else default_generator(dev))
        return out

    def _fill(self, out: torch.Tensor, generator: torch.Generator):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(shape):
        shape = tuple(shape)
        if len(shape) < 2:
            f = shape[0] if shape else 1
            return f, f
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = math.prod(shape[2:])
        return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, out, generator):
        out.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, out, generator):
        out.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` normal truncated to ``[a, b]`` (drawn
    in f32)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _fill(self, out, generator):
        z = torch.empty(out.shape, device=out.device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b, generator=generator)
        out.copy_(z * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, out, generator):
        out.uniform_(self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, out, generator):
        fi, fo = self._fan_in_out(out.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        out.normal_(0.0, self.gain * math.sqrt(2.0 / (fi + fo)), generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, out, generator):
        fi, fo = self._fan_in_out(out.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        out.uniform_(-limit, limit, generator=generator)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def _fill(self, out, generator):
        fi = self.fan_in if self.fan_in is not None else self._fan_in_out(out.shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) / math.sqrt(fi)
        out.normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def _fill(self, out, generator):
        fi = self.fan_in if self.fan_in is not None else self._fan_in_out(out.shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) * math.sqrt(3.0 / fi)
        out.uniform_(-limit, limit, generator=generator)


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped to the
    parameter's shape and cast to its dtype."""

    def __init__(self, value):
        self.value = value

    def _fill(self, out, generator):
        v = self.value
        if not torch.is_tensor(v):
            from ..tensor import from_numpy

            v = from_numpy(np.asarray(v))
        out.copy_(v.reshape(out.shape).to(device=out.device, dtype=out.dtype))


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns, over the
    shape read as ``[prod(shape[:-1]), shape[-1]]`` (the reference's
    flattening): the Q of a normal matrix's QR with R's diagonal signs
    folded in, drawn and factored in f32."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, out, generator):
        cols = out.shape[-1] if out.dim() else 1
        rows = out.numel() // max(cols, 1)
        a = torch.empty((max(rows, cols), min(rows, cols)), device=out.device,
                        dtype=torch.float32).normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        out.copy_((self.gain * q).reshape(out.shape))


class Dirac(Initializer):
    """Paddle's Dirac for a convolution weight ``[out, in, *k]``: zeros,
    then in each of ``groups`` groups of ``out / groups`` channels, output
    ``i < min(out / groups, in)`` holds 1 at input ``i`` and the kernel's
    centre."""

    def __init__(self, groups=1):
        self.groups = groups

    def _fill(self, out, generator):
        if out.dim() < 3:
            raise ValueError("Dirac initializes a convolution weight [out, in, *k]")
        out.zero_()
        per = out.shape[0] // self.groups
        centre = tuple(k // 2 for k in out.shape[2:])
        for g in range(self.groups):
            for i in range(min(per, out.shape[1])):
                out[(g * per + i, i) + centre] = 1


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


_global = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Initializers that every later parameter without an initializer of
    its own takes (weights and biases apart), ahead of a layer's default;
    ``set_global_initializer(None)`` clears them."""
    _global["weight"], _global["bias"] = weight_init, bias_init


def global_initializer(is_bias: bool):
    return _global["bias" if is_bias else "weight"]
