"""Math ops (counterpart of ``paddle_tpu/ops/math.py``): the elementwise
ops, reductions and predicates come from the table (``ops.yaml``); the
irregular ones below register themselves with the registry."""

from __future__ import annotations

import torch

from .. import dtype as _dt
from ._helpers import Scalar, as_tensor, axis_tuple, narrow
from .registry import register_custom

__all__ = ["assign", "cast", "scale", "clip", "lerp", "multiplex", "add_n", "stanh",
           "nan_to_num", "std", "var", "median", "quantile", "cumsum", "cumprod", "cummax",
           "cummin", "trace", "diff", "kron", "inner", "outer", "trapezoid",
           "cumulative_trapezoid", "reduce_as"]


@register_custom("assign", method=False)
def assign(x, output=None):
    """A copy of ``x`` (into ``output`` when given)."""
    out = as_tensor(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


@register_custom("cast")
def cast(x, dtype):
    """``x`` in ``dtype`` (narrowed as ``dtype.convert_dtype`` narrows):
    differentiable between float and complex types, detached otherwise."""
    d = _dt.convert_dtype(dtype)
    x = as_tensor(x)
    out = x.to(d) if x.dtype != d else x.clone()
    inexact = (x.is_floating_point() or x.is_complex()) and (d.is_floating_point or d.is_complex)
    return out if inexact else out.detach()


@register_custom("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = as_tensor(x)
    s = scale.to(x.dtype) if isinstance(scale, torch.Tensor) else scale
    return x * s + bias if bias_after_scale else (x + bias) * s


@register_custom("clip")
def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(as_tensor(x), lo, hi)


@register_custom("lerp")
def lerp(x, y, weight, name=None):
    x, y = as_tensor(x), as_tensor(y)
    return x + weight * (y - x)


@register_custom("multiplex")
def multiplex(inputs, index, name=None):
    """Row ``i`` from ``inputs[index[i]]``."""
    stacked = torch.stack([as_tensor(t) for t in inputs], 0)
    idx = as_tensor(index).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


@register_custom("add_n")
def add_n(inputs, name=None):
    ts = [as_tensor(t) for t in (inputs if isinstance(inputs, (list, tuple)) else [inputs])]
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out if len(ts) > 1 else out.clone()


@register_custom("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * as_tensor(x))


@register_custom("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(as_tensor(x), nan, posinf, neginf)


def _dims(x, axis):
    dims = axis_tuple(axis, x.dim())
    return dims if dims is not None else tuple(range(x.dim()))


@register_custom("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.std(x, dim=_dims(x, axis), correction=int(bool(unbiased)), keepdim=keepdim)


@register_custom("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = as_tensor(x)
    return torch.var(x, dim=_dims(x, axis), correction=int(bool(unbiased)), keepdim=keepdim)


def _quantile(x, q, axis, keepdim):
    xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
    qt = torch.tensor(q, dtype=xf.dtype, device=x.device) if not isinstance(q, Scalar) else q
    if axis is None:
        out = torch.quantile(xf.reshape(-1), qt)
        if keepdim:
            out = out.reshape(list(out.shape) + [1] * x.dim())
    else:
        out = torch.quantile(xf, qt, dim=int(axis), keepdim=keepdim)
    return out


@register_custom("median")
def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values for an even count (numpy's)."""
    x = as_tensor(x)
    return _quantile(x, 0.5, axis, keepdim).to(x.dtype if x.is_floating_point()
                                                else torch.float32)


@register_custom("quantile")
def quantile(x, q, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    return _quantile(x, q, axis, keepdim)


@register_custom("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    x = as_tensor(x)
    out = torch.cumsum(x.reshape(-1) if axis is None else x, 0 if axis is None else int(axis))
    return narrow(out if dtype is None else out.to(_dt.convert_dtype(dtype)))


@register_custom("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    x = as_tensor(x)
    out = torch.cumprod(x.reshape(-1) if dim is None else x, 0 if dim is None else int(dim))
    return narrow(out if dtype is None else out.to(_dt.convert_dtype(dtype)))


def _cum_extreme(fn, x, axis):
    x = as_tensor(x)
    if axis is None:
        x, ax = x.reshape(-1), 0
    else:
        ax = int(axis) % x.dim()
    vals = fn(x, ax).values
    # the index of the running extreme is the latest position holding it
    n = x.shape[ax]
    shape = [1] * x.dim()
    shape[ax] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    cand = torch.where(x == vals, pos, torch.full_like(pos, -1))
    return vals, narrow(torch.cummax(cand.expand(x.shape), ax).values)


@register_custom("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, x, axis)


@register_custom("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis)


@register_custom("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return narrow(torch.sum(torch.diagonal(as_tensor(x), offset, axis1, axis2), -1))


@register_custom("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = as_tensor(x)
    return torch.diff(x, n, axis, None if prepend is None else as_tensor(prepend, x),
                      None if append is None else as_tensor(append, x))


@register_custom("kron")
def kron(x, y, name=None):
    return torch.kron(as_tensor(x), as_tensor(y))


@register_custom("inner")
def inner(x, y, name=None):
    return torch.inner(as_tensor(x), as_tensor(y))


@register_custom("outer")
def outer(x, y, name=None):
    return torch.outer(as_tensor(x).reshape(-1), as_tensor(y).reshape(-1))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """The trapezoid rule along ``axis``: at the points ``x``, else with
    spacing ``dx`` (1 when neither is given)."""
    y = as_tensor(y)
    if x is not None:
        return torch.trapezoid(y, as_tensor(x, y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else float(dx), dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_tensor(y)
    if x is not None:
        return torch.cumulative_trapezoid(y, as_tensor(x, y), dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else float(dx), dim=axis)


def reduce_as(x, target, name=None):
    """``x`` summed over its leading axes and the axes where ``target`` is
    1, to ``target``'s shape."""
    x, t = as_tensor(x), as_tensor(target)
    lead = x.dim() - t.dim()
    axes = tuple(range(lead)) + tuple(lead + i for i, s in enumerate(t.shape)
                                      if s == 1 and x.shape[lead + i] != 1)
    out = torch.sum(x, dim=axes) if axes else x
    return narrow(out.reshape(t.shape))
