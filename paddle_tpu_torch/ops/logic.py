"""Comparison and logical ops (counterpart of ``paddle_tpu/ops/logic.py``):
the regular ones come from the table (``ops.yaml``), the irregular ones
below register themselves; their results carry no gradient."""

from __future__ import annotations

import torch

from ._helpers import as_tensor
from .registry import register_custom

__all__ = ["equal_all", "all", "any", "isclose", "allclose", "is_tensor", "is_empty", "isin",
           "in1d"]


@register_custom("equal_all", backward="none", module="logic")
def equal_all(x, y, name=None):
    x, y = as_tensor(x), as_tensor(y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype))),
                        device=x.device)


def _reduce_bool(fn, x, axis, keepdim):
    x = as_tensor(x).bool()
    if axis is None:
        out = fn(x)
        return out.reshape([1] * x.dim()) if keepdim else out
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)
    return fn(x, dim=dims, keepdim=keepdim)


@register_custom("all", backward="none", module="logic")
def all(x, axis=None, keepdim=False, name=None):
    return _reduce_bool(torch.all, x, axis, keepdim)


@register_custom("any", backward="none", module="logic")
def any(x, axis=None, keepdim=False, name=None):
    return _reduce_bool(torch.any, x, axis, keepdim)


@register_custom("isclose", backward="none", module="logic")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = as_tensor(x)
    return torch.isclose(x, as_tensor(y, x), rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_custom("allclose", backward="none", module="logic")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = as_tensor(x)
    return torch.all(torch.isclose(x, as_tensor(y, x), rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_empty(x) -> torch.Tensor:
    x = as_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


@register_custom("isin", backward="none", module="logic")
def in1d(x, test, name=None):
    x = as_tensor(x)
    return torch.isin(x, as_tensor(test, x))


isin = in1d
