"""Helpers of the op surface: the conversion of operands to tensors, the
reference's promotion of Python scalars, its 32-bit index policy and
Paddle's axis arguments."""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import dtype as _dt

__all__ = ["Scalar", "as_tensor", "scalar_like", "narrow", "axis_tuple", "dim_arg",
           "int_list"]

Scalar = (numbers.Number, np.number, np.bool_)

_WIDE = {torch.int64: torch.int32, torch.uint64: torch.uint32}


def as_tensor(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` itself when it is a tensor, else a new one (the reference's
    dtype rule) on ``like``'s device, or on the default device."""
    if isinstance(x, torch.Tensor):
        return x
    from ..tensor import to_tensor

    return to_tensor(x, place=None if like is None else like.device)


def scalar_like(v, t: torch.Tensor) -> torch.Tensor:
    """A 0-d CPU tensor of the Python scalar ``v`` (torch takes it beside a
    tensor of any device as a scalar, with no copy to the card), typed as
    the reference types a weak scalar: ``t``'s dtype when ``v``'s kind
    fits in it (an int with any number; a float with a float), else the
    default float dtype (a float with an integer tensor), a complex
    scalar complex64 unless ``t`` is complex."""
    if isinstance(v, (bool, np.bool_)) and t.dtype == torch.bool:
        dt = torch.bool
    elif isinstance(v, (complex, np.complexfloating)):
        dt = t.dtype if t.is_complex() else torch.complex64
    elif isinstance(v, (float, np.floating)):
        dt = t.dtype if (t.is_floating_point() or t.is_complex()) else _dt.get_default_dtype()
    else:
        dt = t.dtype if t.dtype != torch.bool else torch.int32
    return torch.tensor(v, dtype=dt)


def narrow(out):
    """The reference's 32-bit index policy on an op's result (a tensor, or
    a tuple or list of them): int64 and uint64 results, which torch gives
    for indices and integer sums, become int32 and uint32."""
    if isinstance(out, torch.Tensor):
        to = _WIDE.get(out.dtype)
        return out if to is None else out.to(to)
    if isinstance(out, (tuple, list)):
        return type(out)(narrow(o) for o in out)
    return out


def axis_tuple(axis, ndim: int):
    """Paddle's ``axis`` (None, an int, a list or tuple, negatives counted
    from the end, or a tensor) as a tuple of non-negative dims; None stays
    None."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim if ndim else 0 for a in axis)
    return (int(axis) % ndim if ndim else 0,)


def dim_arg(axis) -> int:
    """An ``axis`` given as an int or a one-element tensor, as an int."""
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def int_list(v) -> list:
    """A shape-like argument (ints, tensors of one element, or a tensor) as
    a list of ints."""
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(i.item()) if isinstance(i, torch.Tensor) else int(i) for i in v]
