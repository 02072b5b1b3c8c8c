"""Shape and layout ops (counterpart of ``paddle_tpu/ops/manipulation.py``)
with Paddle's argument conventions: ``reshape`` keeps a dimension given
as 0, ``split`` takes one ``-1`` section, ``expand`` keeps a dimension
given as -1, ``gather`` selects along an axis (torch's ``index_select``),
``flatten`` takes ``start_axis`` / ``stop_axis``, ``scatter`` writes rows
(the last of duplicate indices wins; ``overwrite=False`` zeroes the rows
it writes, then adds every update). Index results are int32."""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ._helpers import as_tensor, dim_arg, int_list, narrow
from .registry import make_inplace

__all__ = ["reshape", "reshape_", "flatten", "squeeze", "unsqueeze", "transpose", "moveaxis",
           "swapaxes", "concat", "stack", "split", "chunk", "unbind", "tile", "expand",
           "broadcast_to", "expand_as", "broadcast_tensors", "flip", "roll", "rot90", "gather",
           "gather_nd", "scatter", "scatter_", "scatter_nd_add", "scatter_nd", "index_select",
           "index_sample", "index_add", "index_put", "take_along_axis", "put_along_axis",
           "repeat_interleave", "pad", "masked_select", "masked_fill", "where", "where_",
           "nonzero", "unique", "unique_consecutive", "as_strided", "view", "view_as",
           "atleast_1d", "atleast_2d", "atleast_3d", "slice", "strided_slice", "crop",
           "shard_index", "slice_scatter", "broadcast_shape", "fill_diagonal_",
           "fill_diagonal_tensor", "fill_diagonal_tensor_", "diagonal_scatter", "unfold"]


def _long(i: torch.Tensor) -> torch.Tensor:
    return i if i.dtype == torch.int64 else i.long()


def reshape(x, shape, name=None):
    """A 0 in ``shape`` keeps that dimension of ``x``; one -1 is inferred."""
    x = as_tensor(x)
    shp = [x.shape[i] if s == 0 else s for i, s in enumerate(int_list(shape))]
    return torch.reshape(x, shp)


reshape_ = make_inplace(reshape, "reshape_")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    """Drops the given axes of size 1 (every one for None); others stay."""
    x = as_tensor(x)
    if axis is None:
        return torch.squeeze(x)
    dims = [a % x.dim() for a in int_list(axis)] if x.dim() else []
    return torch.squeeze(x, tuple(d for d in dims if x.shape[d] == 1))


def unsqueeze(x, axis, name=None):
    """New axes of size 1 at the given positions of the result."""
    x = as_tensor(x)
    axes = int_list(axis)
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def transpose(x, perm=None, name=None):
    x = as_tensor(x)
    return torch.permute(x, list(range(x.dim()))[::-1] if perm is None else int_list(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(as_tensor(x), source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(as_tensor(x), axis1, axis2)


def concat(x, axis=0, name=None):
    ts = [as_tensor(t) for t in x]
    return torch.cat(ts, dim=dim_arg(axis))


def stack(x, axis=0, name=None):
    return torch.stack([as_tensor(t) for t in x], dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """Into ``num_or_sections`` equal parts (an int that must divide the
    axis), or parts of the given sizes, one of which may be -1 (the rest)."""
    x = as_tensor(x)
    ax = dim_arg(axis) % x.dim()
    n = x.shape[ax]
    if isinstance(num_or_sections, (int, np.integer)):
        if n % num_or_sections:
            raise ValueError(f"split: dim {ax} size {n} is not divisible by {num_or_sections}")
        sizes = [n // int(num_or_sections)] * int(num_or_sections)
    else:
        sizes = int_list(num_or_sections)
        if -1 in sizes:
            sizes[sizes.index(-1)] = n - sum(s for s in sizes if s != -1)
    return list(torch.split(x, sizes, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(as_tensor(x), int(axis)))


def tile(x, repeat_times, name=None):
    return torch.tile(as_tensor(x), int_list(repeat_times))


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; a -1 keeps ``x``'s dimension."""
    x = as_tensor(x)
    tgt = int_list(shape)
    cur = [1] * (len(tgt) - x.dim()) + list(x.shape)
    return x.expand([c if t == -1 else t for c, t in zip(cur, tgt)])


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(as_tensor(x), int_list(shape))


def expand_as(x, y, name=None):
    return broadcast_to(x, list(as_tensor(y).shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[as_tensor(t) for t in inputs]))


def flip(x, axis, name=None):
    return torch.flip(as_tensor(x), int_list(axis))


def roll(x, shifts, axis=None, name=None):
    x = as_tensor(x)
    shifts = int_list(shifts) if not isinstance(shifts, int) else shifts
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, int_list(axis) if not isinstance(axis, int) else axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(as_tensor(x), k, list(axes))


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (``index_select``; a 0-d
    index selects one, kept as an axis of 1)."""
    x, index = as_tensor(x), as_tensor(index)
    ax = dim_arg(axis) % x.dim()
    idx = index.reshape(-1)
    out = torch.index_select(x, ax, idx)
    shp = list(index.shape) if index.dim() else [1]
    return out.reshape(list(x.shape[:ax]) + shp + list(x.shape[ax + 1:]))


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def gather_nd(x, index, name=None):
    x, index = as_tensor(x), _long(as_tensor(index))
    return x[tuple(index[..., i] for i in range(index.shape[-1]))]


def _last_wins(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the entries of ``idx`` that are the last with their value."""
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n,), -1, dtype=pos.dtype, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, "amax")
    return last[idx] == pos


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (the last of
    duplicate indices wins), or with ``overwrite=False`` zeroed and then
    given the sum of their updates (Paddle's rule)."""
    x, index, updates = as_tensor(x), as_tensor(index), as_tensor(updates)
    idx = _long(index.reshape(-1))
    updates = updates.to(x.dtype)
    if overwrite:
        keep = _last_wins(idx, x.shape[0])
        return x.index_put((idx[keep],), updates[keep])
    zeroed = x.index_put((idx,), torch.zeros((), dtype=x.dtype, device=x.device))
    return zeroed.index_put((idx,), updates, accumulate=True)


scatter_ = make_inplace(scatter, "scatter_")


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = as_tensor(x), _long(as_tensor(index)), as_tensor(updates)
    comps = tuple(index[..., i] for i in range(index.shape[-1]))
    return x.index_put(comps, updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = as_tensor(updates)
    zeros = torch.zeros(int_list(shape), dtype=updates.dtype, device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_sample(x, index, name=None):
    x, index = as_tensor(x), as_tensor(index)
    return torch.gather(x, 1, _long(index))


def index_add(x, index, axis, value, name=None):
    x, index, value = as_tensor(x), as_tensor(index), as_tensor(value)
    return torch.index_add(x, int(axis), _long(index), value.to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = as_tensor(x), as_tensor(value)
    comps = [as_tensor(i) for i in indices]
    comps = tuple(i if i.dtype == torch.bool else _long(i) for i in comps)
    return x.index_put(comps, value.to(x.dtype), accumulate=bool(accumulate))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr, indices = as_tensor(arr), as_tensor(indices)
    return torch.take_along_dim(arr, _long(indices), dim=int(axis))


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod", "amax": "amax",
           "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True, name=None):
    """``values`` written into ``arr`` at ``indices`` along ``axis``
    (``reduce``: "assign", "add"/"sum", "mul"/"multiply", "amax", "amin")."""
    arr, indices = as_tensor(arr), _long(as_tensor(indices))
    values = as_tensor(values, like=arr).to(arr.dtype).expand(indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, int(axis), indices, values)
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce!r}")
    return torch.scatter_reduce(arr, int(axis), indices, values, _REDUCE[reduce],
                                include_self=bool(include_self))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_tensor(x)
    reps = _long(repeats) if isinstance(repeats, torch.Tensor) else int(repeats)
    return torch.repeat_interleave(x, reps, dim=axis)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` of every axis (``2 * ndim`` entries, axis by axis), or of the
    spatial axes of ``data_format``, the first pair padding the last
    spatial axis; modes "constant", "reflect", "replicate", "circular"."""
    x = as_tensor(x)
    p = int_list(pad)
    nd = x.dim()
    if len(p) == 2 * nd:
        widths = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        k = len(p) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C") and nd >= 3:
            dims = list(range(nd - 2, nd - 2 - k, -1))
        else:
            dims = list(range(nd - 1, nd - 1 - k, -1))
        for j, d in enumerate(dims):
            widths[d] = (p[2 * j], p[2 * j + 1])
    if mode == "constant":
        flat = [w for d in reversed(range(nd)) for w in widths[d]]
        return F.pad(x, flat, "constant", value)
    padded = [d for d in range(nd) if widths[d] != (0, 0)]
    perm = [d for d in range(nd) if d not in padded] + padded
    xt = x.permute(perm)
    lead = tuple(xt.shape[:nd - len(padded)])
    out = F.pad(xt.reshape((-1, 1) + tuple(xt.shape[len(lead):])),
                [w for d in reversed(padded) for w in widths[d]], mode)
    return out.reshape(lead + tuple(out.shape[2:])).permute(list(np.argsort(perm)))


def masked_select(x, mask, name=None):
    x, mask = as_tensor(x), as_tensor(mask)
    return torch.masked_select(x, mask.bool())


def masked_fill(x, mask, value, name=None):
    x, mask = as_tensor(x), as_tensor(mask)
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else value
    return torch.masked_fill(x, mask.bool(), v)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y`` (scalars broadcast);
    without ``x`` and ``y`` the tuple of the true elements' indices."""
    condition = as_tensor(condition)
    if x is None and y is None:
        return narrow(torch.nonzero(condition, as_tuple=True))
    return torch.where(condition.bool(), x, y)


def where_(condition, x=None, y=None, name=None):
    """``where`` written into ``x`` (not into the condition)."""
    return x.copy_(where(condition, x, y))


def nonzero(x, as_tuple=False, name=None):
    return narrow(torch.nonzero(as_tensor(x), as_tuple=as_tuple))


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """The sorted unique values (of the flattened ``x``, or the unique
    slices along ``axis``), then as asked each one's first index, the
    inverse and the counts, numpy's order of results."""
    x = as_tensor(x)
    src = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique(src, sorted=True, return_inverse=True, return_counts=True,
                                    dim=axis)
    res = [out]
    if return_index:
        pos = torch.arange(inv.numel(), device=x.device)
        first = torch.full((out.shape[0 if axis is None else axis],), inv.numel(),
                           dtype=pos.dtype, device=x.device)
        res.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin"))
    if return_inverse:                 # numpy 2's (the reference's): x's shape for axis None
        res.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        res.append(counts)
    return narrow(res[0] if len(res) == 1 else tuple(res))


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None, dtype="int64",
                       name=None):
    x = as_tensor(x)
    out = torch.unique_consecutive(x.reshape(-1) if axis is None else x,
                                   return_inverse=return_inverse, return_counts=return_counts,
                                   dim=axis)
    return narrow(out)


def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(as_tensor(x), int_list(shape), int_list(stride), offset)


def view(x, shape_or_dtype, name=None):
    """A reshape for a shape; for a dtype, a cast (the reference's)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    from .math import cast

    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, list(other.shape))


def _atleast(fn, inputs):
    outs = [fn(as_tensor(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


def _strided(x, axes, starts, ends, strides):
    x = as_tensor(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = int(ax) % x.dim()
        r = range(x.shape[ax])[builtins.slice(int(s), int(e), int(st))]
        if r.step > 0:
            x = x[(builtins.slice(None),) * ax + (builtins.slice(r.start, r.stop, r.step),)]
        else:
            x = torch.index_select(x, ax, torch.tensor(list(r), dtype=torch.long,
                                                       device=x.device))
    return x


def slice(input, axes, starts, ends, name=None):
    axes = int_list(axes)
    return _strided(input, axes, int_list(starts), int_list(ends), [1] * len(axes))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided(x, int_list(axes), int_list(starts), int_list(ends), int_list(strides))


def crop(x, shape=None, offsets=None, name=None):
    x = as_tensor(x)
    shp = int_list(shape)
    offs = [0] * x.dim() if offsets is None else int_list(offsets)
    idx = tuple(builtins.slice(o, o + s if s != -1 else None) for o, s in zip(offs, shp))
    return x[idx]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = as_tensor(input)
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(a, size, rounding_mode="floor") == shard_id,
                       torch.remainder(a, size), torch.full_like(a, ignore_value))


def slice_scatter(x, value, axes=(), starts=(), ends=(), strides=(), name=None):
    """``x`` with ``value`` written into its strided slice (strides 1 when
    not given)."""
    x, value = as_tensor(x), as_tensor(value)
    strides = list(strides) or [1] * len(axes)
    if not len(axes) == len(starts) == len(ends) == len(strides):
        raise ValueError("slice_scatter: axes/starts/ends/strides lengths must match, got "
                         f"{len(axes)}/{len(starts)}/{len(ends)}/{len(strides)}")
    sel = {int(a) % x.dim(): (int(s), int(e), int(st))
           for a, s, e, st in zip(axes, starts, ends, strides)}
    idx = tuple(builtins.slice(*sel[d]) if d in sel else builtins.slice(None)
                for d in range(x.dim()))
    out = x.clone()
    out[idx] = value.to(x.dtype)
    return out


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """``value`` written along the diagonal of ``x`` in place (with
    ``wrap`` repeated down a tall matrix, a row skipped between blocks; a
    tensor of more than 2 equal dims: its main diagonal)."""
    shape = tuple(x.shape)
    if len(shape) < 2:
        raise ValueError("fill_diagonal_ needs >= 2 dims")
    if len(shape) > 2:
        if len(set(shape)) != 1:
            raise ValueError("fill_diagonal_ on ndim > 2 needs equal dims")
        idx = (np.arange(shape[0]),) * len(shape)
    elif wrap:
        h, w = shape
        rows, cols = [], []
        r, c = max(-offset, 0), max(offset, 0)
        while r < h:
            if c >= w:
                r, c = r + 1, 0
                continue
            rows.append(r)
            cols.append(c)
            r, c = r + 1, c + 1
        idx = (np.array(rows, np.int64), np.array(cols, np.int64))
    else:
        n = min(shape[0] - max(-offset, 0), shape[1] - max(offset, 0))
        if n <= 0:
            return x
        idx = (np.arange(n) + max(-offset, 0), np.arange(n) + max(offset, 0))
    comps = tuple(torch.as_tensor(i, device=x.device) for i in idx)
    return x.index_put_(comps, torch.tensor(value, dtype=x.dtype, device=x.device))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``x`` with ``y`` written along its (``dim1``, ``dim2``) diagonal,
    ``y``'s last axis running along it."""
    x, y = as_tensor(x), as_tensor(y)
    out = x.clone()
    torch.diagonal(out, offset, dim1, dim2).copy_(y.to(x.dtype))
    return out


fill_diagonal_tensor_ = make_inplace(fill_diagonal_tensor, "fill_diagonal_tensor_")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return fill_diagonal_tensor(x, y, offset, axis1, axis2)


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``: the window count
    at ``axis``, the window as a new last axis."""
    x = as_tensor(x)
    ax = int(axis) % x.dim()
    if size > x.shape[ax]:
        raise ValueError(f"unfold: size {size} > dim length {x.shape[ax]}")
    return x.unfold(ax, size, step)
