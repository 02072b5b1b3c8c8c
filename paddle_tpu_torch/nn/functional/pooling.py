"""Pooling functionals (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference lowers pools to ``lax.reduce_window``; the port runs
torch's pools on explicitly padded inputs, so that its semantics are the
reference's where torch's defaults differ:

- pads are ``(before, after)`` a spatial dim: ints, flattened lists, XLA's
  ``"SAME"``/``"VALID"``, and with ``ceil_mode`` the trailing pad extended
  to the next stride boundary when that window starts inside the input
  and its leading pad (``_pool_pads``, ``pooling.py:27-58``);
- max pools pad with ``-inf`` (the smallest integer for integer inputs);
  ties go to the first maximum in window order, forward and backward;
  ``return_mask`` gives flat indices over the unpadded spatial plane;
- average pools add the window in the input's dtype and divide by the
  count of input (not pad) elements (``exclusive=True``, the default), or
  by the window's size (``exclusive=False``, or a string padding);
  ``divisor_override`` is taken and ignored, as in the reference;
- adaptive pools take ``floor(i L / n)`` to ``ceil((i + 1) L / n)``
  windows; adaptive max is ``amax`` over each window (its gradient split
  between tied maxima, as ``jnp.max``'s), and its mask the first maximum
  of each window over the input's spatial plane.

``lp_pool*``, ``max_unpool*`` and ``fractional_max_pool*`` come with a
later slice of the port.
"""

from __future__ import annotations

import itertools
import math

import torch
from torch.nn import functional as TF

from .conv import CHANNEL_LAST, _pair, pad_dims, same_pads

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d"]

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}


def _pool_pads(padding, sizes, ksize, strides, ceil_mode):
    """``(before, after)`` a spatial dim, or the padding's string upper-cased."""
    if isinstance(padding, str):
        return padding.upper()
    n = len(sizes)
    p = _pair(padding, n)
    pads = ([(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)] if len(p) == 2 * n
            else [(int(q), int(q)) for q in p])
    if ceil_mode:
        for i, (size, k, s) in enumerate(zip(sizes, ksize, strides)):
            lo, hi = pads[i]
            span = size + lo + hi - k
            rem = span % s
            # the extra window counts only where it starts inside the input
            # and its leading pad (torch's and Paddle's rule)
            if span > 0 and rem and (span // s + 1) * s < size + lo:
                pads[i] = (lo, hi + s - rem)
    return pads


def _window(x, kernel_size, stride, padding, spatial, data_format, ceil_mode):
    """(x channel-first, channel_last, k, s, pads or the padding string)."""
    channel_last = data_format in CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    k = _pair(kernel_size, spatial)
    s = _pair(stride if stride is not None else kernel_size, spatial)
    return x, channel_last, k, s, _pool_pads(padding, x.shape[2:], k, s, ceil_mode)


def _resolve(pads, sizes, k, s):
    if pads == "SAME":
        return same_pads(sizes, k, s)
    if pads == "VALID":
        return [(0, 0)] * len(sizes)
    if isinstance(pads, str):
        raise ValueError(f"padding {pads!r}: 'SAME', 'VALID' or sizes")
    return pads


def _max_pool(x, kernel_size, stride, padding, spatial, data_format, ceil_mode, return_mask):
    x, channel_last, k, s, pads = _window(x, kernel_size, stride, padding, spatial,
                                          data_format, ceil_mode)
    sizes = tuple(x.shape[2:])
    if return_mask and pads == "SAME":
        raise ValueError("return_mask with 'SAME' padding: pass the pad sizes")
    pads = _resolve(pads, sizes, k, s)
    low = -math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    xp = pad_dims(x, pads, value=low)
    out = _MAX_POOL[spatial](xp, k, s, return_indices=return_mask)
    if return_mask:
        out, idx = out
        # the padded plane's flat indices to the input plane's: gathered
        # from a padded plane of the input's indices
        plane = pad_dims(torch.arange(math.prod(sizes), device=x.device).reshape(1, 1, *sizes),
                         pads, value=-1).flatten(2)
        mask = plane.expand(*idx.shape[:2], -1).gather(-1, idx.flatten(2))
        mask = mask.reshape(idx.shape).to(torch.int32)
        if channel_last:
            out, mask = out.movedim(1, -1), mask.movedim(1, -1)
        return out, mask
    return out.movedim(1, -1) if channel_last else out


def _window_sum(x, k, s):
    """Each window's sum in x's dtype (no padding), one rounding: the
    windows as a strided view, summed."""
    for d, (size, step) in enumerate(zip(k, s)):
        x = x.unfold(2 + d, size, step)
    return x.sum(dim=tuple(range(-len(k), 0)))


def _avg_pool(x, kernel_size, stride, padding, spatial, data_format, exclusive, ceil_mode):
    x, channel_last, k, s, pads = _window(x, kernel_size, stride, padding, spatial,
                                          data_format, ceil_mode)
    sizes = tuple(x.shape[2:])
    exclusive = exclusive and not isinstance(pads, str)
    pads = _resolve(pads, sizes, k, s)
    summed = _window_sum(pad_dims(x, pads), k, s)
    if exclusive:
        ones = torch.ones((1, 1, *sizes), dtype=x.dtype, device=x.device)
        out = summed / _window_sum(pad_dims(ones, pads), k, s)
    else:
        out = summed / float(math.prod(k))
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, 1,
                     "NWC" if data_format == "NLC" else "NCW", ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, data_format, ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, data_format, ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1,
                     "NWC" if data_format == "NLC" else "NCW", exclusive, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, data_format, exclusive, ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, data_format, exclusive, ceil_mode)


def adaptive_bounds(in_size: int, out_size: int):
    """The adaptive windows of one dim: ``floor(i L / n)`` to
    ``ceil((i + 1) L / n)`` (they overlap where n does not divide L)."""
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-((i + 1) * in_size) // out_size) for i in range(out_size)]
    return starts, ends


def _adaptive_avg(x, output_size, spatial, channel_last):
    if channel_last:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE_AVG[spatial](x, _pair(output_size, spatial))
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_avg(x, output_size, 1, False)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg(x, output_size, 2, data_format == "NHWC")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg(x, output_size, 3, data_format == "NDHWC")


def _adaptive_max(x, output_size, spatial, return_mask):
    """``amax`` over each adaptive window (one reshape where every output
    size divides its input's), and the first maximum's flat index over the
    spatial plane: the same windows of a plane of indices, gathered."""
    n, c, *sizes = x.shape
    outs = _pair(output_size, spatial)
    plane = torch.arange(math.prod(sizes), device=x.device).reshape(1, 1, *sizes)
    if all(size % o == 0 for size, o in zip(sizes, outs)):
        def windows(t):
            split = t.reshape(*t.shape[:2], *[d for size, o in zip(sizes, outs)
                                              for d in (o, size // o)])
            order = [0, 1, *range(2, 2 + 2 * spatial, 2), *range(3, 3 + 2 * spatial, 2)]
            return [split.permute(order).reshape(*t.shape[:2], *outs, -1)]
    else:
        bounds = [adaptive_bounds(size, o) for size, o in zip(sizes, outs)]
        wins = [tuple(slice(b[0][i], b[1][i]) for b, i in zip(bounds, cell))
                for cell in itertools.product(*[range(o) for o in outs])]

        def windows(t):
            return [t[(Ellipsis, *win)].reshape(*t.shape[:2], -1) for win in wins]

    vals = windows(x)
    out = torch.stack([v.amax(-1) for v in vals], -1).reshape(n, c, *outs)
    if not return_mask:
        return out
    mask = [p.expand(*v.shape).gather(-1, v.argmax(-1, keepdim=True))[..., 0]
            for v, p in zip(vals, windows(plane))]
    return out, torch.stack(mask, -1).reshape(n, c, *outs).to(torch.int32)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """The mask holds the window's first maximum (the reference's 1-D and
    2-D masks are zeros; its 3-D one is this)."""
    return _adaptive_max(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """The mask holds the window's first maximum (the reference's 1-D and
    2-D masks are zeros; its 3-D one is this)."""
    return _adaptive_max(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max(x, output_size, 3, return_mask)
