"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``).

The reference runs one ``lax.conv_general_dilated`` a call; the port runs
cuDNN's convolution (``aten.convolution``) on the card and ATen's on the
CPU, with the reference's semantics where torch's defaults differ:

- weights are Paddle's layouts, which are torch's (``[out, in/g, *k]``; a
  transpose's ``[in, out/g, *k]``), cast to the input's dtype;
- the bias is added after the product is rounded to the input's dtype
  (``conv.py:72-77``), not inside the convolution;
- padding takes ints, per-dim pairs, flattened ``[before, after]`` lists
  and ``"SAME"``/``"VALID"`` (XLA's: at stride > 1 the odd pad goes at the
  end); a pad that differs before and after is an ``F.pad`` of the
  difference in front of a symmetric convolution;
- a transpose is the reference's gradient-of-conv: the full transposed
  convolution, then cropped or zero-padded to the reference's pads, so
  ``output_padding`` may be as large as the reference lets it (past the
  stride, which torch refuses);
- f32 is full f32 in both directions: torch lets cuDNN run f32
  convolutions in TF32 by default, so forward and backward run inside
  :func:`full_f32` (``_Convolution``), which sets no flag beyond its
  block.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as TF

from ...amp import cast_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "full_f32"]

CHANNEL_LAST = ("NHWC", "NLC", "NWC", "NDHWC")


def _pair(v, n):
    """The reference's ``_pair``: n ints from an int or an n-list, a
    2n-list as given, else its first value n times."""
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 2 * n:
            return tuple(v)
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _conv_padding(padding, spatial):
    """``"SAME"``/``"VALID"``, or a ``(before, after)`` pair a spatial dim
    (``conv.py:30-38``)."""
    if isinstance(padding, str):
        return padding.upper()
    if (isinstance(padding, (list, tuple)) and len(padding) == spatial
            and isinstance(padding[0], (list, tuple))):
        return [tuple(int(q) for q in p) for p in padding]
    p = _pair(padding, spatial)
    if len(p) == 2 * spatial:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(spatial)]
    return [(int(q), int(q)) for q in p]


def same_pads(sizes, windows, strides):
    """XLA's ``SAME`` pads of each spatial dim: ``ceil(L / s)`` outputs,
    the total pad split with the odd one at the end."""
    pads = []
    for size, window, stride in zip(sizes, windows, strides):
        total = max((-(-size // stride) - 1) * stride + window - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_dims(x, pads, value=0.0):
    """``x`` padded (or, where negative, cropped) by ``(before, after)``
    on each of its trailing ``len(pads)`` dims; as given when every pad is
    0."""
    if not any(lo or hi for lo, hi in pads):
        return x
    return TF.pad(x, [q for lo_hi in reversed(pads) for q in lo_hi], value=value)


@contextlib.contextmanager
def full_f32():
    """cuDNN's f32 convolutions without TF32 inside the block; the
    setting it found comes back on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` (no bias, symmetric padding) whose forward and
    backward both run inside :func:`full_f32`: autograd's own backward
    would read the TF32 setting of wherever the backward runs."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, [0] * len(stride), groups)
        with full_f32():
            return torch.ops.aten.convolution(x, w, None, *ctx.conf)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with full_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, *ctx.conf,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None


def _add_bias(out, bias, spatial):
    return out if bias is None else out + bias.reshape((1, -1) + (1,) * spatial)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format, spatial, op_name):
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    channel_last = data_format in CHANNEL_LAST
    strides, dilations = _pair(stride, spatial), _pair(dilation, spatial)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _conv_padding(padding, spatial)
    if pads == "SAME":
        windows = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilations)]
        pads = same_pads(x.shape[2:], windows, strides)
    elif pads == "VALID":
        pads = [(0, 0)] * spatial
    elif isinstance(pads, str):
        raise ValueError(f"padding {padding!r}: 'SAME', 'VALID' or sizes")
    sym = [max(min(lo, hi), 0) for lo, hi in pads]
    x = pad_dims(x, [(lo - s, hi - s) for (lo, hi), s in zip(pads, sym)])
    out = _Convolution.apply(x, weight.to(x.dtype), list(strides), sym, list(dilations), False,
                             groups)
    out = _add_bias(out, bias, spatial)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 "NWC" if data_format == "NLC" else "NCW", 1, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, data_format, 2, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                    data_format, spatial, op_name):
    """The reference's gradient-of-conv transpose (``conv.py:97-150``): the
    strided input dilated, padded by ``d (k - 1) - p`` before and that plus
    ``output_padding`` after. Here the full transposed convolution (pads
    ``d (k - 1)``) is cropped or zero-padded to those pads: the rows it
    adds see only padding. A string padding is refused, as the
    reference's convolution refuses it with a dilated input."""
    if isinstance(padding, str):
        raise ValueError(f"padding {padding!r}: a transposed convolution takes pad sizes")
    x, weight, bias = cast_inputs(op_name, x, weight, bias)
    channel_last = data_format in CHANNEL_LAST
    strides, dilations = _pair(stride, spatial), _pair(dilation, spatial)
    if channel_last:
        x = x.movedim(-1, 1)
    p, op = _pair(padding, spatial), _pair(output_padding, spatial)
    out = _Convolution.apply(x, weight.to(x.dtype), list(strides), [0] * spatial,
                             list(dilations), True, groups)
    out = pad_dims(out, [(-int(p[i]), int(op[i]) - int(p[i])) for i in range(spatial)])
    out = _add_bias(out, bias, spatial)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCL", name=None):
    """``output_size`` is taken and ignored, as in the reference."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                           "NWC" if data_format == "NLC" else "NCW", 1, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCHW", name=None):
    """``output_size`` is taken and ignored, as in the reference."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                           data_format, 2, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1, output_size=None, data_format="NCDHW", name=None):
    """``output_size`` is taken and ignored, as in the reference."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                           data_format, 3, "conv3d_transpose")
