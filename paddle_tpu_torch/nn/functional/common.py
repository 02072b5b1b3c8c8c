"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``)."""

from __future__ import annotations

import torch

from ...amp import cast_inputs

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight layout; the
    weight and bias are cast to x's dtype (under ``amp.auto_cast`` the
    inputs first as the op ``linear``)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight [vocab, dim]`` gathered by the integer ids ``x``;
    rows of ``padding_idx`` come out as zeros (so they get no gradient).
    The gradient is a scatter-add into the table, with ``sparse`` too (the
    reference takes the dense gradient either way)."""
    weight, = cast_inputs("embedding", weight)
    idx = x.long()
    out = weight[idx]
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0)
    return out


def _keep(shape, p, generator, device):
    """The keep mask: each element kept with probability ``1 - p``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None, *,
            generator=None):
    """Paddle's ``dropout``. In training each element (with ``axis``, each
    slice along the other axes: one draw for every index of ``axis``) is
    kept with probability ``1 - p``; ``upscale_in_train`` divides the kept
    values by ``1 - p`` (rounded to x's dtype, as the reference's weak
    scalar is), ``downscale_in_infer`` keeps them as they are and
    multiplies by ``1 - p`` outside training. ``p == 0``, or eval mode in
    ``upscale_in_train``, returns ``x`` itself (the reference returns a
    copy of it, and no op, so nothing is cast there); ``p == 1`` in
    training gives zeros. The mask is torch's bits, drawn from
    ``generator`` (the reference draws from its global key). Under
    ``amp.auto_cast`` x is first cast as the op ``dropout``."""
    if not training or p == 0:
        if mode == "downscale_in_infer" and not training:
            x, = cast_inputs("dropout", x)
            return x * torch.full((), 1 - p, dtype=x.dtype, device=x.device)
        return x
    x, = cast_inputs("dropout", x)
    if p == 1:
        return x * 0
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(shape, p, generator, x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        # a 0-dim tensor on x's device: a true division, where a Python
        # scalar becomes a multiply by its reciprocal on the card
        return torch.where(keep, x / torch.full((), 1.0 - p, dtype=x.dtype, device=x.device),
                           zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *, generator=None):
    """Whole channels of a 4-D ``x`` dropped: one draw for each (N, C)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *, generator=None):
    """Whole channels of a 5-D ``x`` dropped: one draw for each (N, C)."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """Dropout for SELU networks: a dropped element becomes ``-alpha *
    scale`` of SELU, then an affine map keeps the mean and variance.
    Outside training, or at ``p == 0``, ``x`` itself."""
    if not training or p == 0:
        return x
    x, = cast_inputs("alpha_dropout", x)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep(x.shape, p, generator, x.device)
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    dropped = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a_coef * torch.where(keep, x, dropped) + b_coef).to(x.dtype)
