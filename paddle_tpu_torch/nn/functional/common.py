"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``)."""

from __future__ import annotations

import torch

from ...amp import cast_inputs

__all__ = ["linear", "embedding"]


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
