"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``)."""

from __future__ import annotations

import torch.nn.functional as F

from ...amp import cast_inputs

__all__ = ["swiglu"]


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
