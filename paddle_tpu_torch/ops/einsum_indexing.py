"""Indexing (counterpart of ``paddle_tpu/ops/einsum_indexing.py``). The
reference patches ``__getitem__`` / ``__setitem__`` onto its tensor; the
port's tensors are torch's, which index natively, so these are plain
functions: index lists and numpy arrays become tensors on ``x``'s device
(int32 indices included), and a value is cast to ``x``'s dtype."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["getitem", "setitem"]


def _norm_index(item, device):
    if isinstance(item, tuple):
        return tuple(_norm_index(i, device) for i in item)
    if isinstance(item, (list, np.ndarray)):
        item = torch.as_tensor(np.asarray(item), device=device)
    if isinstance(item, torch.Tensor) and item.dtype not in (torch.bool, torch.uint8):
        return item.long()
    return item


def getitem(x: torch.Tensor, item):
    return x[_norm_index(item, x.device)]


def setitem(x: torch.Tensor, item, value):
    """``x[item] = value`` in place (autograd records it); returns ``x``."""
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else value
    x[_norm_index(item, x.device)] = v
    return x
