"""Weights carried from the reference into the port's models by key."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state_dict", "reference_state_dict"]


def reference_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` (its tensors themselves, not detached copies)
    with the reference's keys: a tensor listed once more under another name
    (a tied weight, such as ERNIE's MLM decoder ``cls._tied``) is left out
    after its first name, as the reference's ``state_dict`` lists each
    parameter once."""
    out, seen = {}, set()
    for key, t in model.state_dict(keep_vars=True).items():
        if id(t) not in seen:
            seen.add(id(t))
            out[key] = t
    return out


@torch.no_grad()
def load_reference_state_dict(model: nn.Module, state: dict) -> nn.Module:
    """Load ``{key: array}`` (the reference's ``model.state_dict()`` read as
    numpy) into ``model`` by key (:func:`reference_state_dict`), each array
    cast to its parameter's dtype and moved to its device. A key that is
    missing or extra, or a shape that differs, raises."""
    own = reference_state_dict(model)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, extra {extra}")
    for key, target in own.items():
        arr = torch.as_tensor(np.array(state[key]))
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(target.shape)}")
        target.copy_(arr.to(dtype=target.dtype, device=target.device))
    return model
