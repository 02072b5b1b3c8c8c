"""Weights carried from the reference into the port's models by key.

The port's modules keep the reference's parameter names, so a key maps to
the same key: ``llama.layers.N.self_attn.q_proj.weight``, an MoE decoder's
``llama.layers.N.mlp.gate.gate.weight`` and ``mlp.{w_up,w_gate,w_down}``,
ERNIE's heads, the vision models' convolutions and batch norms."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state_dict", "reference_state_dict", "set_state_dict"]


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
def set_state_dict(model: nn.Module, state: dict) -> tuple[list, list]:
    """Load ``{key: array or tensor}`` into ``model`` by the keys of
    :func:`reference_state_dict`, each value cast to its target's dtype
    and moved to its device; a shape that differs raises. Returns the
    model's keys missing from ``state`` and the keys of ``state`` the model
    lacks, both left alone (the reference's ``Layer.set_state_dict``)."""
    own = reference_state_dict(model)
    missing = []
    for key, target in own.items():
        if key not in state:
            missing.append(key)
            continue
        value = state[key]
        value = value if torch.is_tensor(value) else torch.as_tensor(np.array(value))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != {tuple(target.shape)}")
        target.copy_(value.to(dtype=target.dtype, device=target.device))
    return missing, [k for k in state if k not in own]


def load_reference_state_dict(model: nn.Module, state: dict) -> nn.Module:
    """Load ``{key: array}`` (the reference's ``model.state_dict()`` read as
    numpy) into ``model`` by key (:func:`set_state_dict`). A key that is
    missing or extra, or a shape that differs, raises."""
    own = reference_state_dict(model)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, extra {extra}")
    set_state_dict(model, state)
    return model
