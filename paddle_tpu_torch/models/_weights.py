"""Weights carried from the reference into the port's models by key.

The port's modules keep the reference's parameter names, so a key maps to
the same key: ``llama.layers.N.self_attn.q_proj.weight``, an MoE decoder's
``llama.layers.N.mlp.gate.gate.weight`` and ``mlp.{w_up,w_gate,w_down}``,
ERNIE's heads, the vision models' convolutions and batch norms. Every
model of the port is an ``nn.Layer``, whose ``state_dict`` and
``set_state_dict`` are the reference's; ``reference_state_dict`` and
``set_state_dict`` here (those of ``nn.layer.layers``) take any
``torch.nn.Module``."""

from __future__ import annotations

from ..nn.layer.layers import reference_state_dict, set_state_dict

__all__ = ["load_reference_state_dict", "reference_state_dict", "set_state_dict"]


def load_reference_state_dict(model, state: dict):
    """Load ``{key: array}`` (the reference's ``model.state_dict()`` read as
    numpy) into ``model`` by key (:func:`set_state_dict`). A parameter that
    the distributed tier keeps as a slice (``dist_shard``: its tensor slice,
    at rest its slice of that) takes its part of the full array. A key that
    is missing or extra, or a shape that differs, raises."""
    own = reference_state_dict(model)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, extra {extra}")
    state = dict(state)
    for key, target in own.items():
        info = getattr(target, "dist_shard", None)
        value = state[key]
        if info is not None and tuple(value.shape) == tuple(info.full_shape) \
                and tuple(target.shape) != tuple(info.full_shape):
            state[key] = value[info.held_index]
    set_state_dict(model, state)
    return model
