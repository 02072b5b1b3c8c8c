"""Checkpoints of a ``PartitionedTrainStep`` (counterpart of
``paddle_tpu/distributed/partitioning/checkpoint.py:33-142``).

:func:`save_partitioned` writes the step's parameters (``model.<name>``),
buffers (``buffers.<name>``), optimizer state (``opt.<name>.<slot>``, on
its slices) and step count (``step.count``) through
:func:`~paddle_tpu_torch.distributed.checkpoint.save_state_dict`, each
rank its slices, and rank 0 a ``sharding_manifest.json`` (the mesh, the
rules, every entry's shape and spec). :func:`load_partitioned` restores
them into a step over any mesh: each rank reads its slices from whatever
shards were written (a Mixture-of-Experts layer's expert slices over
``dp`` or ``tensor`` too: saved at dp 2, loaded whole at one rank).
"""

from __future__ import annotations

import json
import os

import torch

from .. import env as _env
from ..checkpoint import load_state_dict, save_state_dict

__all__ = ["MANIFEST_NAME", "save_partitioned", "load_partitioned", "read_sharding_manifest"]

MANIFEST_NAME = "sharding_manifest.json"


def _state(step):
    """``{section: {name: tensor}}`` of the step (its optimizer state made
    when missing, so that it can be loaded into)."""
    model, opt = step.model, step.optimizer
    inner = getattr(opt, "_inner_opt", opt)
    update = step.partitioner.update
    state = {"model": dict(model.named_parameters()),
             "buffers": dict(model.named_buffers()),
             "opt": {}, "step": {"count": torch.tensor(inner._step_count, dtype=torch.int64)}}
    for name, p in model.named_parameters():
        if p.requires_grad:
            state["opt"][name] = update.state_of(type(inner), p)
    return state


def _walk(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _walk(v, name)
        else:
            yield name, v


def save_partitioned(step, path, include_opt=True, async_save=False) -> dict:
    """Checkpoint ``step`` to the directory ``path``; returns the sharding
    manifest."""
    state = _state(step)
    if not include_opt:
        state.pop("opt")
    save_state_dict(state, path, async_save=async_save)
    entries = {}
    for name, t in _walk(state):
        info = getattr(t, "dist_shard", None)
        spec = getattr(t, "parallel_spec", None)
        entries[name] = {"shape": list(info.full_shape if info is not None else t.shape),
                         "spec": [list(e) if isinstance(e, tuple) else e for e in spec]
                         if spec is not None else []}
    manifest = {"format": 1, "partitioner": step.partitioner.describe(), "entries": entries}
    if _env.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, MANIFEST_NAME))
    return manifest


def read_sharding_manifest(path):
    """The sharding manifest at ``path``, None when there is none."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def load_partitioned(step, path) -> dict:
    """Restore ``step`` from ``path`` under its own mesh; returns
    ``{"resharded", "saved_mesh", "mesh"}``."""
    state = _state(step)
    load_state_dict(state, path)
    inner = getattr(step.optimizer, "_inner_opt", step.optimizer)
    inner._step_count = int(state["step"]["count"])
    here = step.partitioner.describe()["mesh"]
    saved = (read_sharding_manifest(path) or {}).get("partitioner", {}).get("mesh")
    return {"resharded": saved is not None and saved != here, "saved_mesh": saved, "mesh": here}
