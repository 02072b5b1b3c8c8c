"""The forward pipeline rotation and its stacking helpers (counterpart of
``paddle_tpu/distributed/fleet/pipeline_engine.py:28-103``).

:func:`pipeline_apply` runs the GPipe rotation forward over the pipe
group of the current mesh, one process a stage: stage 0 takes the
microbatches of ``x`` in turn, every stage runs ``stage_fn`` on its own
parameters and sends the result to the next, and the last stage's outputs
are the result, broadcast to the pipe group when asked (else zeros
elsewhere, as the reference's masked buffer). The reference's rotation is
a compiled loop whose hop is ``ppermute``; here the hop is a send to the
next stage (:mod:`._pipe_p2p`). :func:`stack_stage_params` stacks
per-layer parameter trees into ``[P, L / P, ...]`` and
:func:`scan_layers` runs a stack of identical layers in a loop over its
slices (a Layer through ``torch.func.functional_call``).
"""

from __future__ import annotations

import torch

from .. import collective as C
from ..mesh import get_mesh
from ._pipe_p2p import StageLink

__all__ = ["pipeline_apply", "stack_stage_params", "scan_layers"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _zip_map(fn, [t[k] for t in trees])) for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, list(ts)) for ts in zip(*trees))
    return fn(*trees)


def pipeline_apply(stage_fn, stage_params, x, *, num_stages: int, num_microbatches: int,
                   axis_name: str = "pp", broadcast_output: bool = True):
    """``stage_fn(this stage's params, activation) -> activation`` over the
    ``axis_name`` axis of the current mesh. ``stage_params``:
    this stage's tree, each leaf with a leading stage dim of 1, which is
    squeezed. ``x`` ``[B, ...]`` is read by stage 0 only, in
    ``num_microbatches`` contiguous microbatches; stage io shapes are
    uniform. Returns ``[B, ...]``: the last stage's, on every stage when
    ``broadcast_output``."""
    mesh = get_mesh()
    if mesh is None or axis_name not in mesh.dim_names:
        raise ValueError(f"pipeline_apply needs a mesh with a {axis_name!r} axis "
                         "(dist.ProcessMesh / set_mesh)")
    if mesh.get_dim_size(axis_name) != num_stages:
        raise ValueError(f"num_stages={num_stages} on a {axis_name!r} axis of "
                         f"{mesh.get_dim_size(axis_name)}: one process a stage")
    x = torch.as_tensor(x)
    link = StageLink(mesh.get_group(axis_name), mesh.axis_ranks(axis_name), x.device)
    P, M, p = num_stages, num_microbatches, link.stage
    local = _map(lambda t: t[0], stage_params)
    mb = x.shape[0] // M
    x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
    # stage 0's first output tells every stage the activations' shape and dtype
    h0 = stage_fn(local, x_mb[0]) if p == 0 else None
    box = [None if h0 is None else (tuple(h0.shape), h0.dtype)]
    if P > 1:
        C.broadcast_object_list(box, src=link.ranks[0], group=link.group)
    meta = box[0]
    if meta[0] != tuple(x_mb[0].shape):
        raise ValueError("pipeline_apply requires uniform stage io shapes; run "
                         "embedding/head outside the pipelined region")
    outs = []
    for m in range(M):
        if p == 0:
            h = h0 if m == 0 else stage_fn(local, x_mb[m])
        else:
            h = stage_fn(local, link.exchange([], [(p - 1, meta[0], meta[1])])[0])
        if p < P - 1:
            link.exchange([(p + 1, h.to(meta[1]))], [])
        else:
            outs.append(h)
    out = (torch.cat(outs) if outs else
           torch.zeros((M * mb,) + tuple(meta[0][1:]), dtype=meta[1], device=x.device))
    if broadcast_output:
        link.broadcast([out], P - 1)
    return out


def stack_stage_params(per_layer_params: list, num_stages: int):
    """Per-layer trees ``[L]`` -> one tree of ``[P, L // P, ...]`` leaves
    (uniform segments)."""
    L = len(per_layer_params)
    assert L % num_stages == 0, f"{L} layers not divisible into {num_stages} stages"
    chunk = L // num_stages
    stacked = _zip_map(lambda *xs: torch.stack([torch.as_tensor(a) for a in xs]),
                       per_layer_params)
    return _map(lambda leaf: leaf.reshape((num_stages, chunk) + tuple(leaf.shape[1:])),
                stacked)


def scan_layers(layer_fn, stacked_params, h, unroll: int = 1):
    """Run ``[L, ...]`` stacked layers in order: ``layer_fn(slice, h)``, or
    for a Layer ``torch.func.functional_call(layer_fn, slice, (h,))``.
    ``unroll`` is taken and has no effect (an eager loop)."""
    leaves = []
    _map(leaves.append, stacked_params)
    n = leaves[0].shape[0] if leaves else 0
    for i in range(n):
        params = _map(lambda t: t[i], stacked_params)
        if isinstance(layer_fn, torch.nn.Module):
            h = torch.func.functional_call(layer_fn, params, (h,))
        else:
            h = layer_fn(params, h)
    return h
