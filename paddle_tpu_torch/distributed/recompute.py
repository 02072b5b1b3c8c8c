"""Activation recompute, gradient checkpointing (counterpart of
``paddle_tpu/distributed/recompute.py``).

:func:`recompute` runs a block so that its activations are recomputed in
the backward instead of kept: ``torch.utils.checkpoint.checkpoint`` without
reentry, which re-runs the forward under the saved RNG state. A policy
name says what is kept:

- ``every_layer``: the block's inputs only (maximum recompute);
- ``selective``: the outputs of the matrix products (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``) are kept as well, and everything else
  (the elementwise tail, norms, attention, the hand-written kernels'
  forwards) is recomputed, as the reference's ``dots_saveable``;
- ``none``: no recompute.

A recomputed forward runs in autograd's thread; it takes the port's
thread-local state of the forward it repeats (the traced mark that picks
RMSNorm's rounding, the ``amp`` policy), so it computes the same values.

:func:`remat_scope` applies a policy to every repeated block of a model
(:func:`remat_targets`) for the duration of a ``with`` body: the mechanism
by which ``TrainStep(recompute_policy=...)`` recomputes without the model
opting in, as the reference's does.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp, tracing

__all__ = ["CHECKPOINT_POLICIES", "resolve_checkpoint_policy", "recompute", "remat_targets",
           "remat_scope", "recompute_sequential"]

#: the policy names the planner and ``TrainStep`` take
CHECKPOINT_POLICIES = ("none", "selective", "every_layer")

_aten = torch.ops.aten
#: the products whose outputs ``selective`` keeps
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_checkpoint_policy(name):
    """Policy name -> keywords of ``torch.utils.checkpoint.checkpoint``
    (None: no recompute). An unknown name raises ``ValueError``."""
    if name in (None, "none", ""):
        return None
    if name == "every_layer":
        return {}
    if name == "selective":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_saveable)}
    raise ValueError(
        f"unknown recompute policy {name!r} (want one of "
        f"{CHECKPOINT_POLICIES})")


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              checkpoint_policy=None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward under ``checkpoint_policy`` (None: ``every_layer``).
    ``use_reentrant`` is taken and ignored, as in the reference: the
    checkpoint is always the one without reentry. Without gradients it is
    the plain call."""
    ckpt_kwargs = resolve_checkpoint_policy(checkpoint_policy) or {}
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    was_traced = tracing.is_traced()
    s = amp.amp_state()
    cast = amp.auto_cast(s.enabled, s.custom_white, s.custom_black, level=s.level,
                         dtype=s.dtype)

    def run(*a, **k):
        with tracing.marked(was_traced), cast:
            return function(*a, **k)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=preserve_rng_state,
                      **ckpt_kwargs, **kwargs)


def remat_targets(model) -> list:
    """The blocks a policy wraps: the parameter-bearing children of every
    ``ModuleList`` / ``Sequential`` in ``model`` (``LayerList`` and the
    port's ``Sequential`` among them: transformer blocks, MLP stacks), in
    module order; the model's own parameter-bearing children when it holds
    no container."""
    targets, seen = [], set()
    for sub in model.modules():
        if isinstance(sub, (torch.nn.ModuleList, torch.nn.Sequential)):
            for child in sub.children():
                if id(child) not in seen and any(True for _ in child.parameters()):
                    targets.append(child)
                    seen.add(id(child))
    if not targets:
        for child in model.children():
            if id(child) not in seen and any(True for _ in child.parameters()):
                targets.append(child)
                seen.add(id(child))
    return targets


@contextlib.contextmanager
def remat_scope(model, policy):
    """Route every block of :func:`remat_targets` through :func:`recompute`
    with ``policy`` for the duration of the body (an unknown policy raises
    before any block is touched). Each block gets an instance ``forward``
    that is always removed on exit, so one model runs under several
    policies in turn."""
    if policy in (None, "none", ""):
        yield []
        return
    resolve_checkpoint_policy(policy)
    targets = remat_targets(model)
    installed = []
    try:
        for layer in targets:
            inner = layer.forward

            def wrapped(*a, _inner=inner, **k):
                return recompute(_inner, *a, checkpoint_policy=policy, **k)

            layer.forward = wrapped
            installed.append(layer)
        yield targets
    finally:
        for layer in installed:
            layer.__dict__.pop("forward", None)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split ``functions`` (a ``Sequential`` or a list of layers) into
    ``ctx["segments"]`` segments and recompute each."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    seg_size = max(len(layers) // max(segments, 1), 1)
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), seg_size):
        def seg_forward(x, _chunk=layers[i:i + seg_size]):
            for layer in _chunk:
                x = layer(x)
            return x

        out = recompute(seg_forward, out)
    return out
