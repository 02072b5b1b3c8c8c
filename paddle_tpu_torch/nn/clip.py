"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clipper is a callable over a ``[(param, grad)]`` list that returns the
list with clipped gradients; ``grad`` may be None. The functional layer is
the reference's: :func:`clip_descriptor` names a clipper as a tuple,
:func:`functional_clip_leaves` applies it to a list of tensors. Every
regime clips through it: the clippers' calls, the per-parameter optimizer
step, ``TrainStep`` and the fused optimizer step. The global-norm clipper's
scale is one 0-dim f32 tensor (:func:`global_norm_scale`) and a gradient
is scaled as :func:`scale_grad` does, ``round(g * scale)`` in f32 rounded
once to the gradient's dtype, which the fused step's kernel repeats
element by element; so the two regimes agree in every bit. A clipper's
call in the fused regime (``PADDLE_OPT_FUSED`` not 0) counts
``clip.fused_calls`` in the registry, as the reference's one-dispatch
clippers do (its compiled-clip cache counters have no counterpart: the
port compiles nothing).
"""

from __future__ import annotations

import torch

from ..profiler import telemetry as _telemetry

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_descriptor",
           "clip_grad_norm_", "functional_clip_leaves", "global_norm_scale",
           "scale_grad"]


def _norm(g):
    """L2 norm of ``g`` summed in f32, in one pass over ``g`` (no f32 copy
    of it is made)."""
    return torch.linalg.vector_norm(g, dtype=torch.float32)


def clip_descriptor(clip):
    """A clipper as a tuple: None for no clipping, ``("global_norm",
    clip_norm)``, ``("norm", clip_norm)``, ``("value", min, max)``, or
    NotImplemented for a callable the functional layer cannot express (the
    optimizer then takes its per-parameter loop)."""
    if clip is None:
        return None
    if type(clip) is ClipGradByGlobalNorm:
        return ("global_norm", clip.clip_norm)
    if type(clip) is ClipGradByNorm:
        return ("norm", clip.clip_norm)
    if type(clip) is ClipGradByValue:
        return ("value", clip.min, clip.max)
    return NotImplemented


def global_norm_scale(clip_norm: float, grads, need_clip):
    """``clip_norm / max(global_norm, clip_norm)`` as a 0-dim f32 tensor on
    the gradients' device, the norm taken in f32 over the gradients whose
    ``need_clip`` is set; None when none is."""
    sq = [_norm(g).square() for g, nc in zip(grads, need_clip) if nc]
    if not sq:
        return None
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return clip_norm / torch.clamp_min(torch.sqrt(total), clip_norm)


def scale_grad(g, scale):
    """``g * scale`` in f32, rounded once to ``g``'s dtype (the reference's
    ``(g * scale).astype(g.dtype)`` with an f32 scale)."""
    return (g.float() * scale).to(g.dtype)


def functional_clip_leaves(desc, grads, need_clip):
    """``grads`` (a list of tensors) clipped as ``desc`` says;
    ``need_clip`` is a per-gradient mask that only the global-norm clip
    honours, as in the reference."""
    grads = list(grads)
    if desc is None:
        return grads
    kind = desc[0]
    if kind == "global_norm":
        scale = global_norm_scale(desc[1], grads, need_clip)
        if scale is None:
            return grads
        return [scale_grad(g, scale) if nc else g for g, nc in zip(grads, need_clip)]
    if kind == "norm":
        out = []
        for g in grads:
            scale = torch.clamp_max(desc[1] / torch.clamp_min(_norm(g), 1e-12), 1.0)
            out.append(scale_grad(g, scale))
        return out
    if kind == "value":
        _, vmin, vmax = desc
        return [torch.clamp(g, vmin, vmax) for g in grads]
    raise NotImplementedError(f"unknown clip descriptor {desc!r}")


_CLIP_CALLS = _telemetry.counter("clip.fused_calls")


class _ClipBase:
    def __call__(self, params_grads):
        from ..optimizer.fused_step import fused_enabled

        if fused_enabled():
            _CLIP_CALLS.value += 1
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        flags = [getattr(params_grads[i][0], "need_clip", True) for i in idx]
        desc = clip_descriptor(self)
        if desc is NotImplemented:
            raise TypeError(f"unknown gradient clipper {type(self).__name__}")
        clipped = functional_clip_leaves(desc, [params_grads[i][1] for i in idx], flags)
        out = list(params_grads)
        for i, g in zip(idx, clipped):
            out[i] = (params_grads[i][0], g)
        return out


class ClipGradByValue(_ClipBase):
    """Clamp every gradient to ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(-max if min is None else min)


class ClipGradByNorm(_ClipBase):
    """Scale each gradient whose L2 norm exceeds ``clip_norm`` down to it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByGlobalNorm(_ClipBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken in f32 over the gradients whose parameter has
    ``need_clip`` (default True). ``group_name`` and ``auto_skip_clip`` are
    taken and ignored, as in the reference."""

    def __init__(self, clip_norm=1.0, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of every parameter in place by ``min(max_norm /
    max(total, 1e-6), 1)``, ``total`` the ``norm_type`` norm of all of them
    in f32; returns ``total`` (``paddle.nn.utils.clip_grad_norm_``;
    ``error_if_nonfinite`` is taken and ignored, as in the reference)."""
    if torch.is_tensor(parameters):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = sum(torch.sum(g.float().abs().pow(norm_type)) for g in grads)
        total = total.pow(1.0 / norm_type)
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    for g in grads:
        g.copy_(scale_grad(g, scale))
    return total
