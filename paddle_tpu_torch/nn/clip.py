"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py:130-200``).

A clipper is a callable over a ``[(param, grad)]`` list that returns the
list with clipped gradients; ``grad`` may be None. :func:`clip_grads` is the
core both the optimizers and ``TrainStep`` use. It follows the reference's
per-gradient (eager) regime; ROADMAP queue 3 says why that regime is the
one held against.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grads"]


def _norm(g):
    """L2 norm of ``g`` summed in f32, in one pass over ``g`` (no f32 copy
    of it is made)."""
    return torch.linalg.vector_norm(g, dtype=torch.float32)


def clip_grads(clip, grads, need_clip=None):
    """``grads`` (a list of tensors) clipped by ``clip`` (a clipper or
    None); ``need_clip`` is a per-gradient mask that only the global-norm
    clipper honours, as in the reference."""
    grads = list(grads)
    if clip is None:
        return grads
    if need_clip is None:
        need_clip = [True] * len(grads)
    if isinstance(clip, ClipGradByGlobalNorm):
        sq = [_norm(g).square() for g, nc in zip(grads, need_clip) if nc]
        if not sq:
            return grads
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        gnorm = torch.sqrt(total)
        scale = clip.clip_norm / torch.clamp_min(gnorm, clip.clip_norm)
        return [(g * scale).to(g.dtype) if nc else g for g, nc in zip(grads, need_clip)]
    if isinstance(clip, ClipGradByNorm):
        out = []
        for g in grads:
            norm = _norm(g)
            scale = torch.clamp_max(clip.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((g * scale).to(g.dtype))
        return out
    if isinstance(clip, ClipGradByValue):
        return [torch.clamp(g, clip.min, clip.max) for g in grads]
    raise TypeError(f"unknown gradient clipper {type(clip).__name__}")


class _ClipBase:
    def __call__(self, params_grads):
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        flags = [getattr(params_grads[i][0], "need_clip", True) for i in idx]
        clipped = clip_grads(self, [params_grads[i][1] for i in idx], flags)
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
    ``need_clip`` (default True)."""

    def __init__(self, clip_norm=1.0, group_name="default_group", auto_skip_clip=False):
        if auto_skip_clip:
            raise NotImplementedError("auto_skip_clip comes with a later slice of the port")
        self.clip_norm = float(clip_norm)
