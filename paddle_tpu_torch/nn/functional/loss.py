"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Softmax cross entropy with the reference's semantics (``loss.py:26``):
    log-softmax in f32 over ``axis``; hard labels with ``ignore_index``
    masked out of the loss and of the mean's denominator, an optional
    per-class ``weight`` (the mean then divides by the summed weights of the
    kept labels), uniform ``label_smoothing``; or ``soft_label``
    distributions. The hard-label loss gathers the label's column instead of
    building the reference's one-hot, which gives the same value and saves
    an [N, classes] f32 tensor."""
    if use_softmax:
        logp = torch.log_softmax(input.float(), dim=axis)
    else:
        logp = torch.log(torch.clamp_min(input.float(), 1e-30))
    logp = logp.movedim(axis, -1)
    n_classes = logp.shape[-1]
    if soft_label:
        soft = label.float().movedim(axis, -1)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        return _reduce(-(soft * logp).sum(dim=-1), reduction)
    li = label
    if li.dim() == logp.dim():          # a trailing class axis of size 1
        li = li.squeeze(axis)
    li = li.long()
    keep = li != ignore_index
    safe = torch.where(keep, li, torch.zeros_like(li)).clamp(0, n_classes - 1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        loss = -((1 - label_smoothing) * picked
                 + (label_smoothing / n_classes) * logp.sum(dim=-1))
    else:
        loss = -picked
    mask = keep.float()
    wv = None
    if weight is not None:
        wsel = weight.float()[safe]
        wv = wsel * mask
        loss = loss * wsel
    loss = loss * mask
    if reduction == "mean":
        denom = wv.sum() if wv is not None else mask.sum()
        return loss.sum() / torch.clamp_min(denom, 1e-12)
    return _reduce(loss, reduction)
