"""On-device sampling head of the serving decode program (counterpart of
``paddle_tpu/inference/serving/sampling.py``).

The temperature / top-k / top-p math of the reference's per-lane head,
batched over the lanes with PER-LANE parameters as tensors, so one CUDA
graph of the decode program serves any mix of strategies:

- every lane carries its own (temperature, top_k, top_p, do_sample) as
  device tensors the engine writes at admission; ``top_k <= 0`` and
  ``top_p >= 1`` are no-ops expressed as selects (the filter is
  :func:`paddle_tpu_torch.random.filter_logits`, which the dense
  generator uses too);
- every lane carries its own threefry key (``[lanes, 2]``, see
  :mod:`paddle_tpu_torch.random`), split once a step: the new key is
  split 0, the draw's key split 1. The engine keeps the old key on an
  inactive lane, so a lane's key is a pure function of (seed, emitted
  tokens), as in the reference.

Greedy lanes (``do_sample`` False) take the argmax of the raw logits
through a select; their key still advances.
"""

from __future__ import annotations

import torch

from ... import random as R
from ...random import filter_logits

__all__ = ["sample_tokens", "filter_logits", "filtered_probs"]

def filtered_probs(lg, temperature, top_k, top_p):
    """Each lane's post-filter categorical distribution ``[lanes, V]`` f32:
    what :func:`sample_tokens` draws from."""
    scaled = lg.float() / temperature.clamp_min(1e-6)[:, None]
    return torch.softmax(filter_logits(scaled, top_k, top_p), dim=-1)


def sample_tokens(logits, keys, temperature, top_k, top_p, do_sample):
    """Per-lane pick: ``logits [lanes, V]``, ``keys [lanes, 2]`` (int64
    words), parameter vectors ``[lanes]``. Returns ``(tokens [lanes]
    int64, new keys [lanes, 2])``."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    filtered = filter_logits(scaled, top_k, top_p)
    pair = R.split(keys)                       # [lanes, 2 keys, 2 words]
    sampled = R.categorical(pair[:, 1], filtered)
    return torch.where(do_sample, sampled, greedy), pair[:, 0]
