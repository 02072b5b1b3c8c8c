"""Paged attention over the block pool (counterpart of
``paddle_tpu/inference/serving/paged_attention.py``).

- :class:`PagedKVView` is the ``append``/``attend`` cache adapter of
  :func:`models.llama.decode_step` for one token per lane: ``append``
  scatters each lane's new K/V row at its own position ``lengths[lane]``,
  ``attend`` runs paged decode attention through
  :func:`ops.paged_attention.paged_decode_attention` (the CUDA kernel on
  the card, the composed gather + ``masked_attend`` on the CPU).
- :func:`prefill_attend` is the multi-query flavour of chunked prefill:
  the C tokens of one lane's chunk attend causally over that lane's
  gathered window. It stays composed, as in the reference.
- :func:`window_attend` is the speculative verify's flavour: every lane's
  C positions attend over its own gathered window at once (composed, as
  in the reference).

The pool is read only through the block tables, so lanes whose tables
alias the same pages (prefix-cache hits) read them as their own; the only
writes are ``append`` at each lane's ``lengths`` and the prefill and
verify scatters past every shared block (the engine forks a shared block
a lane would write before the lane activates).
"""

from __future__ import annotations

import torch

from ...ops.paged_attention import paged_decode_attention

__all__ = ["PagedKVView", "gather_lane_window", "prefill_attend", "window_attend"]


def gather_lane_window(pages, block_table):
    """pages [nb, bs, Hk, hd]; block_table [b, MB] -> [b, MB*bs, Hk, hd]:
    each lane's logical window, its pages gathered in table order
    (unassigned entries read trash block 0; callers mask by length)."""
    b, mb = block_table.shape
    win = pages[block_table.long()]                   # [b, MB, bs, Hk, hd]
    return win.reshape(b, mb * pages.shape[1], pages.shape[2], pages.shape[3])


class PagedKVView:
    """Adapter over the paged pool for :func:`decode_step`.

    ``pages_k/v`` [L, nb, bs, Hk, hd]; ``block_table`` [lanes, MB] int32;
    ``lengths`` int32 and ``active`` bool [lanes], all on the pool's
    device. ``append`` writes INTO the pool tensors in place (the reference
    returns updated, donated arrays instead); inactive lanes write to the
    trash block 0.
    """

    def __init__(self, pages_k, pages_v, block_table, lengths, active,
                 block_size: int):
        self.pages_k = pages_k
        self.pages_v = pages_v
        self.block_table = block_table
        self.lengths = lengths
        self.active = active
        self.block_size = int(block_size)
        pos = lengths.long()
        blk = pos // self.block_size
        self._off = pos - blk * self.block_size
        phys = torch.gather(block_table.long(), 1, blk[:, None])[:, 0]
        self._phys = torch.where(active, phys, torch.zeros_like(phys))

    def append(self, li, k, v):
        self.pages_k[li, self._phys, self._off] = k
        self.pages_v[li, self._phys, self._off] = v

    def attend(self, li, q):
        return paged_decode_attention(q, self.pages_k[li], self.pages_v[li],
                                      self.block_table, self.lengths)


def prefill_attend(q, kc, vc, qpos):
    """Chunked-prefill attention for one lane. q [1, C, H, hd]; kc/vc
    [1, S, Hk, hd] the lane's gathered window (chunk rows already written);
    qpos [C] absolute positions. Each query sees slots ``<=`` its own
    position; softmax in f32. Returns [1, C, H, hd]."""
    H, hd = q.shape[2], q.shape[3]
    rep = H // kc.shape[2]
    kfull = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
    vfull = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bqhd,bshd->bhqs", q, kfull).float() * scale
    s = torch.arange(kc.shape[1], device=q.device)
    visible = s[None, :] <= qpos[:, None]                     # [C, S]
    logits = logits.masked_fill(~visible[None, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vfull)


def window_attend(q, kc, vc, visible):
    """Multi-query attention for every lane at once: each lane's C
    positions against its own gathered window. q [b, C, H, hd]; kc/vc
    [b, S, Hk, hd]; visible [b, C, S] bool. Logits scaled by 1/sqrt(hd),
    softmax in f32, probabilities cast to q's dtype. Returns
    [b, C, H, hd]."""
    H, hd = q.shape[2], q.shape[3]
    rep = H // kc.shape[2]
    kfull = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
    vfull = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
    scale = 1.0 / float(hd) ** 0.5
    logits = torch.einsum("bqhd,bshd->bhqs", q, kfull).float() * scale
    logits = logits.masked_fill(~visible[:, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vfull)
