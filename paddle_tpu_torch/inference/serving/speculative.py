"""Draft-model speculative decoding (counterpart of
``paddle_tpu/inference/serving/speculative.py``).

A speculative engine replaces the one-token decode program with two
programs of fixed shape, each one CUDA graph on the card:

- draft decode: a small draft model runs one token ahead for every lane
  on a dense per-lane cache (:class:`DenseLaneKV`). A call reads its
  column ``j`` from a static input buffer, writes its input token, its
  filtered proposal distribution q and its proposal into device round
  buffers at that column, so the k-step lookahead is k replays of one
  graph. The same program replays committed tokens into the draft cache
  (catch-up after admission), gated per lane by the ``advance`` mask.
- verify: all k+1 positions of every lane (the committed token and the k
  proposals) in one batched target step over the paged pool (a
  multi-query causal attend, :func:`.paged_attention.window_attend`,
  over each lane's own pages), then acceptance on the device.

Acceptance is the speculative-sampling rule of Leviathan et al. and Chen
et al.: draft token d_j is accepted with probability ``min(1, p(d_j) /
q(d_j))``; the first rejection resamples from ``normalize(max(p - q,
0))``; a round that accepts everything takes a bonus token from the
target's (k+1)-th distribution. Greedy lanes accept by argmax equality
and take the target's argmax at the first mismatch, so greedy speculation
gives the non-speculative engine's tokens.

Rollback is host state: the engine advances each lane's ``lengths`` by
the accepted count only; the rejected positions' page writes are dead
bytes the next round's scatter overwrites before any query sees them.

No key state advances: every draw folds out of ``(PRNGKey(seed),
round-start length, tag, column)`` (:func:`spec_key`), a function of the
committed stream alone, so sampled outputs replay bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import random as R
from ...models.llama import (
    decode_matmul, decode_rms, decode_step, masked_attend, rope_rotate, rope_tables,
)
from .paged_attention import gather_lane_window, window_attend

__all__ = ["DraftConfig", "DenseLaneKV", "accept", "build_draft_fn", "build_verify_fn",
           "spec_key"]

#: key-derivation tags, one a draw site: a proposal, an acceptance coin and
#: a resample at the same (length, column) never share a key
TAG_DRAFT, TAG_ACCEPT, TAG_FINAL = 0, 1, 2


@dataclass
class DraftConfig:
    """Speculation parameters: a small draft ``LlamaForCausalLM`` and the
    lookahead depth ``k``."""

    model: object
    k: int = 4

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(
                f"DraftConfig.k must be >= 1 (got {self.k}): a 0-token lookahead is "
                "the non-speculative engine")
        self.k = int(self.k)


def spec_key(base, length, tag, j):
    """The key of one draw: the lane's seed key ``base [..., 2]`` folded
    with the round-start committed length, the draw site's tag and the
    column (each an int or a tensor broadcast against the keys)."""
    return R.fold_in(R.fold_in(R.fold_in(base, length), tag), j)


class DenseLaneKV:
    """Dense per-lane KV adapter of the draft model: caches ``[lanes, DL,
    Hk, hd]`` a layer, written in place at each lane's own position. The
    ``advance`` mask write-protects idle lanes (a dense cache has no trash
    block: a protected lane writes back its own bytes)."""

    def __init__(self, caches, pos, advance, max_len: int):
        self.caches = caches
        self.pos = pos
        self.advance = advance
        self.max_len = int(max_len)
        self._idx = torch.arange(pos.shape[0], device=pos.device)
        self._p = pos.long().clamp(0, self.max_len - 1)

    def append(self, li, k, v):
        kc, vc = self.caches[li]
        guard = self.advance[:, None, None]
        i, p = self._idx, self._p
        kc[i, p] = torch.where(guard, k, kc[i, p])
        vc[i, p] = torch.where(guard, v, vc[i, p])

    def attend(self, li, q):
        kc, vc = self.caches[li]
        visible = (torch.arange(self.max_len, device=q.device)[None, :]
                   <= self.pos.long()[:, None])
        return masked_attend(q, kc, vc, visible)


def _probs(lg, temp, topk, topp):
    """Each row's post-filter distribution (f32) of logits ``[b, n, V]``
    under its lane's temperature, top-k and top-p ``[b]``."""
    b, n, V = lg.shape
    scaled = lg.float() / temp.clamp_min(1e-6)[:, None, None]
    rows = R.filter_logits(scaled.reshape(b * n, V), topk.repeat_interleave(n),
                           topp.repeat_interleave(n))
    return torch.softmax(rows, dim=-1).reshape(b, n, V)


def build_draft_fn(draft_cfg, k: int, max_len: int):
    """One draft step at column ``j`` for every lane; ``toks [lanes,
    k+1]``, ``qbuf [lanes, k, V]`` and the caches are written in place.

    ``draft_fn(dw, tok_push, toks, qbuf, caches, pos, advance, base_keys,
    round_start, j, temp, topk, topp, do)``

    The step's input token is ``tok_push`` at ``j == 0`` (round start or
    catch-up: the host knows it) and ``toks[:, j]`` otherwise (the step
    before's proposal, never read by the host). It writes its input at
    column ``j``, its proposal at ``j + 1`` and q at ``j``, so after n
    steps ``toks[:, :n+1]`` is the verify's input row; catch-up writes
    land on columns the round's first step writes again. ``j`` is a
    one-element device tensor."""

    def draft_fn(dw, tok_push, toks, qbuf, caches, pos, advance, base_keys,
                 round_start, j, temp, topk, topp, do):
        lanes = toks.shape[0]
        jj = j.reshape(1, 1).expand(lanes, 1)
        prev = torch.gather(toks, 1, jj.clamp(0, k))[:, 0]
        tok = torch.where(j.reshape(1) == 0, tok_push, prev)
        kv = DenseLaneKV(caches, pos, advance, max_len)
        logits = decode_step(draft_cfg, dw, tok, kv, pos)
        scaled = logits.float() / temp.clamp_min(1e-6)[:, None]
        filt = R.filter_logits(scaled, topk, topp)
        q = torch.softmax(filt, dim=-1)
        key = spec_key(base_keys, round_start, TAG_DRAFT, j.reshape(1))
        prop = torch.where(do, R.categorical(key, filt), torch.argmax(logits, dim=-1))
        toks.scatter_(1, jj, tok[:, None].to(toks.dtype))
        toks.scatter_(1, jj + 1, prop[:, None].to(toks.dtype))
        qbuf.index_copy_(1, j.reshape(1), q[:, None, :])

    return draft_fn


def accept(lg, toks, q, base, ln, n_draft, temp, topk, topp, do, k: int):
    """Acceptance for every lane at once (the reference's ``_accept_lane``
    over lanes): target logits ``[b, k+1, V]``, round tokens ``[b, k+1]``
    (committed and proposals), draft distributions ``[b, k, V]`` ->
    (tokens ``[b, k+1]``, emitted count ``[b]``). Columns past the live
    ``n_draft`` (a one-element tensor) are rejected."""
    b = lg.shape[0]
    dev = lg.device
    p = _probs(lg, temp, topk, topp)                              # [b, k+1, V]
    greedy = torch.argmax(lg, dim=-1)                             # [b, k+1]
    d = toks[:, 1:].long()                                        # [b, k]
    cols = torch.arange(k, device=dev)
    p_d = torch.gather(p[:, :k], 2, d[..., None])[..., 0]
    q_d = torch.gather(q, 2, d[..., None])[..., 0]
    u = R.uniform(spec_key(base[:, None, :], ln[:, None], TAG_ACCEPT, cols[None, :]), ())
    # u <= p / q without the division; never accept where q is 0 (the
    # draft proposed a token its own filter removed)
    acc_sampled = (u * q_d <= p_d) & (q_d > 0)
    acc = torch.where(do[:, None], acc_sampled, greedy[:, :k] == d)
    acc = acc & (cols[None, :] + 1 <= n_draft.reshape(1, 1))
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)          # [b]
    # the round's last token comes from the target's column n_acc: the
    # residual after a rejection, the bonus p after a clean sweep; greedy
    # lanes take its argmax
    rows = torch.arange(b, device=dev)
    p_fin = p[rows, n_acc]
    q_fin = q[rows, n_acc.clamp(max=k - 1)]
    res = torch.clamp_min(p_fin - q_fin, 0.0)
    rs = res.sum(dim=-1, keepdim=True)
    res = torch.where(rs > 0, res / torch.where(rs > 0, rs, torch.ones_like(rs)), p_fin)
    fin_probs = torch.where((n_acc < n_draft.reshape(1))[:, None], res, p_fin)
    drawn = R.categorical(spec_key(base, ln, TAG_FINAL, n_acc), torch.log(fin_probs + 1e-30))
    fin = torch.where(do, drawn, greedy[rows, n_acc])
    i = torch.arange(k + 1, device=dev)[None, :]
    shifted = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    out = torch.where(i < n_acc[:, None], shifted,
                      torch.where(i == n_acc[:, None], fin[:, None], torch.zeros_like(shifted)))
    return out, n_acc + 1


def build_verify_fn(mcfg, k: int, block_size: int, max_blocks: int):
    """The target's verify step for every lane: k+1 positions a lane
    scattered into the lane's own pages (inactive lanes, and positions
    past the lane's reservation, write to trash block 0), causal attention
    over each lane's gathered window, then :func:`accept`.

    ``verify_fn(w, toks, pages_k, pages_v, block_table, lengths, active,
    base_keys, qbuf, n_draft, temp, topk, topp, do) -> (tokens [lanes,
    k+1], n_emit [lanes])``; the pages are written in place."""
    C = k + 1
    H = mcfg.num_attention_heads
    Hk = mcfg.num_key_value_heads
    hd = mcfg.hidden_size // H
    eps = mcfg.rms_norm_eps
    bs = int(block_size)
    MB = int(max_blocks)

    def verify_fn(w, toks, pages_k, pages_v, bt, ln, ac, base_keys, qbuf, n_draft,
                  temp, topk, topp, do):
        b = toks.shape[0]
        dev = toks.device
        h = w["embed"][toks.long()]                              # [b, C, hidden]
        pos = ln.long()[:, None] + torch.arange(C, device=dev)[None, :]
        sin, cos = rope_tables(pos, mcfg.rope_theta, hd)
        sin4, cos4 = sin[:, :, None, :], cos[:, :, None, :]
        blk = torch.clamp(pos // bs, 0, MB - 1)
        off = pos % bs
        phys = torch.gather(bt.long(), 1, blk)
        phys = torch.where(ac[:, None] & (pos < MB * bs), phys, torch.zeros_like(phys))
        visible = torch.arange(MB * bs, device=dev)[None, None, :] <= pos[:, :, None]
        for li, lw in enumerate(w["layers"]):
            x = decode_rms(h, lw["input_ln"], eps)
            q = decode_matmul(x, lw["q"]).reshape(b, C, H, hd)
            kk = decode_matmul(x, lw["k"]).reshape(b, C, Hk, hd)
            v = decode_matmul(x, lw["v"]).reshape(b, C, Hk, hd)
            q, kk = rope_rotate(q, sin4, cos4), rope_rotate(kk, sin4, cos4)
            pages_k[li, phys, off] = kk
            pages_v[li, phys, off] = v
            kc = gather_lane_window(pages_k[li], bt)
            vc = gather_lane_window(pages_v[li], bt)
            out = window_attend(q, kc, vc, visible).reshape(b, C, H * hd)
            h = h + decode_matmul(out, lw["o"])
            x = decode_rms(h, lw["post_ln"], eps)
            h = h + decode_matmul(
                torch.nn.functional.silu(decode_matmul(x, lw["gate"]))
                * decode_matmul(x, lw["up"]), lw["down"])
        h = decode_rms(h, w["norm"], eps)
        if w["lm_head"] is None:
            logits = h @ w["embed"].T
        else:
            logits = decode_matmul(h, w["lm_head"])               # [b, C, V]
        return accept(logits, toks, qbuf, base_keys, ln.long(), n_draft, temp, topk, topp,
                      do, k)

    return verify_fn
