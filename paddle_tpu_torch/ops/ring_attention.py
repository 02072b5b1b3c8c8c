"""Ring attention over the ranks of a context-parallel axis: the composed
ring and the gate to the ring-flash kernels.

Counterpart of ``paddle_tpu/ops/pallas/ring_attention.py`` :26-116. Like
:mod:`paddle_tpu_torch.ops.ring_flash`, it takes the global sequence
[B, S, H, D] (K/V [B, S, Hk, D], GQA) and the ring size P, and keeps the P
ranks of S / P positions in one process: the reference's per-device
``shard_map`` body becomes a leading rank axis, and the ``ppermute``
rotation a roll along it.

The gate follows the reference's rule of "flash where the kernel runs"
(:54-66 on a TPU): a CUDA tensor of bf16, fp16 or f32 with ``head_dim %
8 == 0`` (:func:`flash_runs`) takes the ring schedule over the flash
kernels (:func:`~paddle_tpu_torch.ops.ring_flash.ring_flash_attention`:
wgmma kernels on every route, bf16/fp16 at head_dim 64 or 128, other head
dims padded, f32 in two bf16 pieces). The reference's ``S / P % 128 == 0`` is the TPU kernel's tiling
limit; the port's kernels take a shard of any length, so a ragged shard
runs them too. Other dtypes and head dims, and CPU tensors, take the
blockwise ring in torch ops (block logits, running max and running sum),
which torch autograd differentiates as the reference's VJP does. There is
no probe and no fallback: a tensor sent to the kernels launches them or
raises (a head_dim past ``flash_attention.MAX_WIDE_HEAD_DIM``; the kernels' own
checks name what they refuse, the counterpart of the reference's
ValueError at :67-74).

Across processes (``link``, the context axis's transport) q, k and v are
this rank's shards, as in the reference's ``shard_map`` body: the flash
schedule sends K/V (and in the backward dK/dV) around the ring, and the
composed ring rotates K/V at their grouped head count with one hop a step
(:func:`_rotate`, whose backward is the reverse hop: the ``ppermute``'s
transpose), each rank masking by its own and the owner's positions.
"""

from __future__ import annotations

import math

import torch

from . import flash_attention as fa
from .ring_flash import fold, ring_flash_attention, unfold

__all__ = ["ring_attention", "flash_runs"]

NEG_INF = -1e30


def flash_runs(q) -> bool:
    """Whether :func:`ring_attention` sends q to the ring-flash kernels:
    a CUDA tensor of a kernel dtype whose head_dim is a multiple of 8, the
    rule of the flash gate (``flash_attention.flash_attention_bsnd``)."""
    return q.device.type == "cuda" and q.dtype in fa.DTYPES and q.shape[-1] % 8 == 0


def _block(q, k, v, scale, mask):
    """One K/V block per rank: (numerator p @ v, block max, block sum)."""
    logits = torch.einsum("...hqd,...hkd->...hqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    m_b = logits.amax(dim=-1)
    p = torch.exp(logits - m_b[..., None])
    a = torch.einsum("...hqk,...hkd->...hqd", p.to(v.dtype), v).float()
    return a, m_b, p.sum(dim=-1)


def _expand(k, v, rep: int):
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


class _Rotate(torch.autograd.Function):
    """K/V to the next rank of the ring, from the previous; the backward
    sends the gradients the other way."""

    @staticmethod
    def forward(ctx, link, k, v):
        ctx.link = link
        return tuple(link.hop([k, v], "rot").wait())

    @staticmethod
    def backward(ctx, dk, dv):
        return (None,) + tuple(ctx.link.hop([dk, dv], "rot", reverse=True).wait())


def _rotate(k, v, link):
    return _Rotate.apply(link, k, v)


def _composed_link(q, k, v, link, causal: bool):
    """The blockwise ring over the processes of ``link`` on this rank's
    shards [B, S / P, H | Hk, D]."""
    P, r = link.size, link.index
    n, D = q.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qt.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros(qt.shape[:-1], dtype=torch.float32, device=q.device)
    pos = torch.arange(n, device=q.device)
    kc, vc = k, v
    for step in range(P):
        mask = None
        if causal:
            owner = (r - step) % P                # whose K/V shard this rank holds
            mask = (r * n + pos)[:, None] >= (owner * n + pos)[None, :]
        ke, ve = _expand(kc, vc, rep)
        a, m_b, s_b = _block(qt, ke.transpose(1, 2), ve.transpose(1, 2), scale, mask)
        m_new = torch.maximum(m, m_b)
        w_old = torch.exp(m - m_new)
        w_blk = torch.exp(m_b - m_new)
        acc = acc * w_old[..., None] + a * w_blk[..., None]
        s = s * w_old + s_b * w_blk
        m = m_new
        if step != P - 1:
            kc, vc = _rotate(kc, vc, link)
    out = (acc / torch.clamp_min(s, 1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)


def _composed(q, k, v, P: int, causal: bool):
    B, S, H, D = q.shape
    k, v = _expand(k, v, H // k.shape[2])
    n = S // P

    def ranks(t):  # [B, S, H, D] -> [P, B, H, S / P, D]
        return fold(t, P).reshape(P, B, n, H, D).transpose(2, 3)

    qt, kt, vt = ranks(q), ranks(k), ranks(v)
    scale = 1.0 / math.sqrt(D)
    acc = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qt.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros(qt.shape[:-1], dtype=torch.float32, device=q.device)
    idx = torch.arange(P, device=q.device)
    pos = torch.arange(n, device=q.device)
    for step in range(P):
        mask = None
        if causal:
            owner = (idx - step) % P          # whose K/V shard each rank holds
            q_pos = idx[:, None] * n + pos
            k_pos = owner[:, None] * n + pos
            mask = (q_pos[:, :, None] >= k_pos[:, None, :])[:, None, None]
        a, m_b, s_b = _block(qt, kt.roll(step, 0), vt.roll(step, 0), scale, mask)
        m_new = torch.maximum(m, m_b)
        w_old = torch.exp(m - m_new)
        w_blk = torch.exp(m_b - m_new)
        acc = acc * w_old[..., None] + a * w_blk[..., None]
        s = s * w_old + s_b * w_blk
        m = m_new
    out = (acc / torch.clamp_min(s, 1e-30)[..., None]).to(q.dtype)
    return unfold(out.transpose(2, 3).reshape(P * B, n, H, D), P)


def ring_attention(q, k, v, ring_size: int, causal: bool = False, link=None):
    """Attention of q [B, S, H, D] over k, v [B, S, Hk, D] computed as a
    ring of ``ring_size`` ranks of S / P positions each (S % P == 0, or
    ValueError). Returns [B, S, H, D], equal to full-sequence attention.
    With ``link`` (the ring across processes, ``ring_size`` its size) q, k
    and v are this rank's shards [B, S / P, ...] and so is the result."""
    h, hk = q.shape[2], k.shape[2]
    if hk == 0 or h % hk:
        raise ValueError(f"GQA requires num_heads % num_kv_heads == 0, got {h} vs {hk}")
    if link is not None and int(ring_size) != link.size:
        raise ValueError(f"ring_size {ring_size} on a ring of {link.size} processes")
    if flash_runs(q):
        return ring_flash_attention(q, k, v, ring_size, causal, link=link)
    if link is not None:
        return _composed_link(q, k, v, link, causal)
    return _composed(q, k, v, int(ring_size), causal)
