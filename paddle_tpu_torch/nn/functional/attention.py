"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``). q, k, v are
``[batch, seq, heads, head_dim]``, k and v with ``heads / group`` heads
under GQA."""

from __future__ import annotations

import math

import torch

from ...amp import cast_inputs
from ...ops.flash_attention import flash_attention_bsnd

__all__ = ["flash_attention", "scaled_dot_product_attention", "sdpa_ref"]


def sdpa_ref(q, k, v, mask=None, dropout_p=0.0, causal=False, scale=None, generator=None):
    """The composed attention (reference ``_sdpa_ref``, :25-52): logits in
    q's dtype then f32, times ``1/sqrt(d)``; a causal mask aligned to the
    last key; a bool ``mask`` keeps where True, any other mask is added;
    softmax in f32, probabilities cast to q's dtype; dropout with keep
    probability ``1 - dropout_p`` drawn from ``generator`` (torch bits,
    not the reference's)."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * s
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((q_len, k_len), dtype=torch.bool, device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator, device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), torch.zeros((), dtype=probs.dtype,
                                                                          device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True, name=None, *,
                    generator=None):
    """Paddle's ``flash_attention``: returns ``(out, None)``. Without
    dropout the flash gate takes the call (bf16, fp16 and f32 with a
    head_dim that is a multiple of 8, any ``sq`` and ``sk``, causal aligned
    bottom-right); other head dims and dropout in training go to the
    composed path. Under ``amp.auto_cast`` q, k and v are first cast as
    the op ``flash_attention``."""
    query, key, value = cast_inputs("flash_attention", query, key, value)
    if dropout == 0.0:
        out = flash_attention_bsnd(query, key, value, causal=causal)
        if out is not None:
            return out, None
    return sdpa_ref(query, key, value, None, dropout if training else 0.0, causal,
                    generator=generator), None


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, name=None, *,
                                 generator=None):
    """Paddle's ``scaled_dot_product_attention``: a mask or dropout goes to
    the composed path, anything else through the flash gate. Under
    ``amp.auto_cast`` the inputs are first cast as the op ``sdpa``."""
    query, key, value, attn_mask = cast_inputs("sdpa", query, key, value, attn_mask)
    p = dropout_p if training else 0.0
    if attn_mask is None and dropout_p == 0.0:
        out = flash_attention_bsnd(query, key, value, causal=is_causal)
        if out is not None:
            return out
    return sdpa_ref(query, key, value, attn_mask, p, is_causal, generator=generator)
