"""Fused-op surface (counterpart of ``paddle_tpu/incubate/nn/functional.py``)."""

from __future__ import annotations

import torch

from ...amp import cast_inputs
from ...nn.functional import swiglu  # noqa: F401 (re-export, as the reference does)

__all__ = ["fused_rotary_position_embedding", "rotary_tables", "swiglu"]


def rotary_tables(seq: int, dim: int, base: float, device=None):
    """(sin, cos) ``[seq, dim / 2]`` in f32 of the angles
    ``t * base^(-2i / dim)`` for ``t = 0..seq-1``."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    return torch.sin(freqs), torch.cos(freqs)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0):
    """Rotary position embedding of q, k, v ``[batch, seq, heads, dim]``
    (each may be None), with the reference's semantics (``functional.py:50``):

    - without ``sin``/``cos`` the angles are ``arange(seq)``'s, computed in
      f32; ``position_ids`` is not read, as in the reference;
    - given ``sin``/``cos`` (``[..., seq, dim]``, any leading ones), their
      first ``dim / 2`` columns are used;
    - sin and cos are cast to the activation's dtype before the products
      (in bf16 this rounding shows at large positions);
    - neox style rotates the halves ``[:d/2]``, ``[d/2:]``; otherwise the
      interleaved pairs ``(0::2, 1::2)``;
    - under ``amp.auto_cast`` q, k and v are first cast as the op
      ``fused_rope``.
    """
    if time_major:
        raise NotImplementedError("time_major rotary embedding comes with a later slice "
                                  "of the port")

    def rope(a):
        d = a.shape[-1]
        if sin is None:
            s, c = rotary_tables(a.shape[1], d, rotary_emb_base, a.device)
        else:
            s = sin.reshape(sin.shape[-2], -1)[..., : d // 2]
            c = cos.reshape(cos.shape[-2], -1)[..., : d // 2]
        s = s[None, :, None, :].to(a.dtype)
        c = c[None, :, None, :].to(a.dtype)
        if use_neox_rotary_style:
            a1, a2 = a[..., : d // 2], a[..., d // 2:]
            return torch.cat([a1 * c - a2 * s, a2 * c + a1 * s], dim=-1)
        a1, a2 = a[..., 0::2], a[..., 1::2]
        return torch.stack([a1 * c - a2 * s, a2 * c + a1 * s], dim=-1).reshape(a.shape)

    return tuple(None if t is None else rope(t) for t in cast_inputs("fused_rope", q, k, v))
