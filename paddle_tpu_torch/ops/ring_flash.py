"""Ring flash attention: the lse merge's kernel wrapper and plain version,
and the ring schedule over the flash kernels as an autograd op.

Counterpart of ``paddle_tpu/ops/pallas/ring_flash.py``: ``_merge`` :44,
the forward ``_ring_fwd`` :78-100, the backward ``_ring_bwd`` :103-139 and
the custom VJP ``ring_flash_attention`` :145. Layout is the port's flash
layout: q ``[B, S, H, D]``, k and v ``[B, S, Hk, D]`` with ``H % Hk == 0``,
lse f32 ``[B, H, S]``.

**One process, P virtual ranks.** The reference runs one shard of the
sequence per device inside ``shard_map`` and rotates K/V around the ring
with ``ppermute``. Here the function takes the *global* sequence and the
ring size P and keeps every rank in one process on one device: the S / P
positions of rank r are batch entries ``r * B .. (r + 1) * B`` of the
folded ``[P * B, S / P, H, D]`` (for B = 1 a view, no copy). Each ring step
is then one launch over the ranks that see a K/V shard, and the rotation
becomes indexing. What the reference computes stays: the shard pairs of
each step, the causal gate, the merge order per rank, the f32 dQ/dK/dV
accumulators per owner and the GQA handling. Moving shards between cards
(``torch.distributed`` P2P over NCCL) waits for the distributed slice of
the port and a machine with more than one card.

**Causal ring.** At step s the visible (query rank, K/V owner) pairs are
ranks ``[s, P)`` against owners ``[0, P - s)``: both contiguous slices of the
folded batch, so step s is one flash launch, causal only at s = 0 (the
diagonal). The reference also computes the masked pairs (owner after the
rank) and gates them with 0 (``lse_b = -1e30`` in the forward, ``* 0`` in
the backward). The port does not launch them. Where the reference's values
are finite the results are the same, in the same per-rank order: a merge
with ``lse_b = -1e30`` is exactly the identity and ``x + y * 0`` is exactly
x. It also avoids the gate's one hazard: a masked backward step feeds
``exp(min(s - lse, 60))``, about 1e26, into dS, which is inf in fp16, and
inf * 0 is NaN.

**Non-causal ring.** Rank r meets owner ``(r - s) mod P`` at step s: K/V
are rolled along the rank axis (one copy a step, the counterpart of the
``ppermute``), and in the backward dK/dV are rolled back to their owners
before they are added.

**Launches** per call (causal or not): flash forward P, merge P - 1 (step 0
initialises the accumulator from the first partial, which the merge rule
gives exactly), flash backward P. The forward rounds each rank's output
once, to q's dtype, as ``ring_flash.py:99`` does, when its last merge
finishes it (the merge kernel writes it).

**Backward.** ``delta = rowsum(dO * O)`` from the saved, rounded O, as
``ring_flash.py:111-113``; each step is one flash backward on the same
slices with the *merged* lse; dQ accumulates into the ranks' rows and
dK/dV into the owners' rows, in f32, in step order, rounded once at the
end. The port's flash backward already returns dK/dV summed over each GQA
group, so the reference's ``_expand_kv``/``_group_sum`` (:55-68) have no
counterpart and K/V stay at the grouped head count, as the reference
rotates them. One difference in rounding: the reference rounds each
expanded head's dK/dV to the input type and sums the group in f32; the
port's kernel sums the group in f32 and rounds once. In f32 (the CPU
tests) no rounding differs; in bf16 the card's tile limits absorb it.

The merge runs ``csrc/ring_merge.cu`` on CUDA tensors (or raises) and its
plain version on CPU tensors; the flash steps go through
:mod:`paddle_tpu_torch.ops.flash_attention` the same way.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import flash_attention as fa

__all__ = ["ring_merge", "ring_merge_ref", "ring_merge_plain", "ring_flash_fwd",
           "ring_flash_bwd", "ring_flash_attention", "fold", "unfold"]


def _rows(t):
    """lse-shaped [N, H, S] as [N, S, H, 1], to scale rows of [N, S, H, D]."""
    return t.transpose(1, 2)[..., None]


def ring_merge_ref(acc, lse, out_b, lse_b):
    """The reference's merge: ``(acc', lse')`` of a running f32
    accumulator ``acc`` [N, S, H, D] with its lse [N, H, S] and a new
    normalized partial ``out_b`` with its ``lse_b``."""
    m = torch.maximum(lse, lse_b)
    w = torch.exp(lse - m)
    w_b = torch.exp(lse_b - m)
    d = torch.clamp_min(w + w_b, 1e-30)
    merged = (acc * _rows(w) + out_b.float() * _rows(w_b)) / _rows(d)
    return merged, m + torch.log(d)


def ring_merge_plain(acc, lse, out_b, lse_b, out=None):
    """:func:`ring_merge` through :func:`ring_merge_ref`: updates ``acc``
    and ``lse`` in place; ``out``, when given, receives the first
    ``out.shape[0]`` batch entries of the new acc, rounded."""
    merged, new_lse = ring_merge_ref(acc, lse, out_b, lse_b)
    acc.copy_(merged)
    lse.copy_(new_lse)
    if out is not None:
        out.copy_(merged[:out.shape[0]])


def _check_merge(acc, lse, out_b, lse_b, out):
    if acc.dim() != 4:
        raise ValueError(f"ring_merge: acc must be [N, S, H, D], got {tuple(acc.shape)}")
    N, S, H, D = acc.shape
    if acc.dtype != torch.float32 or out_b.dtype not in fa.DTYPES:
        raise TypeError(f"ring_merge takes an f32 acc and a bf16/fp16/f32 partial, got "
                        f"{acc.dtype} and {out_b.dtype}")
    if out_b.shape != acc.shape:
        raise ValueError("ring_merge: out_b must be shaped like acc")
    for name, t in (("lse", lse), ("lse_b", lse_b)):
        if t.dtype != torch.float32 or t.shape != (N, H, S):
            raise ValueError(f"ring_merge: {name} must be float32 [N, H, S] = {(N, H, S)}")
    outs = () if out is None else (out,)
    if out is not None and (out.dtype != out_b.dtype or out.dim() != 4
                            or out.shape[0] > N or out.shape[1:] != acc.shape[1:]):
        raise ValueError("ring_merge: out must be [n <= N, S, H, D] of out_b's dtype")
    for t in (acc, lse, out_b, lse_b) + outs:
        if t.device != acc.device:
            raise ValueError("ring_merge: inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("ring_merge: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (acc, out_b) + outs):
        raise ValueError("ring_merge: acc, out_b and out must be 16-byte aligned")
    if D % 8 or D > 2048:
        raise ValueError(f"ring_merge: head_dim {D} must be a multiple of 8 up to 2048")


def ring_merge(acc, lse, out_b, lse_b, out=None):
    """Merge a new partial ``(out_b, lse_b)`` into the running ``(acc,
    lse)`` in place (the reference's ``_merge``); ``out``, when given, also
    receives the first ``out.shape[0]`` batch entries of the merged acc
    rounded to its dtype. acc f32 [N, S, H, D], out_b bf16/fp16/f32 like acc,
    lse and lse_b f32 [N, H, S]."""
    if acc.device.type == "cpu":
        ring_merge_plain(acc, lse, out_b, lse_b, out)
        return
    if acc.device.type != "cuda":
        raise ValueError(f"ring_merge runs on cuda or cpu, not {acc.device}")
    _check_merge(acc, lse, out_b, lse_b, out)
    N, S, H, D = acc.shape
    if N * S * H == 0:
        return
    fn = _build.load("ring_merge").ring_merge
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    out_rows = 0 if out is None else out.shape[0] * S * H
    rc = fn(acc.data_ptr(), lse.data_ptr(), out_b.data_ptr(), lse_b.data_ptr(),
            None if out is None else out.data_ptr(), out_rows, N, S, H, D,
            fa.DTYPES[out_b.dtype], _build.launch_stream(acc.device))
    if rc != 0:
        raise RuntimeError(f"ring_merge kernel launch failed: CUDA error {rc}")
    ring_merge.launches += 1


#: kernel launches since the last reset (the CPU path never counts)
ring_merge.launches = 0


def fold(t, ring_size: int):
    """[B, S, heads, D] -> [P * B, S / P, heads, D], rank-major: batch
    entries ``r * B .. (r + 1) * B`` hold positions ``r * S / P ..`` of
    rank r. A view for B = 1, one copy otherwise."""
    B, S = t.shape[0], t.shape[1]
    if S % ring_size:
        raise ValueError(f"the sequence ({S}) must divide evenly over the ring of "
                         f"{ring_size} ranks")
    t = t.reshape(B, ring_size, S // ring_size, *t.shape[2:]).transpose(0, 1)
    return t.reshape(ring_size * B, S // ring_size, *t.shape[3:]).contiguous()


def unfold(t, ring_size: int):
    """Inverse of :func:`fold`."""
    B = t.shape[0] // ring_size
    t = t.reshape(ring_size, B, *t.shape[1:]).transpose(0, 1)
    return t.reshape(B, ring_size * t.shape[2], *t.shape[3:])


def ring_flash_fwd(q, k, v, ring_size: int, causal: bool, scale=None):
    """``(out, lse)`` of the ring forward on folded q [P * B, S / P, H, D],
    k and v [P * B, S / P, Hk, D]: out in q's dtype, lse the merged f32
    [P * B, H, S / P]."""
    P, n = ring_size, q.shape[0] // ring_size
    # step 0: every rank against its own shard (the diagonal when causal);
    # its partial is rank 0's finished output in the causal ring
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    if P == 1:
        return out, lse
    acc = out[n:].float() if causal else out.float()
    for s in range(1, P):
        if causal:
            out_b, lse_b = fa.flash_attention_fwd(q[s * n:], k[:(P - s) * n], v[:(P - s) * n],
                                                  False, scale)
            # ranks [s, P) merge; rank s is finished
            ring_merge(acc[(s - 1) * n:], lse[s * n:], out_b, lse_b, out[s * n:(s + 1) * n])
        else:
            out_b, lse_b = fa.flash_attention_fwd(q, k.roll(s * n, 0), v.roll(s * n, 0),
                                                  False, scale)
            ring_merge(acc, lse, out_b, lse_b, out if s == P - 1 else None)
    return out, lse


def ring_flash_bwd(q, k, v, out, lse, dout, ring_size: int, causal: bool, scale=None):
    """``(dq, dk, dv)`` of the ring, folded like the inputs, from the
    forward's rounded out and merged lse."""
    P, n = ring_size, q.shape[0] // ring_size
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, dout, lse, delta, causal, scale)
    if P == 1:
        return dq, dk, dv
    dq_acc, dk_acc, dv_acc = dq.float(), dk.float(), dv.float()
    for s in range(1, P):
        if causal:
            r, o = slice(s * n, None), slice(0, (P - s) * n)
            dq_b, dk_b, dv_b = fa.flash_attention_bwd(q[r], k[o], v[o], dout[r], lse[r],
                                                      delta[r], False, scale)
            dq_acc[r].add_(dq_b)
            dk_acc[o].add_(dk_b)
            dv_acc[o].add_(dv_b)
        else:
            dq_b, dk_b, dv_b = fa.flash_attention_bwd(q, k.roll(s * n, 0), v.roll(s * n, 0),
                                                      dout, lse, delta, False, scale)
            dq_acc.add_(dq_b)
            dk_acc.add_(dk_b.roll(-s * n, 0))
            dv_acc.add_(dv_b.roll(-s * n, 0))
    return dq_acc.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring_size, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ring_flash_fwd(q, k, v, ring_size, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring_size, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_bwd(q, k, v, out, lse, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def ring_flash_attention(q, k, v, ring_size: int, causal: bool = False, scale=None):
    """Differentiable ring flash attention over the global sequence: q
    [B, S, H, D], k and v [B, S, Hk, D], split into ``ring_size`` ranks of
    S / P positions (S % P == 0, or ValueError). Returns [B, S, H, D],
    equal to full attention over the sequence."""
    h, hk = q.shape[2], k.shape[2]
    if hk == 0 or h % hk:
        raise ValueError(f"GQA requires num_heads % num_kv_heads == 0, got {h} vs {hk}")
    P = int(ring_size)
    out = _RingFlash.apply(fold(q, P), fold(k, P), fold(v, P), P, bool(causal), scale)
    return unfold(out, P)
