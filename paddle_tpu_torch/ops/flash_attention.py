"""Flash attention: the Hopper kernels' wrappers, their plain versions,
the autograd op and the gate.

Counterpart of ``paddle_tpu/ops/pallas/flash_kernel.py`` (forward
``flash_fwd_partial`` :173, backward ``flash_bwd_partial`` :208, the
``custom_vjp`` ``flash_attention_bhsd`` :264-290) and of the gate
``paddle_tpu/ops/pallas/flash_attention.py:76`` ``flash_attention_bsnd``.

Layout is the reference's flash layout: q ``[B, S, H, D]``, k and v
``[B, Sk, Hk, D]`` with ``H % Hk == 0`` (query head h reads KV head
``h // (H // Hk)``); lse and delta are f32 ``[B, H, Sq]``. The forward
returns ``(out, lse)`` and the backward takes ``(q, k, v, dout, lse,
delta)``, the pair and the inputs a ring of K/V shards merges on. Causal
rows align bottom-right, as the composed path (query row i sees keys
``j <= i + Sk - Sq``); a row that sees no key (Sk < Sq) is uniform over all
keys, as the composed path's -1e30 mask makes it: out is the mean of V, dQ
is 0 and dV gets ``dO / Sk`` on every key.

On a CUDA tensor each wrapper launches a kernel or raises: bf16 and fp16
with head_dim 64 or 128 run the wgmma kernels of
``csrc/flash_attention.cu``; f32, and the other head dims that are
multiples of 8 up to 256, the SIMT kernels of ``csrc/flash_simt.cu``
(:func:`flash_simt_fwd`, :func:`flash_simt_bwd`); any Sq and Sk. On a CPU
tensor it runs the plain version, which repeats the kernels' arithmetic in
whole rows: f32 scores, probabilities rounded to the input type before the
products with V (forward) and dO, dS rounded before the products with Q
and K, the ``exp(min(s - lse, 60))`` clamp, and the GQA group sum of dK
and dV in f32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bsnd", "flash_attention_fwd",
           "flash_attention_fwd_ref", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_simt_fwd", "flash_simt_bwd", "tile_errors", "HEAD_DIMS", "DTYPES",
           "MAX_HEAD_DIM"]

DTYPES = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}
HEAD_DIMS = (64, 128)        # the wgmma kernels' head dims, in bf16 and fp16
MAX_HEAD_DIM = 256           # the SIMT kernels': multiples of 8 up to this
NEG_INF = -1e30
CLAMP = 60.0


def _scale(d: int, scale):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _expand(t, rep: int):
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def _keep(q, k):
    """The causal mask [Sq, Sk], aligned bottom-right: row i keeps keys
    ``j <= i + Sk - Sq``."""
    sq, sk = q.shape[1], k.shape[1]
    return torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)


def _scores(q, k, causal: bool, scale: float):
    """f32 scores [B, H, Sq, Sk] of q against the expanded k, causal
    columns past the row's last key set to NEG_INF."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_keep(q, k), NEG_INF)
    return s


def flash_attention_fwd_ref(q, k, v, causal: bool = False, scale=None):
    """Plain forward: ``(out [B, Sq, H, D] in q's dtype, lse f32
    [B, H, Sq])``."""
    rep = q.shape[2] // k.shape[2]
    s = _scores(q, _expand(k, rep), causal, _scale(q.shape[-1], scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), _expand(v, rep).float())
    out = (pv / l).to(q.dtype).transpose(1, 2)
    return out, (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal: bool = False, scale=None):
    """Plain backward: ``(dq, dk, dv)`` shaped and typed like q, k, v."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    sc = _scale(D, scale)
    dt = q.dtype
    s = _scores(q, _expand(k, rep), causal, sc)
    p = torch.exp(torch.clamp_max(s - lse[..., None], CLAMP))
    pv = p
    if causal:
        keep = _keep(q, k)
        p = p.masked_fill(~keep, 0.0)
        # a row that sees no key: uniform, 1 / Sk of its dO on every key
        dead = ~keep.any(dim=1, keepdim=True)
        pv = torch.where(keep, p, torch.where(dead, 1.0 / Sk, 0.0))
    do32 = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pv.to(dt).float(), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, _expand(v, rep).float())
    ds = (p * (dp - delta[..., None]) * sc).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand(k, rep).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())

    def group_sum(t):
        return t.reshape(B, Sk, Hk, rep, D).sum(dim=3).to(dt)

    return dq.to(dt), group_sum(dk), group_sum(dv)


def tile_errors(got, want, tile: int = 64, floor: float = 1e-5):
    """How far two ``[B, S, heads, D]`` tensors differ, tile by tile, as
    the kernels are held against their plain versions: ``(the largest
    ||got - want|| / (||want|| + floor sqrt(n)) over tiles of ``tile`` rows
    of one (batch, head), max |got - want|)``, in f32, for the tile's n
    elements. Each tile is measured against its own norm, so an error
    confined to a few tiles (the diagonal, the ragged tail, the late K
    tiles of a causal dK and dV, whose values lie far below the tensor's
    largest) counts in full; the floor, an RMS, keeps a tile of rounding
    noise (dQ of a single causal row) from counting."""
    d, w = got.float() - want.float(), want.float()
    B, S, heads, D = w.shape
    pad = (0, 0, 0, 0, 0, -S % tile)
    d, w = (torch.nn.functional.pad(t, pad).reshape(B, -1, tile, heads, D) for t in (d, w))
    den = w.square().sum((2, 4)).sqrt() + floor * math.sqrt(tile * D)
    return (d.square().sum((2, 4)).sqrt() / den).max().item(), d.abs().max().item()


def _fn(library, name, n_ptrs):
    fn = getattr(_build.load(library), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _wgmma(q) -> bool:
    """Whether q goes to the wgmma kernels (else to the SIMT kernels)."""
    return q.dtype in (torch.bfloat16, torch.float16) and q.shape[-1] in HEAD_DIMS


def _check(name, q, k, v, *like_q):
    """Raise unless a kernel takes these tensors: bf16, fp16 or f32 of one
    type on one device, q [B, Sq, H, D] and k, v [B, Sk, Hk, D] with
    H % Hk == 0, D a multiple of 8 up to MAX_HEAD_DIM, unit stride along D,
    other strides multiples of 8 and 16-byte aligned data, as the wgmma
    kernels' TMA tensor maps need; a stride of 0 (a broadcast dimension)
    only where the dimension has size 1."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} on the card takes bf16, fp16 or f32, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, S, H, D]")
    B, S, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, Hk, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if Hk == 0 or H % Hk:
        raise ValueError(f"{name}: {H} query heads are not a multiple of {Hk} KV heads")
    if D <= 0 or D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} is not a multiple of 8 up to {MAX_HEAD_DIM}")
    for t in (k, v, *like_q):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: inputs must share q's dtype and device")
    for t in (q, k, v, *like_q):
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st % 8 or (st == 0 and n > 1) for st, n in zip(t.stride()[:3], t.shape))):
            raise ValueError(f"{name}: needs unit stride along head_dim, other strides "
                             f"multiples of 8 and 16-byte aligned data, got strides "
                             f"{t.stride()}")
    if max(B, H) > 65535 or max(S, Sk) >= 2 ** 31:
        raise ValueError(f"{name}: B and H at most 65535, S below 2^31")


def _strides(*ts):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _cuda(q, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def _launch_fwd(library, name, q, k, v, causal, scale):
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * H == 0:
        return out, lse, False
    rc = _fn(library, name, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, out), B, H, k.shape[2], Sq, k.shape[1], D, _scale(D, scale),
        int(bool(causal)), DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, lse, True


def _launch_bwd(library, name, q, k, v, dout, lse, delta, causal, scale):
    B, Sq, H, D = q.shape
    for arg, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, Sq) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: {arg} must be contiguous float32 [B, H, Sq] on "
                             f"{q.device}")
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout must be shaped like q")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if B * Sq * H == 0 or k.shape[1] == 0:
        return (dq.zero_(), dk.zero_(), dv.zero_()), False
    rc = _fn(library, name, 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, dout, dq, dk, dv), B, H, k.shape[2], Sq, k.shape[1], D,
        _scale(D, scale), int(bool(causal)), DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return (dq, dk, dv), True


def flash_simt_fwd(q, k, v, causal: bool = False, scale=None):
    """:func:`flash_attention_fwd` on the SIMT kernel of
    ``csrc/flash_simt.cu``, which takes every dtype and head dim of
    :func:`_check` (the wrapper routes f32 and head dims outside HEAD_DIMS
    here)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    _cuda(q, "flash_simt_fwd")
    _check("flash_simt_fwd", q, k, v)
    out, lse, launched = _launch_fwd("flash_simt", "flash_simt_fwd", q, k, v, causal, scale)
    flash_simt_fwd.launches += launched
    return out, lse


def flash_simt_bwd(q, k, v, dout, lse, delta, causal: bool = False, scale=None):
    """:func:`flash_attention_bwd` on the SIMT kernels (a dK/dV kernel and a
    dQ kernel, one launch)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal, scale)
    _cuda(q, "flash_simt_bwd")
    _check("flash_simt_bwd", q, k, v, dout)
    grads, launched = _launch_bwd("flash_simt", "flash_simt_bwd", q, k, v, dout, lse, delta,
                                  causal, scale)
    flash_simt_bwd.launches += launched
    return grads


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """``(out [B, Sq, H, D], lse f32 [B, H, Sq])`` of softmax attention: the
    wgmma kernel for bf16/fp16 with head_dim in HEAD_DIMS (counted here),
    else :func:`flash_simt_fwd` (counted there)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    _cuda(q, "flash_attention_fwd")
    _check("flash_attention_fwd", q, k, v)
    if not _wgmma(q):
        return flash_simt_fwd(q, k, v, causal, scale)
    out, lse, launched = _launch_fwd("flash_attention", "flash_attention_fwd", q, k, v, causal,
                                     scale)
    flash_attention_fwd.launches += launched
    return out, lse


def flash_attention_bwd(q, k, v, dout, lse, delta, causal: bool = False, scale=None):
    """``(dq, dk, dv)`` from the forward's lse and ``delta = rowsum(dO * O)``
    (f32 [B, H, Sq]); dk and dv are summed over each KV head's group. Routed
    as :func:`flash_attention_fwd`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal, scale)
    _cuda(q, "flash_attention_bwd")
    _check("flash_attention_bwd", q, k, v, dout)
    if not _wgmma(q):
        return flash_simt_bwd(q, k, v, dout, lse, delta, causal, scale)
    grads, launched = _launch_bwd("flash_attention", "flash_attention_bwd", q, k, v, dout, lse,
                                  delta, causal, scale)
    flash_attention_bwd.launches += launched
    return grads


#: kernel launches since the last reset (the CPU path never counts); one
#: backward launch runs the dK/dV pass and the dQ pass
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_simt_fwd.launches = 0
flash_simt_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Differentiable flash attention, ``[B, S, H, D]`` in and out."""
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention_bsnd(q, k, v, causal: bool = False, sm_scale=None):
    """The gate: the flash op's output for what the reference's rules send
    to a kernel (bf16 and f32, here also fp16, with a head_dim that is a
    multiple of 8; any Sq and Sk), None for what they keep composed (other
    dtypes and head dims). On the card a call sent to the op launches a
    kernel or raises (a head_dim past MAX_HEAD_DIM); there is no probe and
    no fallback."""
    if q.dtype not in DTYPES or q.shape[-1] % 8:
        return None
    return flash_attention(q, k, v, causal, sm_scale)
