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

On a CUDA tensor each wrapper launches a kernel of
``csrc/flash_attention.cu`` (wgmma fed by TMA) or raises, by one of four
routes (:func:`route`): ``wgmma``, bf16 and fp16 at head_dim 64 or 128;
``padded``, bf16 and fp16 at the other head dims that are multiples of 8
up to 256, run zero-padded to the next multiple of 64; ``f32``, f32 inputs
up to 256 split into two bf16 pieces each (:func:`split2`) by a pre-pass
kernel in the same call, every product taken as three piece products;
``wide``, every dtype at head dims past 256 up to MAX_WIDE_HEAD_DIM (the
reference's gate sends any multiple of 8 to its bundled kernel): the
score products contract over the whole padded head dim in 64-column TMA
boxes, and each block writes one output chunk of :func:`chunk_plan` (at
most 256 columns), recomputing the scores in the same order as the other
chunks' blocks (f32 through the same split). Any Sq and Sk.
On a CPU tensor it runs the plain version, which repeats the kernels'
arithmetic in whole rows: f32 scores, probabilities rounded to the input
type before the products with V (forward) and dO, dS rounded before the
products with Q and K, the ``exp(min(s - lse, 60))`` clamp, and the GQA
group sum of dK and dV in f32. In f32 the plain version rounds nothing;
:func:`flash_attention_fwd_split` and :func:`flash_attention_bwd_split`
repeat the f32 route's products on the pieces, to hold its rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bsnd", "flash_attention_fwd",
           "flash_attention_fwd_ref", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_fwd_split", "flash_attention_bwd_split", "chunk_plan", "route",
           "split2", "tile_errors", "HEAD_DIMS", "DTYPES", "MAX_HEAD_DIM", "ROUTES"]

DTYPES = {torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}
HEAD_DIMS = (64, 128)        # head dims the bf16/fp16 kernels take unpadded
MAX_HEAD_DIM = 256           # the wgmma, padded and f32 routes: multiples of 8 up to this
MAX_WIDE_HEAD_DIM = 1024     # the wide route: multiples of 8 past 256 up to this
MAX_CHUNK = 256              # the wide route's output columns a block
ROUTES = ("wgmma", "padded", "f32", "wide")
PIECES = 2                   # bf16 pieces of an f32 operand on the f32 route
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


def split2(x):
    """The f32 route's split of ``x`` into two bf16 pieces, as f32 tensors:
    ``h = bf16(x)``, ``l = bf16(x - h)`` (16 significant bits of x)."""
    h = x.float().to(torch.bfloat16).float()
    return h, (x.float() - h).to(torch.bfloat16).float()


def _split_einsum(eq: str, a, b):
    """``einsum(eq, a, b)`` as the f32 route computes it: the pieces' three
    products ``h.h' + h.l' + l.h'``, each exact, summed in f32."""
    (ah, al), (bh, bl) = split2(a), split2(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def flash_attention_fwd_split(q, k, v, causal: bool = False, scale=None):
    """:func:`flash_attention_fwd_ref` for f32 inputs with the f32 route's
    products: q.k and P.V over the two-piece split of both operands
    (:func:`split2`), the probabilities split where they are formed."""
    rep = q.shape[2] // k.shape[2]
    s = _split_einsum("bqhd,bkhd->bhqk", q, _expand(k, rep)) * _scale(q.shape[-1], scale)
    if causal:
        s = s.masked_fill(~_keep(q, k), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = _split_einsum("bhqk,bkhd->bhqd", p, _expand(v, rep))
    return (pv / l).transpose(1, 2), (m + torch.log(l))[..., 0]


def flash_attention_bwd_split(q, k, v, dout, lse, delta, causal: bool = False, scale=None):
    """:func:`flash_attention_bwd_ref` for f32 inputs with the f32 route's
    products (:func:`_split_einsum`), P and dS split where they are formed."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    sc = _scale(D, scale)
    ke, ve = _expand(k, rep), _expand(v, rep)
    s = _split_einsum("bqhd,bkhd->bhqk", q, ke) * sc
    if causal:
        s = s.masked_fill(~_keep(q, k), NEG_INF)
    p = torch.exp(torch.clamp_max(s - lse[..., None], CLAMP))
    pv = p
    if causal:
        keep = _keep(q, k)
        p = p.masked_fill(~keep, 0.0)
        dead = ~keep.any(dim=1, keepdim=True)
        pv = torch.where(keep, p, torch.where(dead, 1.0 / Sk, 0.0))
    dv = _split_einsum("bhqk,bqhd->bkhd", pv, dout)
    dp = _split_einsum("bqhd,bkhd->bhqk", dout, ve)
    ds = p * (dp - delta[..., None]) * sc
    dq = _split_einsum("bhqk,bkhd->bqhd", ds, ke)
    dk = _split_einsum("bhqk,bqhd->bkhd", ds, q)

    def group_sum(t):
        return t.reshape(B, Sk, Hk, rep, D).sum(dim=3)

    return dq, group_sum(dk), group_sum(dv)


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


def _fn(name, n_ptrs):
    """A kernel's C entry: n_ptrs pointers, the six sizes, scale, causal,
    dtype, stream and the f32 pieces' scratch."""
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def chunk_plan(D: int) -> tuple[int, ...]:
    """The wide route's output chunks at head_dim D, in column order (the
    kernels' ``wide_plan``): the padded head dim Dp = 64 ceil(D / 64) cut
    into c = ceil(Dp / 256) chunks of whole 64-column boxes, the first
    (Dp / 64) mod c of them one box wider than the rest, so each chunk is a
    multiple of 64 of at most 256 columns and together they cover Dp. Each
    chunk's blocks recompute the scores: with c chunks the forward does
    (c + 1) / 2 and the backward (5 c + 3) / 5 of their FLOP bounds' work."""
    boxes = -(-D // 64)
    c = -(-boxes // (MAX_CHUNK // 64))
    base, extra = divmod(boxes, c)
    return (64 * (base + 1),) * extra + (64 * base,) * (c - extra)


def route(q) -> str:
    """The route a call on q takes (ROUTES): ``wide`` past MAX_HEAD_DIM,
    else ``f32`` for f32, ``wgmma`` for bf16 and fp16 at a head_dim in
    HEAD_DIMS, ``padded`` for the others."""
    if q.shape[-1] > MAX_HEAD_DIM:
        return "wide"
    if q.dtype == torch.float32:
        return "f32"
    return "wgmma" if q.shape[-1] in HEAD_DIMS else "padded"


def _check(name, q, k, v, *like_q):
    """Raise unless a kernel takes these tensors: bf16, fp16 or f32 of one
    type on one device, q [B, Sq, H, D] and k, v [B, Sk, Hk, D] with
    H % Hk == 0, D a multiple of 8 up to MAX_WIDE_HEAD_DIM, unit stride along D,
    other strides multiples of 8 and 16-byte aligned data, as the kernels'
    TMA tensor maps need; a stride of 0 (a broadcast dimension) only where
    the dimension has size 1."""
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
    if D <= 0 or D % 8 or D > MAX_WIDE_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {D} is not a multiple of 8 up to "
                         f"{MAX_WIDE_HEAD_DIM}")
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


def _work(q, *ts):
    """The scratch for the two bf16 pieces of each f32 input (None for
    bf16 and fp16)."""
    if q.dtype != torch.float32:
        return None
    n = sum(t.numel() for t in (q, *ts))
    return torch.empty(PIECES * n, dtype=torch.bfloat16, device=q.device)


def _count(fn, q):
    fn.by_route[route(q)] += 1


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """``(out [B, Sq, H, D], lse f32 [B, H, Sq])`` of softmax attention: one
    kernel launch on the card (with f32's split pre-pass), counted in
    ``by_route`` under its route."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    _cuda(q, "flash_attention_fwd")
    _check("flash_attention_fwd", q, k, v)
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * H == 0:
        return out, lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out), B, H, k.shape[2], Sq, k.shape[1], D, _scale(D, scale),
            int(bool(causal)), DTYPES[q.dtype], _build.launch_stream(q.device))
    work = _work(q, k, v)
    rc = _fn("flash_attention_fwd", 6)(*args, None if work is None else work.data_ptr())
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {rc}")
    _count(flash_attention_fwd, q)
    return out, lse


def flash_attention_bwd(q, k, v, dout, lse, delta, causal: bool = False, scale=None):
    """``(dq, dk, dv)`` from the forward's lse and ``delta = rowsum(dO * O)``
    (f32 [B, H, Sq]); dk and dv are summed over each KV head's group. A
    call on the card runs the dV, dK and dQ passes (one launch past 256
    columns, a launch a pass up to 256; and f32's split pre-pass), counted
    once as :func:`flash_attention_fwd`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lse, delta, causal, scale)
    _cuda(q, "flash_attention_bwd")
    _check("flash_attention_bwd", q, k, v, dout)
    B, Sq, H, D = q.shape
    for arg, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, Sq) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: {arg} must be contiguous float32 "
                             f"[B, H, Sq] on {q.device}")
    if dout.shape != q.shape:
        raise ValueError("flash_attention_bwd: dout must be shaped like q")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if B * Sq * H == 0 or k.shape[1] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, dout, dq, dk, dv), B, H, k.shape[2], Sq, k.shape[1], D,
            _scale(D, scale), int(bool(causal)), DTYPES[q.dtype],
            _build.launch_stream(q.device))
    work = _work(q, k, v, dout)
    rc = _fn("flash_attention_bwd", 10)(*args, None if work is None else work.data_ptr())
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    _count(flash_attention_bwd, q)
    return dq, dk, dv


#: calls that launched the kernels since the last reset, by route (the CPU
#: path never counts)
for _w in (flash_attention_fwd, flash_attention_bwd):
    _w.by_route = dict.fromkeys(ROUTES, 0)
del _w


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
    kernel or raises (a head_dim past MAX_WIDE_HEAD_DIM); there is no probe
    and no fallback."""
    if q.dtype not in DTYPES or q.shape[-1] % 8:
        return None
    return flash_attention(q, k, v, causal, sm_scale)
