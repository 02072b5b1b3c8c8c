"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py:68``
``paged_decode_attention``. On a CUDA tensor the wrapper launches the
kernel of ``csrc/paged_attention.cu`` or raises; it never declines to a
composed path. On a CPU tensor it runs :func:`paged_decode_attention_ref`,
the reference's composed semantics (gather the lane's pages through its
block-table row, then ``masked_attend``), which the CPU tests hold against
the reference package.

The kernel is one launch with a grid fixed by the shapes (:func:`grid_size`):
each (lane, KV head, pass) pair's visible pages are cut into chunks of at
most Kc pages, Kc the fewest that fit the chunks to the grid, one chunk a
block; a pair cut into several chunks is merged, in chunk order, by the
block that finishes it last. :func:`split_schedule` and
:func:`paged_decode_attention_split` repeat that schedule and merge on the
CPU, so the tests hold them against the plain version and the reference.

Head dims or pages past 256 (the TMA boxes' limit) go to
:func:`paged_decode_attention_wide`, a SIMT kernel of
``csrc/attention_wide.cu`` (a block per lane and query head, four warps
each keeping an online softmax over every fourth visible slot, merged in
warp order), as the reference's composed path serves any size.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.llama import masked_attend
from . import _build

__all__ = ["grid_size", "heads_per_pass", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_decode_attention_split",
           "paged_decode_attention_wide", "split_schedule", "takes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCKS_PER_SM = 2          # the grid: this many blocks an SM, at most one a work item
_MAX_HEADS_PER_PASS = 8    # query heads a pass of the kernel takes
_MAX_PAGE = 256            # slots of a page (a TMA box dimension)
_MAX_HEAD_DIM = 256
MAX_WIDE_HEAD_DIM = 1024   # the wide kernel's head dims


def paged_decode_attention_ref(q, pages_k, pages_v, block_table, lengths):
    """Plain version: q [lanes, H, hd]; pages_k/v [nb, bs, Hk, hd];
    block_table [lanes, MB] int32; lengths [lanes] (the position of the
    token just written, so slots ``0..lengths`` are visible). Returns
    [lanes, H, hd] in q's dtype."""
    lanes, mb = block_table.shape
    bs = pages_k.shape[1]
    kc = pages_k[block_table.long()].reshape(lanes, mb * bs, *pages_k.shape[2:])
    vc = pages_v[block_table.long()].reshape(lanes, mb * bs, *pages_v.shape[2:])
    slots = torch.arange(mb * bs, device=q.device)
    visible = slots[None, :] <= lengths[:, None]
    return masked_attend(q, kc, vc, visible)


def heads_per_pass(H: int, Hk: int) -> int:
    """Query heads one pass of the kernel takes: the GQA group's H / Hk
    rounded up to a power of two, at most 8; a larger group takes
    ceil(H / Hk / 8) passes, each a work item of its own."""
    rep, hp = H // Hk, 1
    while hp < rep and hp < _MAX_HEADS_PER_PASS:
        hp *= 2
    return hp


def grid_size(lanes: int, H: int, Hk: int, mb: int, sms: int) -> int:
    """Blocks of one launch, from the shapes alone (so a CUDA graph can
    hold the call): BLOCKS_PER_SM an SM, at most one per work item the
    largest lengths could give."""
    passes = -(-(H // Hk) // heads_per_pass(H, Hk))
    return max(1, min(BLOCKS_PER_SM * sms, lanes * Hk * passes * mb))


def split_schedule(lengths, bs: int, mb: int, H: int, Hk: int, grid: int) -> list:
    """The kernel's schedule, as the kernel computes it from ``lengths``.
    Each (lane, KV head, pass) pair's visible pages are cut into chunks of
    at most Kc pages, Kc the fewest that make the chunks fit the grid (one
    chunk a block; pairs beyond the grid get whole-pair chunks and the
    blocks loop). Chunks are numbered by lane, pair, then page, and block
    j takes chunks j, j + grid, ... Returns one dict a chunk, in chunk
    order: ``chunk``, ``block``, ``lane``, ``kv_head``, ``pass``, ``pair``
    (lane * Hk * passes + kv_head * passes + pass), ``pages`` (first, end)
    within the lane's visible pages, ``first`` (the pair's first chunk, so
    split k of a pair is chunk first + k) and ``splits`` (its chunks)."""
    cap = mb * bs
    passes = -(-(H // Hk) // heads_per_pass(H, Hk))
    per_lane = Hk * passes
    npages = [-(-(min(max(int(n), 0), cap - 1) + 1) // bs) for n in lengths]
    lo, hi = 1, max(npages)
    while lo < hi:
        kc = (lo + hi) // 2
        if per_lane * sum(-(-p // kc) for p in npages) <= grid:
            hi = kc
        else:
            lo = kc + 1
    chunks = []
    for b, p in enumerate(npages):
        cpp = -(-p // lo)
        for sub in range(per_lane):
            first = len(chunks)
            for ci in range(cpp):
                c = len(chunks)
                chunks.append({"chunk": c, "block": c % grid, "lane": b,
                               "kv_head": sub // passes, "pass": sub % passes,
                               "pair": b * per_lane + sub,
                               "pages": (ci * lo, min(p, (ci + 1) * lo)), "first": first,
                               "splits": cpp})
    return chunks


def paged_decode_attention_split(q, pages_k, pages_v, block_table, lengths, grid: int):
    """The kernel's arithmetic on the CPU: each chunk of
    :func:`split_schedule` leaves (max, sum, f32 accumulator) per query
    head over its pages, and each (lane, KV head, pass) merges its chunks
    in split order. Same arguments and result as
    :func:`paged_decode_attention_ref`."""
    lanes, H, hd = q.shape
    _, bs, Hk, _ = pages_k.shape
    mb = block_table.shape[1]
    rep, hp = H // Hk, heads_per_pass(H, Hk)
    scale = 1.0 / math.sqrt(hd)
    segs = split_schedule(lengths.tolist(), bs, mb, H, Hk, grid)
    nvis = [min(max(int(n), 0), mb * bs - 1) + 1 for n in lengths.tolist()]
    parts: dict = {}
    for s in segs:
        b, g, c = s["lane"], s["kv_head"], s["pass"]
        heads = slice(g * rep + c * hp, min(g * rep + (c + 1) * hp, (g + 1) * rep))
        pages = block_table[b, s["pages"][0]:s["pages"][1]].long()
        k = pages_k[pages, :, g].reshape(-1, hd).float()
        v = pages_v[pages, :, g].reshape(-1, hd).float()
        n = min(nvis[b] - s["pages"][0] * bs, k.shape[0])    # visible rows of the segment
        logits = (q[b, heads].float() @ k[:n].T) * scale
        m = logits.max(-1).values
        p = torch.exp(logits - m[:, None])
        parts.setdefault(s["pair"], []).append((m, p.sum(-1), p @ v[:n]))
    out = torch.empty_like(q)
    for s in segs:
        if s["chunk"] != s["first"]:
            continue
        b, g, c = s["lane"], s["kv_head"], s["pass"]
        heads = slice(g * rep + c * hp, min(g * rep + (c + 1) * hp, (g + 1) * rep))
        ms, ls, accs = zip(*parts[s["pair"]])                # in split (block) order
        mm = torch.stack(ms).max(0).values
        w = [torch.exp(m - mm) for m in ms]
        total = sum(wi * li for wi, li in zip(w, ls))
        acc = sum(wi[:, None] * ai for wi, ai in zip(w, accs))
        out[b, heads] = (acc / total[:, None]).to(q.dtype)
    return out


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_smem.argtypes = [ctypes.c_int] * 5
        lib.paged_attention_smem.restype = ctypes.c_int
    return lib


def smem_bytes(lanes: int, H: int, Hk: int, hd: int, bs: int, dtype) -> int:
    """Dynamic shared memory of one block of the kernel (built on first
    use): the page ring, its barriers, two ints a lane and the warps'
    partial results."""
    return _lib().paged_attention_smem(lanes, hd, bs, heads_per_pass(H, Hk), _DTYPES[dtype])


def _check(q, pages_k, pages_v, block_table, lengths):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention takes bf16, fp16 or f32 q, got {q.dtype}")
    if pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise TypeError("paged_decode_attention: pages must have q's dtype")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_table and lengths must be int32")
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be 16-byte aligned")
    if q.dim() != 3 or pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError("paged_decode_attention: q [lanes, H, hd], pages [nb, bs, Hk, hd]")
    lanes, H, hd = q.shape
    _, bs, Hk, phd = pages_k.shape
    if phd != hd or H % Hk:
        raise ValueError(f"paged_decode_attention: H={H}, Hk={Hk}, hd={hd}/{phd} "
                         "need H % Hk == 0 and equal head dims")
    if hd > MAX_WIDE_HEAD_DIM:
        raise ValueError(f"paged_decode_attention: hd={hd}; the kernels take up to "
                         f"{MAX_WIDE_HEAD_DIM}")
    if block_table.dim() != 2 or block_table.shape[0] != lanes or lengths.shape != (lanes,):
        raise ValueError("paged_decode_attention: block_table [lanes, MB], lengths [lanes]")


_scratch: dict = {}


def _scratch_for(device, lanes, H, Hk, hd, grid):
    """(partials, tickets) of one shape, allocated once a (device, shape)
    and kept: the kernel leaves the tickets zero after every call. Calls of
    one shape on one device share them, so they must not run concurrently
    on two streams."""
    key = (device.index, lanes, H, Hk, hd, grid)
    got = _scratch.get(key)
    if got is None:
        hp = heads_per_pass(H, Hk)
        pairs = lanes * Hk * -(-(H // Hk) // hp)
        hdp = -(-hd // 8) * 8   # a partial row's floats
        got = (torch.empty(((grid + pairs) * hp * (hdp + 2),), dtype=torch.float32,
                           device=device),
               torch.zeros((pairs,), dtype=torch.int32, device=device))
        _scratch[key] = got
    return got


def takes(hd: int, bs: int) -> bool:
    """Whether the TMA kernel takes a head dim and a page size (else the
    wide kernel runs the call)."""
    return hd <= _MAX_HEAD_DIM and bs <= _MAX_PAGE


def paged_decode_attention(q, pages_k, pages_v, block_table, lengths):
    """Attention of one query per lane over its KV pages. Same arguments
    and result as :func:`paged_decode_attention_ref`; on the card every
    tensor must be contiguous, block_table and lengths int32. Head dims or
    pages past 256 run :func:`paged_decode_attention_wide`."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pages_k, pages_v, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, pages_k, pages_v, block_table, lengths)
    if not takes(q.shape[2], pages_k.shape[1]):
        return paged_decode_attention_wide(q, pages_k, pages_v, block_table, lengths)
    lanes, H, hd = q.shape
    nb, bs, Hk, _ = pages_k.shape
    mb = block_table.shape[1]
    grid = grid_size(lanes, H, Hk, mb, _sm_count(q.device))
    part, tickets = _scratch_for(q.device, lanes, H, Hk, hd, grid)
    out = torch.empty_like(q)
    rc = _lib().paged_decode_attention(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_table.data_ptr(),
        lengths.data_ptr(), part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        lanes, H, Hk, hd, bs, mb, nb, grid, heads_per_pass(H, Hk), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: error {rc}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_wide(q, pages_k, pages_v, block_table, lengths):
    """The wide kernel (any page size, head dims up to 1024): same
    arguments and result as :func:`paged_decode_attention_ref`; one launch
    on the card, counted in its own ``launches``."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pages_k, pages_v, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, pages_k, pages_v, block_table, lengths)
    lanes, H, hd = q.shape
    _, bs, Hk, _ = pages_k.shape
    out = torch.empty_like(q)
    fn = _build.load("attention_wide").paged_wide
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lanes, H, Hk, hd, bs, block_table.shape[1],
            1.0 / math.sqrt(hd), _DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_wide kernel launch failed: error {rc}")
    paged_decode_attention_wide.launches += 1
    return out


_sms: dict = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


#: kernel launches since the last reset (the CPU path never counts)
paged_decode_attention.launches = 0
paged_decode_attention_wide.launches = 0
