"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py:68``
``paged_decode_attention``. On a CUDA tensor the wrapper launches the
kernel of ``csrc/paged_attention.cu`` or raises; it never declines to a
composed path. On a CPU tensor it runs :func:`paged_decode_attention_ref`,
the reference's composed semantics (gather the lane's pages through its
block-table row, then ``masked_attend``), which the CPU tests hold against
the reference package.

The kernel is one launch with a grid fixed by the shapes (:func:`grid_size`):
each (lane, KV head, pass) pair's visible units are cut into chunks of Kc
units, Kc fixed by the shapes (:func:`chunk_units`), so a lane's split
points depend on its own length only; block j takes chunks j, j + grid,
...; a pair cut into several chunks is merged, in chunk order, by the
block that finishes it last. :func:`split_schedule` and
:func:`paged_decode_attention_split` repeat that schedule and merge on the
CPU, so the tests hold them against the plain version and the reference.

Every call takes one of two modes of the kernel (:func:`mode`, counted in
``paged_decode_attention.by_route``): ``narrow`` for head dims and pages up
to 256 (a unit is a page; each of four consumer warps takes every fourth
stage), ``wide`` past either, as the reference's composed path serves any
size (a unit is a box of :func:`wide_geometry`'s rows of a page; each
consumer warp owns a slice of the columns, and the slices' partial scores
are added in warp order).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.llama import masked_attend
from ..profiler import attribution as _attrib
from . import _build

__all__ = ["MODES", "chunk_units", "grid_size", "heads_per_pass", "mode",
           "paged_decode_attention", "paged_decode_attention_ref",
           "paged_decode_attention_split", "split_schedule", "wide_geometry"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCKS_PER_SM = 2          # the grid: this many blocks an SM, at most one a work item
WIDE_BLOCKS_PER_SM = 1     # head dims past 256: half as many splits of a pair to merge
# chunks a block takes with every lane full (chunk_units): 2 runs the
# engine's decode traffic, where most lanes are short or idle, faster than 1
# (chip_smoke.py's paged-traffic lines time both); lanes all long run slower
FILL = 2
_MAX_HEADS_PER_PASS = 8    # query heads a pass of the kernel takes
NARROW = 256               # head dims and page sizes of the narrow mode (a TMA box's width)
MAX_HEAD_DIM = 1024        # the kernel's head dims
MODES = ("narrow", "wide")
SLICES = 4                 # wide: column slices, one a consumer warp
_BOX_BYTES = 8192          # bytes of a box (narrow), of a slice's box across the slices (wide)


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


def grid_size(lanes: int, H: int, Hk: int, mb: int, sms: int, hd: int = 0) -> int:
    """Blocks of one launch, from the shapes alone (so a CUDA graph can
    hold the call): BLOCKS_PER_SM an SM (WIDE_BLOCKS_PER_SM past NARROW
    columns, where a split's partial is up to four times larger to merge),
    at most one per work item the largest lengths could give (``mb``: the
    units a lane may hold)."""
    passes = -(-(H // Hk) // heads_per_pass(H, Hk))
    per_sm = WIDE_BLOCKS_PER_SM if hd > NARROW else BLOCKS_PER_SM
    return max(1, min(per_sm * sms, lanes * Hk * passes * mb))


def chunk_units(lanes: int, H: int, Hk: int, units: int, grid: int) -> int:
    """Kc, the units (pages; wide: boxes of rows of a page) of a chunk, from
    the shapes alone (``units``: those of a full lane): the fewest that fit
    every pair's chunks to FILL times the grid with every lane full, or
    whole pairs where the pairs outnumber that. A lane's split points then
    depend on its own length only."""
    pairs = lanes * Hk * -(-(H // Hk) // heads_per_pass(H, Hk))
    return -(-units // max(1, FILL * grid // pairs))


def mode(hd: int, bs: int) -> str:
    """The kernel's mode for a head dim and a page size: ``narrow`` up to
    NARROW in both, else ``wide``."""
    return "narrow" if hd <= NARROW and bs <= NARROW else "wide"


def wide_geometry(hd: int, bs: int, es: int) -> tuple:
    """The wide mode's (slice columns, box rows) at a head dim, page size
    and element size, as ``geometry`` in ``csrc/paged_attention.cu``
    computes them: each of SLICES warps owns ``wc = round_up(ceil(hd /
    SLICES), 8)`` columns, read as a box ``wc + 8`` wide (``wc`` where TMA
    would pass 256); a box is whole 16-row groups (f32: 8) within
    _BOX_BYTES across the slices, at least one group and at most a page. A
    box of rows of a page is the schedule's unit: ``ceil(bs / rows)`` a
    page, the last one reaching past the page's end where ``rows`` does not
    divide ``bs``."""
    wc = -(-(-(-hd // SLICES)) // 8) * 8
    pitch = wc if hd * es % 16 == 0 and wc + 8 > 256 else wc + 8
    group = 16 if es == 2 else 8
    fit = _BOX_BYTES // (SLICES * pitch * es) // group * group
    return wc, min(bs, max(group, fit))


def _units(n: int, bs: int, rows: int) -> int:
    """Units of a lane that sees n slots: boxes of ``rows`` rows of its
    pages, ceil(bs / rows) a page, the last page's cut short."""
    return n // bs * -(-bs // rows) + -(-(n % bs) // rows)


def split_schedule(lengths, bs: int, mb: int, H: int, Hk: int, grid: int,
                   rows: int | None = None) -> list:
    """The kernel's schedule, as the kernel computes it from ``lengths``.
    Each (lane, KV head, pass) pair's visible units (pages, or with
    ``rows`` boxes of that many rows of a page: the wide mode's) are cut
    into chunks of Kc units (:func:`chunk_units`: FILL chunks a block with
    every lane full; pairs beyond that get whole-pair chunks), so a lane's
    chunks depend on its own length only. Chunks are numbered by lane,
    pair, then unit, and block j takes chunks j, j + grid, ... Returns one
    dict a
    chunk, in chunk order: ``chunk``, ``block``, ``lane``, ``kv_head``,
    ``pass``, ``pair`` (lane * Hk * passes + kv_head * passes + pass),
    ``units`` (first, end) within the lane's visible units, ``first`` (the
    pair's first chunk, so split k of a pair is chunk first + k) and
    ``splits`` (its chunks)."""
    cap, rows = mb * bs, rows or bs
    passes = -(-(H // Hk) // heads_per_pass(H, Hk))
    per_lane = Hk * passes
    nunits = [_units(min(max(int(n), 0), cap - 1) + 1, bs, rows) for n in lengths]
    lo = chunk_units(len(lengths), H, Hk, _units(cap, bs, rows), grid)
    chunks = []
    for b, p in enumerate(nunits):
        cpp = -(-p // lo)
        for sub in range(per_lane):
            first = len(chunks)
            for ci in range(cpp):
                c = len(chunks)
                chunks.append({"chunk": c, "block": c % grid, "lane": b,
                               "kv_head": sub // passes, "pass": sub % passes,
                               "pair": b * per_lane + sub,
                               "units": (ci * lo, min(p, (ci + 1) * lo)), "first": first,
                               "splits": cpp})
    return chunks


def paged_decode_attention_split(q, pages_k, pages_v, block_table, lengths, grid: int):
    """The kernel's arithmetic on the CPU: each chunk of
    :func:`split_schedule` leaves (max, sum, f32 accumulator) per query
    head over its units, and each (lane, KV head, pass) merges its chunks
    in split order. In the wide mode the units are boxes of rows of a page
    and the scores are the SLICES column slices' partial products added in
    slice (warp) order. Same arguments and result as
    :func:`paged_decode_attention_ref`."""
    lanes, H, hd = q.shape
    _, bs, Hk, _ = pages_k.shape
    mb = block_table.shape[1]
    rep, hp = H // Hk, heads_per_pass(H, Hk)
    scale = 1.0 / math.sqrt(hd)
    wide = mode(hd, bs) == "wide"
    wc, rows = wide_geometry(hd, bs, q.element_size()) if wide else (hd, bs)
    upp = -(-bs // rows)
    segs = split_schedule(lengths.tolist(), bs, mb, H, Hk, grid, rows)
    nvis = [min(max(int(n), 0), mb * bs - 1) + 1 for n in lengths.tolist()]
    parts: dict = {}
    for s in segs:
        b, g, c = s["lane"], s["kv_head"], s["pass"]
        heads = slice(g * rep + c * hp, min(g * rep + (c + 1) * hp, (g + 1) * rep))
        spans = []                                           # (page, first row, rows) a unit
        for u in range(*s["units"]):
            pi, r0 = u // upp, u % upp * rows
            spans.append((int(block_table[b, pi]), r0, min(rows, bs - r0, nvis[b] - pi * bs - r0)))
        k = torch.cat([pages_k[p, r0:r0 + n, g] for p, r0, n in spans]).float()
        v = torch.cat([pages_v[p, r0:r0 + n, g] for p, r0, n in spans]).float()
        qh = q[b, heads].float()
        if wide:
            logits = qh[:, :wc] @ k[:, :wc].T
            for w in range(1, SLICES):
                logits = logits + qh[:, w * wc:(w + 1) * wc] @ k[:, w * wc:(w + 1) * wc].T
        else:
            logits = qh @ k.T
        logits = logits * scale
        m = logits.max(-1).values
        p = torch.exp(logits - m[:, None])
        parts.setdefault(s["pair"], []).append((m, p.sum(-1), p @ v))
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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attention: hd={hd}; the kernel takes up to "
                         f"{MAX_HEAD_DIM}")
    if block_table.dim() != 2 or block_table.shape[0] != lanes or lengths.shape != (lanes,):
        raise ValueError("paged_decode_attention: block_table [lanes, MB], lengths [lanes]")


_scratch: dict = {}


def _plan_for(q, pages_k, block_table) -> tuple:
    """(grid, Kc, partial slots) of the launch for these tensors:
    :func:`grid_size` and :func:`chunk_units` over the mode's units a full
    lane, and every pair's chunks with every lane full."""
    lanes, H, hd = q.shape
    _, bs, Hk, _ = pages_k.shape
    units = block_table.shape[1]
    if mode(hd, bs) == "wide":
        units *= -(-bs // wide_geometry(hd, bs, q.element_size())[1])
    grid = grid_size(lanes, H, Hk, units, _sm_count(q.device), hd)
    kc = chunk_units(lanes, H, Hk, units, grid)
    pairs = lanes * Hk * -(-(H // Hk) // heads_per_pass(H, Hk))
    return grid, kc, pairs * -(-units // kc)


def _scratch_for(device, lanes, H, Hk, hd, slots):
    """(partials, tickets) of one shape, allocated once a (device, shape)
    and kept: ``slots`` partials, and tickets the kernel leaves zero after
    every call. Calls of
    one shape on one device share them, so they must not run concurrently
    on two streams."""
    key = (device.index, lanes, H, Hk, hd, slots)
    got = _scratch.get(key)
    if got is None:
        hp = heads_per_pass(H, Hk)
        pairs = lanes * Hk * -(-(H // Hk) // hp)
        hdp = -(-hd // 8) * 8   # a partial row's floats
        got = (torch.empty((slots * hp * (hdp + 2),), dtype=torch.float32, device=device),
               torch.zeros((pairs,), dtype=torch.int32, device=device))
        _scratch[key] = got
    return got


def paged_decode_attention(q, pages_k, pages_v, block_table, lengths):
    """Attention of one query per lane over its KV pages. Same arguments
    and result as :func:`paged_decode_attention_ref`; on the card every
    tensor must be contiguous, block_table and lengths int32. One launch a
    call, in the mode :func:`mode` gives (head dims or pages past 256:
    ``wide``), counted in ``launches`` and ``by_route``."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pages_k, pages_v, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, pages_k, pages_v, block_table, lengths)
    lanes, H, hd = q.shape
    nb, bs, Hk, _ = pages_k.shape
    mb = block_table.shape[1]
    route = mode(hd, bs)
    grid, kc, slots = _plan_for(q, pages_k, block_table)
    part, tickets = _scratch_for(q.device, lanes, H, Hk, hd, slots)
    out = torch.empty_like(q)
    rc = _lib().paged_decode_attention(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), block_table.data_ptr(),
        lengths.data_ptr(), part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
        lanes, H, Hk, hd, bs, mb, nb, grid, heads_per_pass(H, Hk), kc, 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: error {rc}")
    paged_decode_attention.launches += 1
    paged_decode_attention.by_route[route] += 1
    if _attrib.counting_active():
        # the call's cost: q and out once, each visible K and V row once,
        # the visible table entries and the lengths (chip_smoke.py's
        # ``paged_bound``); one read of the lengths, in the counted call only
        vis = [min(int(n) + 1, mb * bs) for n in lengths.tolist()]
        es = q.element_size()
        _attrib.note_kernel(sum(vis) * H * hd * 4,
                            lanes * H * hd * es * 2 + sum(vis) * Hk * hd * es * 2
                            + sum(-(-n // bs) for n in vis) * 4 + lanes * 4,
                            f32=q.dtype == torch.float32)
    return out


_sms: dict = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


#: kernel launches since the last reset, in all and by mode (the CPU path never counts)
paged_decode_attention.launches = 0
paged_decode_attention.by_route = dict.fromkeys(MODES, 0)
