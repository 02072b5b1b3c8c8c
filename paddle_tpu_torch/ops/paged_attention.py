"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py:68``
``paged_decode_attention``. On a CUDA tensor the wrapper launches the
kernel of ``csrc/paged_attention.cu`` or raises; it never declines to a
composed path. On a CPU tensor it runs :func:`paged_decode_attention_ref`,
the reference's composed semantics (gather the lane's pages through its
block-table row, then ``masked_attend``), which the CPU tests hold against
the reference package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.llama import masked_attend
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BUDGET = 40 * 1024   # shared memory a block aims for
_SMEM_MAX = 227 * 1024     # what a Hopper block may opt into
_TILE_TARGET = 64          # KV slots per block


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


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tile_slots(bs: int, hd: int, rep: int, esize: int) -> int:
    """KV slots one block attends over: whole pages, up to
    ``_TILE_TARGET`` slots and the shared-memory budget (K and V rows
    padded by 16 bytes, one score per query head, plus q in f32)."""
    per_slot = 2 * (hd * esize + 16) + 4 * rep
    fit = (_SMEM_BUDGET - 4 * rep * hd) // per_slot
    return max(1, min(_TILE_TARGET, fit) // bs) * bs


def smem_bytes(tile: int, hd: int, rep: int, esize: int) -> int:
    """Dynamic shared memory of one block (csrc/paged_attention.cu)."""
    return 2 * tile * (hd * esize + 16) + 4 * rep * hd + 4 * rep * tile


def _check(q, pages_k, pages_v, block_table, lengths):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention takes bf16 or f32 q, got {q.dtype}")
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
    _, _, Hk, phd = pages_k.shape
    if phd != hd or H % Hk or H // Hk > 32:
        raise ValueError(f"paged_decode_attention: H={H}, Hk={Hk}, hd={hd}/{phd} "
                         "need H % Hk == 0, H // Hk <= 32 and equal head dims")
    if hd % 32 or hd > 256:
        raise ValueError(f"paged_decode_attention: hd={hd} must be a multiple of 32, <= 256")
    if block_table.dim() != 2 or block_table.shape[0] != lanes or lengths.shape != (lanes,):
        raise ValueError("paged_decode_attention: block_table [lanes, MB], lengths [lanes]")
    bs, rep = pages_k.shape[1], H // Hk
    if smem_bytes(tile_slots(bs, hd, rep, q.element_size()), hd, rep,
                  q.element_size()) > _SMEM_MAX:
        raise ValueError(f"paged_decode_attention: a page of {bs} slots at hd={hd} "
                         "does not fit one block's shared memory")


def paged_decode_attention(q, pages_k, pages_v, block_table, lengths):
    """Attention of one query per lane over its KV pages. Same arguments
    and result as :func:`paged_decode_attention_ref`; on the card every
    tensor must be contiguous, block_table and lengths int32."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pages_k, pages_v, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, pages_k, pages_v, block_table, lengths)
    lanes, H, hd = q.shape
    _, bs, Hk, _ = pages_k.shape
    mb = block_table.shape[1]
    tile = tile_slots(bs, hd, H // Hk, q.element_size())
    splits = -(-mb * bs // tile)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:  # per-tile partial results, merged by a second kernel
        part_acc = torch.empty((lanes, H, splits, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((lanes, H, splits, 2), dtype=torch.float32, device=q.device)
    rc = _lib()(q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
                block_table.data_ptr(), lengths.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(), out.data_ptr(),
                lanes, H, Hk, hd, bs, mb, tile, 1.0 / math.sqrt(hd),
                _DTYPES[q.dtype], _build.launch_stream(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {rc}")
    paged_decode_attention.launches += 1
    return out


#: kernel launches since the last reset (the CPU path never counts)
paged_decode_attention.launches = 0
