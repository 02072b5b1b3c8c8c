"""The numerics sentinels' reduction (``csrc/sentinels.cu``): for each of a
list of tensors, its sum of squares in f32, its digest (the wrapping
32-bit sum of its elements' f32 bit patterns) and its count of NaN and
Inf elements, in one read of every element.

:func:`tensor_stats` returns ``(sq, ints)``: ``sq`` an f32 tensor of the
sums of squares, ``ints`` an int64 tensor ``[2, n]`` of the digests (each
in ``[0, 2^32)``) and the counts. On CUDA tensors it launches the kernel
(one call: the chunk kernel and the per-tensor kernel); on CPU tensors it
runs the plain version, :func:`tensor_stats_plain`, which composes torch
ops. Digests and counts are exact on both and equal; the sums of squares
agree to f32 rounding (each sums in its own order).

A bf16 element's f32 bits are its own 16 bits shifted left by 16, so a
bf16 tensor's digest is ``(sum of its u16 bits mod 2^16) << 16``: neither
version makes an f32 copy of a bf16 tensor for it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..profiler import attribution as _attrib
from . import _build

__all__ = ["CHUNK", "tensor_stats", "tensor_stats_plain"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 65536        # elements a block (kChunk)
PARTIAL_BYTES = 16   # sizeof(Partial)
# the kernel's 32-byte Meta row
META = np.dtype({"names": ["p", "n", "first_chunk", "dtype", "pad"],
                 "formats": ["<u8", "<i8", "<i8", "<i4", "<i4"],
                 "offsets": [0, 8, 16, 24, 28], "itemsize": 32})
_MASK32 = 0xFFFFFFFF


def _digest_plain(t: torch.Tensor) -> torch.Tensor:
    """The wrapping u32 sum of ``t``'s f32 bit patterns, as int64."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return (torch.sum(t.view(torch.int16), dtype=torch.int64) & 0xFFFF) << 16
    if t.dtype != torch.float32:
        t = t.float()
    return torch.sum(t.view(torch.int32), dtype=torch.int64) & _MASK32


def tensor_stats_plain(tensors) -> tuple:
    """The plain version: per tensor ``sum(square(t.float()))``,
    :func:`_digest_plain` and ``count(~isfinite(t))``, stacked."""
    sq = torch.stack([torch.sum(torch.square(t.float())) for t in tensors])
    ints = torch.stack([torch.stack([_digest_plain(t),
                                     torch.sum(~torch.isfinite(t), dtype=torch.int64)])
                        for t in tensors], dim=1)
    return sq, ints


def _fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load("sentinels"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check_abi():
    abi = (ctypes.c_longlong * 3)()
    _fn("sentinels_abi", [ctypes.c_void_p], None)(ctypes.addressof(abi))
    if tuple(abi) != (META.itemsize, CHUNK, PARTIAL_BYTES):
        raise RuntimeError(f"sentinels.cu has Meta size, chunk and partial size {tuple(abi)}, "
                           f"the wrapper {(META.itemsize, CHUNK, PARTIAL_BYTES)}")


def tensor_stats(tensors) -> tuple:
    """``(sq, ints)`` of ``tensors`` (f32, bf16 or fp16; CUDA: the kernel,
    CPU: the plain version). Counts one launch a call on the card."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("tensor_stats needs at least one tensor")
    device = tensors[0].device
    if device.type == "cpu":
        return tensor_stats_plain(tensors)
    if device.type != "cuda":
        raise ValueError(f"tensor_stats runs on cuda or cpu, not {device}")
    if "sentinels" not in _build._loaded:
        _check_abi()
    # keep: contiguous copies stay referenced until the launch is queued
    keep = [t.contiguous() for t in tensors]
    for t in keep:
        if t.device != device:
            raise ValueError(f"tensor_stats: tensors on {t.device} and {device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"tensor_stats takes f32, bf16 or fp16, not {t.dtype}")
    n = np.array([t.numel() for t in keep], np.int64)
    if not n.all():
        raise ValueError("tensor_stats: an empty tensor")
    chunks = -(-n // CHUNK)
    meta = np.zeros(len(keep), META)
    meta["p"] = [t.data_ptr() for t in keep]
    meta["n"] = n
    meta["first_chunk"] = np.cumsum(chunks) - chunks
    meta["dtype"] = [DTYPES[t.dtype] for t in keep]
    first = int(chunks.sum())
    raw = meta.view(np.uint8).reshape(-1)
    host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = raw
    dev = torch.empty(raw.size, dtype=torch.uint8, device=device)
    dev.copy_(host, non_blocking=True)
    part = torch.empty(first * PARTIAL_BYTES, dtype=torch.uint8, device=device)
    sq = torch.empty(len(keep), dtype=torch.float32, device=device)
    ints = torch.empty((2, len(keep)), dtype=torch.int64, device=device)
    fn = _fn("sentinel_stats", [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p])
    rc = fn(dev.data_ptr(), len(keep), first, part.data_ptr(), sq.data_ptr(), ints.data_ptr(),
            _build.launch_stream(device))
    if rc != 0:
        raise RuntimeError(f"sentinel_stats kernel launch failed: CUDA error {rc}")
    tensor_stats.launches += 1
    _attrib.note_kernel(3 * int(n.sum()), sum(t.numel() * t.element_size() for t in keep))
    return sq, ints


#: kernel launches (calls that launched) since the last reset; the CPU path
#: never counts
tensor_stats.launches = 0
