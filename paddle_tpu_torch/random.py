"""The port's explicit random generator: the reference framework's
threefry2x32 keys, as tensor ops.

The reference draws every sampled token from threefry keys:
``PRNGKey(seed)``, ``split`` and ``categorical`` (bits -> uniform ->
Gumbel -> argmax), with partitionable threefry on (the counters of a draw
of shape ``s`` are the flat indices ``0 .. prod(s) - 1`` as a 64-bit iota,
high and low words). This module repeats that arithmetic bit
for bit, so a key is a pure function of (seed, number of splits) here as
there, and a CUDA graph can hold a draw: every step is an elementwise
tensor op on the key's device, with no host round trip.

A key is a tensor ``[..., 2]`` of 32-bit words held in int64 (uint32
arithmetic is thin in torch); every sum is masked back to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["prng_key", "split", "threefry2x32", "random_bits", "uniform", "gumbel",
           "categorical", "filter_logits"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny
NEG = -1e30


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); every argument an int64 tensor (or int) of
    32-bit words, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & M32
    y = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & M32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, y


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: ``[2]`` int64, the seed's high and low
    32-bit words (a seed in int32 range has a zero high word)."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & M32
    return torch.tensor([hi, seed & M32], dtype=torch.int64, device=device)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def split(key, num: int = 2) -> torch.Tensor:
    """``split``: keys ``[..., 2]`` -> ``[..., num, 2]``; new key i
    is the hash of the counter pair (0, i)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack((b1, b2), dim=-1)


def random_bits(key, shape) -> torch.Tensor:
    """32 random bits (int64) of ``shape`` under each key ``[..., 2]``:
    ``[..., *shape]``, the xor of the two words the counters ``0 ..
    prod(shape) - 1`` hash to."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape), key.device)
    k1 = key[..., 0].reshape(*key.shape[:-1], 1)
    k2 = key[..., 1].reshape(*key.shape[:-1], 1)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def uniform(key, shape, minval: float = 0.0) -> torch.Tensor:
    """f32 uniform in [minval, 1) as the reference draws it: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled by ``1 -
    minval`` in f32 (1.0 for the minval the Gumbel draw uses), plus
    minval, and at least minval."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # scalars, not tensors: no host-to-device copy, so a graph can hold it
    lo = float(np.float32(minval))
    scale = float(np.float32(1.0) - np.float32(minval))
    return torch.clamp_min(floats * scale + lo, lo)


def gumbel(key, shape) -> torch.Tensor:
    """Standard Gumbel noise in f32, ``-log(-log(u))`` with u uniform in
    [tiny, 1), the reference's "low" mode."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY)))


def categorical(key, logits) -> torch.Tensor:
    """``categorical(key, logits, axis=-1)``: the index of the
    largest ``logits + Gumbel noise`` over the last axis (the first one on a
    tie). ``key`` is one key ``[2]`` for a draw of logits' whole shape, or
    one key a row ``[*logits.shape[:-1], 2]``, each drawing its row's
    ``[V]`` as a vmap of the reference's per-row call does."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits.float(), dim=-1)


def filter_logits(lg, top_k, top_p):
    """Top-k then top-p filter of ``lg [rows, V]`` (f32) with per-row
    ``top_k [rows]`` and ``top_p [rows]`` (the reference's serving
    ``filter_logits`` as a vmap, and its generator's ``_pick_token``):
    filtered-out entries become -1e30; ``top_k <= 0`` and ``top_p >= 1``
    filter nothing. One descending sort serves both filters; the k-th
    largest value is the top-k cutoff, and top-p keeps the shortest prefix
    of the (top-k-masked) sorted row whose mass before each kept entry is
    below top_p, the top entry always."""
    V = lg.shape[-1]
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    on_k = (top_k > 0)[:, None]
    k = top_k.clamp(1, V).long()[:, None]
    kth = torch.gather(sorted_desc, 1, k - 1)
    lg = torch.where(on_k & (lg < kth), NEG, lg)
    col = torch.arange(V, device=lg.device)[None, :]
    masked = torch.where(on_k & (col >= k), NEG, sorted_desc)
    probs = torch.softmax(masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs < top_p[:, None]) | (col == 0)
    cutoff = torch.where(keep, masked, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where((top_p < 1.0)[:, None] & (lg < cutoff), NEG, lg)
