"""Search and sort ops (counterpart of ``paddle_tpu/ops/search.py``).
Indices are int32. Sorts are stable (``argsort``, ``sort``, ``kthvalue``:
ties keep their order; descending reverses the ascending stable order,
as the reference does); ``topk`` takes the lower index first among ties;
``mode`` gives the smallest of the most frequent values."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.random import default_generator
from ..tensor import from_numpy
from ._helpers import as_tensor, narrow

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "searchsorted",
           "bucketize", "index_fill", "top_p_sampling", "edit_distance"]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = as_tensor(x)
    if axis is None:
        out = torch.argmax(x)
        return narrow(out.reshape([1] * x.dim()) if keepdim else out)
    return narrow(torch.argmax(x, dim=int(axis), keepdim=keepdim))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = as_tensor(x)
    if axis is None:
        out = torch.argmin(x)
        return narrow(out.reshape([1] * x.dim()) if keepdim else out)
    return narrow(torch.argmin(x, dim=int(axis), keepdim=keepdim))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = as_tensor(x)
    idx = torch.argsort(x, dim=axis, stable=True)
    return narrow(torch.flip(idx, [axis]) if descending else idx)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = as_tensor(x)
    idx = torch.argsort(x, dim=axis, stable=True)
    if descending:
        idx = torch.flip(idx, [axis])
    return torch.take_along_dim(x, idx, dim=axis)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """``(values, indices)`` of the ``k`` largest (smallest) along ``axis``."""
    x = as_tensor(x)
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    ax = int(axis) % x.dim()
    key = x if largest else -x
    idx = torch.argsort(key, dim=ax, descending=True, stable=True).narrow(ax, 0, k)
    return torch.take_along_dim(x, idx, dim=ax), narrow(idx)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = as_tensor(x)
    ax = int(axis) % x.dim()
    idx = torch.argsort(x, dim=ax, stable=True).narrow(ax, int(k) - 1, 1)
    vals = torch.take_along_dim(x, idx, dim=ax)
    if not keepdim:
        vals, idx = vals.squeeze(ax), idx.squeeze(ax)
    return vals, narrow(idx)


def mode(x, axis=-1, keepdim=False, name=None):
    """``(values, counts)``: the most frequent value along ``axis`` (the
    smallest among ties) and how often it occurs."""
    x = as_tensor(x)
    ax = int(axis) % x.dim()
    s = torch.sort(x, dim=ax, stable=True).values.movedim(ax, -1)
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    run = torch.cumsum(new.long(), -1) - 1                  # run id of each position
    counts = torch.zeros_like(run).scatter_add_(-1, run, torch.ones_like(run))
    best = torch.argmax(counts, -1, keepdim=True)           # first (smallest) longest run
    first = torch.argmax((run == best).long(), -1, keepdim=True)
    vals = torch.gather(s, -1, first).squeeze(-1)
    cnt = torch.gather(counts, -1, best).squeeze(-1)
    if keepdim:
        vals, cnt = vals.unsqueeze(ax), cnt.unsqueeze(ax)
    return vals, narrow(cnt)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    ss, v = as_tensor(sorted_sequence), as_tensor(values)
    return narrow(torch.searchsorted(ss, v.to(ss.dtype), right=right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_fill(x, index, axis, value, name=None):
    x, index = as_tensor(x), as_tensor(index)
    v = value.item() if isinstance(value, torch.Tensor) else value
    return torch.index_fill(x, int(axis), index.reshape(-1).long(), v)


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0, mode="truncated",
                   return_top=False, name=None, *, generator=None):
    """Nucleus sampling, one token a row: the smallest prefix of the sorted
    softmax reaching ``ps`` (in ``"truncated"`` mode the tokens whose
    preceding sum is below ``ps``; else those whose sum is at most
    ``ps``), at most ``k`` of them when ``k`` > 0, at least
    ``threshold``; renormalised, then one draw. ``seed`` >= 0 draws from a
    generator of its own; the bits are torch's. Returns ``(probs,
    indices)``, and with ``return_top`` also each row's top-1 (prob, id)."""
    if mode not in ("truncated", "non-truncated"):
        raise ValueError(f"top_p_sampling: bad mode {mode!r}")
    x, ps = as_tensor(x), as_tensor(ps)
    probs = torch.softmax(x.float(), -1).to(x.dtype)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sortp = torch.take_along_dim(probs, order, -1)
    cum = torch.cumsum(sortp, -1)
    p = ps.reshape(sortp.shape[:-1] + (1,)).to(sortp.dtype)
    keep = (cum - sortp) < p if mode == "truncated" else cum <= p
    keep[..., 0] = True
    if k and k > 0:
        keep &= torch.arange(sortp.shape[-1], device=x.device) < k
    if threshold is not None:
        keep &= sortp >= as_tensor(threshold, x).reshape(p.shape)
        keep[..., 0] = True
    masked = torch.where(keep, sortp, torch.zeros((), dtype=sortp.dtype, device=x.device))
    masked = masked / masked.sum(-1, keepdim=True)
    if seed >= 0 and generator is None:
        generator = torch.Generator(device=x.device)
        generator.manual_seed(int(seed))
    g = torch.rand(masked.shape[:-1] + (1,), device=x.device,
                   generator=generator or default_generator(x.device))
    pick = torch.clamp((torch.cumsum(masked, -1) < g.to(masked.dtype)).sum(-1, keepdim=True),
                       max=masked.shape[-1] - 1)
    idx = torch.take_along_dim(order, pick, -1)
    val = torch.take_along_dim(probs, idx, -1)
    if return_top:
        return val, narrow(idx), sortp[..., :1], narrow(order[..., :1])
    return val, narrow(idx)


def edit_distance(input, label, normalized=True, ignored_tokens=None, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance a row (on the host, as the reference's):
    ``(distance [N, 1] f32, sequence_num [1])``."""
    a = as_tensor(input).detach().cpu().numpy()
    b = as_tensor(label).detach().cpu().numpy()
    dev = as_tensor(input).device
    il = (as_tensor(input_length).cpu().numpy().reshape(-1) if input_length is not None
          else np.full(a.shape[0], a.shape[1]))
    ll = (as_tensor(label_length).cpu().numpy().reshape(-1) if label_length is not None
          else np.full(b.shape[0], b.shape[1]))
    ign = set(ignored_tokens or ())

    def lev(s, t):
        s = [c for c in s if c not in ign]
        t = [c for c in t if c not in ign]
        dp = np.arange(len(t) + 1, dtype=np.float64)
        for i in range(1, len(s) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, len(t) + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + (s[i - 1] != t[j - 1]))
        return dp[len(t)], len(t)

    out = np.zeros((a.shape[0], 1), np.float32)
    for r in range(a.shape[0]):
        d, n = lev(list(a[r, :int(il[r])]), list(b[r, :int(ll[r])]))
        out[r, 0] = d / max(n, 1) if normalized else d
    return (from_numpy(out).to(dev),
            torch.tensor([a.shape[0]], dtype=torch.int32, device=dev))
