"""Products and norms (counterpart of ``paddle_tpu/ops/linalg.py``).

A plain product is ``torch.matmul``: the reference computes it outside
any hand-written kernel too. The decompositions and solvers (cholesky,
qr, svd, eig, lu, det, inv, solve, lstsq, ...) come with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ._helpers import as_tensor, narrow

__all__ = ["matmul", "mm", "bmm", "dot", "t", "cross", "dist", "norm", "einsum",
           "matrix_transpose", "multi_dot", "mv", "bincount", "histogram", "corrcoef", "cov",
           "cdist", "vector_norm", "matrix_norm", "pdist"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = as_tensor(x), as_tensor(y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dot(x, y, name=None):
    """The sum of the products along the last axis (batched for 2-D)."""
    x, y = as_tensor(x), as_tensor(y)
    return narrow(torch.sum(x * y, dim=-1))


def t(input, name=None):
    input = as_tensor(input)
    return input.clone() if input.dim() < 2 else input.T


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (the default: the first axis of
    size 3)."""
    x, y = as_tensor(x), as_tensor(y)
    ax = axis if axis != 9 else next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=ax)


def dist(x, y, p=2, name=None):
    x, y = as_tensor(x), as_tensor(y)
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The Frobenius (``p`` None or "fro") or ``p``-norm over ``axis`` (all
    entries for None); ``inf`` / ``-inf`` the largest / smallest magnitude,
    0 the count of nonzeros."""
    x = as_tensor(x)
    if axis is None and (p is None or p == "fro" or p == 2):
        return torch.sqrt(torch.sum(torch.square(x)))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p is None or p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=keepdim))
    return vector_norm(x, float(p), ax, keepdim)


def einsum(equation, *operands):
    return torch.einsum(equation, *[as_tensor(o) for o in operands])


def matrix_transpose(x, name=None):
    return as_tensor(x).transpose(-1, -2)


def multi_dot(tensors, name=None):
    return torch.linalg.multi_dot([as_tensor(t) for t in tensors])


def bincount(x, weights=None, minlength=0, name=None):
    x = as_tensor(x)
    w = None if weights is None else as_tensor(weights, x)
    return narrow(torch.bincount(x.reshape(-1), w, int(minlength))).detach()


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), int32."""
    x = as_tensor(input).detach()
    xf = x.float()
    lo, hi = (xf.min().item(), xf.max().item()) if min == 0 and max == 0 else (min, max)
    edges = torch.linspace(lo, hi, bins + 1, device=x.device)
    idx = torch.clamp(torch.bucketize(xf.reshape(-1), edges, right=True) - 1, 0, bins - 1)
    inside = (xf.reshape(-1) >= lo) & (xf.reshape(-1) <= hi)
    return narrow(torch.bincount(idx[inside], minlength=bins))


def corrcoef(x, rowvar=True, name=None):
    x = as_tensor(x)
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = as_tensor(x)
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=None if fweights is None else as_tensor(fweights, x),
                     aweights=None if aweights is None else as_tensor(aweights, x))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary", name=None):
    """Pairwise ``p``-norm distances ``[..., n, m]``; for ``p`` = 2 through
    ``|x|^2 + |y|^2 - 2 x y^T`` (the reference's form) unless
    ``compute_mode`` says not to."""
    x, y = as_tensor(x), as_tensor(y)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = torch.sum(x * x, -1)[..., :, None]
        y2 = torch.sum(y * y, -1)[..., None, :]
        xy = torch.matmul(x, y.transpose(-1, -2))
        return torch.sqrt(torch.clamp(x2 + y2 - 2.0 * xy, min=0.0))
    d = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    return torch.clamp(torch.sum(d ** p, -1), min=0.0) ** (1.0 / p)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The entrywise ``p``-norm over ``axis`` (every entry for None; with
    ``keepdim`` the result keeps the input's rank)."""
    x = as_tensor(x)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p == 0:
        out = torch.sum((x != 0).to(x.dtype), dim=ax, keepdim=keepdim) if ax is not None else \
            torch.sum((x != 0).to(x.dtype))
    elif ax is None:
        out = torch.linalg.vector_norm(x.reshape(-1), ord=p)
    else:
        out = torch.linalg.vector_norm(x, ord=p, dim=ax, keepdim=keepdim)
    if ax is None and keepdim:
        out = out.reshape([1] * x.dim())
    return out


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """fro, nuc, 1, -1, 2, -2, inf, -inf over the two axes of ``axis``."""
    x = as_tensor(x)
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(int(a) for a in axis),
                                    keepdim=keepdim)


def pdist(x, p=2.0, name=None):
    """The upper triangle (``i < j``) of ``cdist(x, x, p)``, flattened."""
    x = as_tensor(x)
    n = x.shape[0]
    iu = np.triu_indices(n, k=1)
    flat = cdist(x, x, p=p).reshape(-1)
    return flat[torch.as_tensor(iu[0] * n + iu[1], device=x.device)]
