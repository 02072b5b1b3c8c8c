"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

A new tensor goes to the default device of :mod:`paddle_tpu_torch.device`
(the card unless set), or to the device of the tensor it is made from.
The reference's dtype rule: float data in the default dtype, integers in
int32 (a requested ``"int64"`` narrows to int32). The random ops draw
from the port's generator of their device
(:func:`paddle_tpu_torch.framework.random.default_generator`) unless
given ``generator=``.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from .. import dtype as _dt
from ..device import default_device
from ..framework.random import default_generator
from ..tensor import from_numpy
from ._helpers import as_tensor, int_list, narrow

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
           "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
           "diag_embed", "tril", "triu", "meshgrid", "clone", "tril_indices", "triu_indices",
           "complex", "rand", "randn", "normal", "uniform", "randint", "randint_like",
           "randperm", "bernoulli", "multinomial", "standard_normal", "poisson", "rand_like",
           "randn_like", "binomial", "standard_gamma", "log_normal", "histogramdd",
           "exponential_", "geometric_", "normal_", "log_normal_", "cauchy_", "bernoulli_"]


def _d(dtype, default=None):
    if dtype is None:
        return default if default is not None else _dt.get_default_dtype()
    return _dt.convert_dtype(dtype)


def _gen(device, generator):
    return generator if generator is not None else default_generator(device)


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(int_list(shape), dtype=_d(dtype), device=device or default_device())


def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(int_list(shape), dtype=_d(dtype), device=device or default_device())


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    """Without ``dtype``: a bool, int or float fill gives bool, int32 or
    the default float dtype."""
    fill_value = _item(fill_value)
    if dtype is None:
        dtype = (torch.bool if isinstance(fill_value, (bool, np.bool_)) else
                 torch.int32 if isinstance(fill_value, (int, np.integer)) else
                 torch.complex64 if isinstance(fill_value, builtins.complex) else None)
    return torch.full(int_list(shape), fill_value, dtype=_d(dtype),
                      device=device or default_device())


def empty(shape, dtype=None, name=None, *, device=None):
    """Zeros, as the reference's (its arrays have no uninitialised state)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return torch.zeros(x.shape, dtype=_d(dtype, x.dtype), device=x.device)


def ones_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return torch.ones(x.shape, dtype=_d(dtype, x.dtype), device=x.device)


def full_like(x, fill_value, dtype=None, name=None):
    x = as_tensor(x)
    return torch.full(x.shape, _item(fill_value), dtype=_d(dtype, x.dtype), device=x.device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, device=None):
    """Integers give int32, a float anywhere the default float dtype."""
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        floats = any(isinstance(v, (float, np.floating)) for v in (start, end, step))
        dtype = _dt.get_default_dtype() if floats else torch.int32
    return torch.arange(start, end, step, dtype=_d(dtype), device=device or default_device())


def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return torch.linspace(_item(start), _item(stop), int(_item(num)), dtype=_d(dtype),
                          device=device or default_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *, device=None):
    return torch.logspace(_item(start), _item(stop), int(_item(num)), base=base,
                          dtype=_d(dtype), device=device or default_device())


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    n = int(_item(num_rows))
    m = n if num_columns is None else int(_item(num_columns))
    return torch.eye(n, m, dtype=_d(dtype), device=device or default_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` as the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``); a 2-D ``x``'s ``offset`` diagonal."""
    x = as_tensor(x)
    out = torch.diag(x, offset)
    if padding_value != 0 and x.dim() == 1:
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(on, out, torch.tensor(padding_value, dtype=out.dtype))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(as_tensor(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(as_tensor(x), offset, dim1, dim2)


def tril(x, diagonal=0, name=None):
    return torch.tril(as_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(as_tensor(x), diagonal)


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    return list(torch.meshgrid(*[as_tensor(t) for t in ts], indexing="ij"))


def clone(x, name=None):
    return as_tensor(x).clone()


def tril_indices(row, col, offset=0, dtype="int64", name=None, *, device=None):
    return torch.tril_indices(row, col, offset, dtype=_d(dtype),
                              device=device or default_device())


def triu_indices(row, col=None, offset=0, dtype="int64", name=None, *, device=None):
    return torch.triu_indices(row, row if col is None else col, offset, dtype=_d(dtype),
                              device=device or default_device())


def complex(real, imag, name=None):
    return torch.complex(as_tensor(real), as_tensor(imag))


# -- random creation ----------------------------------------------------------
def rand(shape, dtype=None, name=None, *, device=None, generator=None):
    return uniform(shape, dtype, min=0.0, max=1.0, device=device, generator=generator)


def randn(shape, dtype=None, name=None, *, device=None, generator=None):
    dev = device or default_device()
    return torch.randn(int_list(shape), dtype=_d(dtype), device=dev,
                       generator=_gen(dev, generator))


def standard_normal(shape, dtype=None, name=None, *, device=None, generator=None):
    return randn(shape, dtype, device=device, generator=generator)


def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None, generator=None):
    """``mean + std * N(0, 1)``: of ``shape`` for scalars (default ``[1]``),
    of the broadcast shape of tensor ``mean`` / ``std``, in the default
    dtype."""
    dt = _dt.get_default_dtype()
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m = as_tensor(mean, like).to(dt)
        s = as_tensor(std, like).to(dt)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, dtype=dt, device=like.device, generator=_gen(like.device, generator))
        return m + s * z
    dev = device or default_device()
    z = torch.randn(int_list(shape if shape is not None else [1]), dtype=dt, device=dev,
                    generator=_gen(dev, generator))
    return mean + std * z


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *, device=None,
            generator=None):
    """Uniform in ``[min, max)``; a nonzero ``seed`` draws from a generator
    of its own seeded with it."""
    dev = device or default_device()
    if seed and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    out = torch.empty(int_list(shape), dtype=_d(dtype), device=dev)
    return out.uniform_(min, max, generator=_gen(dev, generator))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *, device=None,
            generator=None):
    if high is None:
        low, high = 0, low
    dev = device or default_device()
    return torch.randint(int(low), int(high), int_list(shape), dtype=_d(dtype), device=dev,
                         generator=_gen(dev, generator))


def randint_like(x, low=0, high=None, dtype=None, name=None, *, generator=None):
    x = as_tensor(x)
    return randint(low, high, list(x.shape), dtype or "int64", device=x.device,
                   generator=generator)


def randperm(n, dtype="int64", name=None, *, device=None, generator=None):
    dev = device or default_device()
    return torch.randperm(int(n), dtype=_d(dtype), device=dev, generator=_gen(dev, generator))


def rand_like(x, dtype=None, name=None, *, generator=None):
    x = as_tensor(x)
    return uniform(list(x.shape), dtype or x.dtype, min=0.0, max=1.0, device=x.device,
                   generator=generator)


def randn_like(x, dtype=None, name=None, *, generator=None):
    x = as_tensor(x)
    return randn(list(x.shape), dtype or x.dtype, device=x.device, generator=generator)


def bernoulli(x, name=None, *, generator=None):
    """0/1 draws with probability ``x``, in ``x``'s dtype, no gradient."""
    x = as_tensor(x)
    return torch.bernoulli(x.detach(), generator=_gen(x.device, generator))


def multinomial(x, num_samples=1, replacement=False, name=None, *, generator=None):
    """``num_samples`` category indices a row of the weights ``x``, int32."""
    x = as_tensor(x)
    out = torch.multinomial(x.detach().float(), int(num_samples), bool(replacement),
                            generator=_gen(x.device, generator))
    return narrow(out)


def poisson(x, name=None, *, generator=None):
    x = as_tensor(x)
    return torch.poisson(x.detach(), generator=_gen(x.device, generator))


def binomial(count, prob, name=None, *, generator=None):
    """Binomial(``count``, ``prob``) draws, int32 (the reference's int64
    narrowed)."""
    count, prob = as_tensor(count), as_tensor(prob, like=as_tensor(count))
    g = _gen(count.device, generator)
    out = torch.binomial(count.detach().float(), prob.detach().float(), generator=g)
    return out.to(torch.int32)


def standard_gamma(x, name=None, *, generator=None):
    """Gamma(``x``, 1) draws."""
    x = as_tensor(x)
    return torch._standard_gamma(x.detach(), generator=_gen(x.device, generator))


def log_normal(mean=1.0, std=2.0, shape=None, name=None, *, device=None, generator=None):
    return torch.exp(normal(mean, std, shape, device=device, generator=generator))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    """The reference computes it on the host with numpy's
    ``histogramdd``, and so does the port: ``(hist, [edges])`` in f32 on
    ``x``'s device."""
    x = as_tensor(x)
    a = x.detach().cpu().numpy()
    w = None if weights is None else as_tensor(weights).detach().cpu().numpy()
    if isinstance(bins, (list, tuple)) and len(bins) and not np.isscalar(bins[0]):
        bins = [as_tensor(b).detach().cpu().numpy() for b in bins]
    if ranges is not None and np.isscalar(ranges[0]):     # Paddle's flat [lo0, hi0, ...]
        ranges = [ranges[k:k + 2] for k in range(0, len(ranges), 2)]
    hist, edges = np.histogramdd(a, bins=bins, range=ranges, density=density, weights=w)
    return (from_numpy(hist.astype(np.float32)).to(x.device),
            [from_numpy(e.astype(np.float32)).to(x.device) for e in edges])


def exponential_(x, lam=1.0, name=None, *, generator=None):
    """Exponential(``lam``) draws written into ``x``."""
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device, generator))


def geometric_(x, probs=0.5, name=None, *, generator=None):
    """The trial of the first success (1, 2, ...) with probability
    ``probs``, written into ``x``."""
    with torch.no_grad():
        return x.geometric_(probs, generator=_gen(x.device, generator))


def normal_(x, mean=0.0, std=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device, generator))


def log_normal_(x, mean=1.0, std=2.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.log_normal_(mean, std, generator=_gen(x.device, generator))


def cauchy_(x, loc=0.0, scale=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale, generator=_gen(x.device, generator))


def bernoulli_(x, p=0.5, name=None, *, generator=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(x.device, generator))

