"""The fused optimizer step's kernel: one multi-tensor update for SGD,
Momentum, Adam and AdamW (``csrc/fused_optimizer.cu``).

:func:`multi_tensor_update` updates a list of :class:`Entry` in place (the
parameter or its f32 master copy, the optimizer state, the low-precision
copy a master writes back), each with its own learning rate, hyperparameters
and, where the global-norm clip applies to it, the clip's scale tensor. On
CUDA tensors it launches the kernel once for every ``MAX_TENSORS`` tensors:
the per-tensor metadata (pointers, sizes, dtypes, the scalars rounded to
the parameter's dtype) is rebuilt from the tensors at every call, so a
pointer is never stale, and sent in one copy from pinned memory. Its result
is the composed per-parameter update, ``type(opt).update`` on each entry
then ``copy_`` (:func:`multi_tensor_update_plain`), bit for bit on the card;
on CPU tensors it runs that plain version.

The metadata that depends only on the tensors' sizes, dtypes and
hyperparameters is a :class:`Layout`, built by :func:`layout` and kept by
the caller while the entries' :func:`signature` stays the same.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..nn.clip import scale_grad
from ..optimizer.optimizer import as_dtype
from . import _build

__all__ = ["Entry", "Layout", "MAX_TENSORS", "kernel_op", "layout", "multi_tensor_update",
           "multi_tensor_update_plain", "signature"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 16384        # elements a block (kChunk)
MAX_TENSORS = 128    # tensors a launch (kMaxTensors)
SGD, MOMENTUM, ADAM, ADAMW = range(4)
CLIP, NESTEROV, L2 = 1, 2, 4

_F = np.float32
# the kernel's 128-byte Meta row
META = np.dtype({
    "names": ["p", "g", "s1", "s2", "low", "scale", "n", "first_chunk", "op", "dtype", "gdtype",
              "lowdtype", "flags", "lr", "decay", "l2", "b1", "omb1", "b2", "omb2", "inv_c1",
              "inv_c2", "eps", "mu"],
    "formats": ["<u8"] * 6 + ["<i8"] * 2 + ["<i4"] * 5 + ["<f4"] * 11,
    "offsets": [8 * i for i in range(8)] + [64 + 4 * i for i in range(16)],
    "itemsize": 128})
# the state slots each op reads and writes, in the kernel's s1, s2 order
SLOTS = {SGD: (), MOMENTUM: ("velocity",), ADAM: ("m", "v"), ADAMW: ("m", "v")}


@dataclasses.dataclass
class Entry:
    """One tensor of a multi-tensor update. ``param`` (a parameter, or its
    f32 master copy) and the tensors of ``state`` are updated in place;
    ``low``, where given, receives the new ``param`` in its own dtype.
    ``scale`` is the global-norm clip's 0-dim f32 scale where the clip
    applies to this gradient, else None."""
    param: torch.Tensor
    grad: torch.Tensor
    state: dict
    lr: float
    hyper: tuple
    scale: torch.Tensor | None = None
    low: torch.Tensor | None = None


def kernel_op(cls):
    """The kernel's op for optimizer class ``cls``, None when its update
    has no kernel (the class's own ``update`` decides: Lars subclasses
    Momentum with an update of its own)."""
    from ..optimizer import algorithms as alg

    ops = {alg.SGD.update.__func__: SGD, alg.Momentum.update.__func__: MOMENTUM,
           alg.Adam.update.__func__: ADAM, alg.AdamW.update.__func__: ADAMW}
    return ops.get(cls.update.__func__)


def signature(e: Entry) -> tuple:
    """What a :class:`Layout` of ``e`` depends on."""
    return (tuple(e.param.shape), e.param.dtype, tuple(e.grad.shape), e.grad.dtype,
            None if e.low is None else e.low.dtype,
            tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in e.state.items())),
            e.hyper, e.scale is not None)


@dataclasses.dataclass
class Layout:
    """The static metadata of a list of entries: one META row for each
    entry with elements (``rows``: their indices in the list), cut into
    launches of at most MAX_TENSORS rows (``launches``: ``(first row, end
    row, chunks)``)."""
    op: int
    count: int
    rows: list
    meta: np.ndarray
    launches: list


def _static(op, dt, hyper):
    """(flags, l2, b1, 1 - b1, b2, 1 - b2, eps, mu): the scalars that do
    not change from step to step, rounded to ``dt``."""
    if op in (SGD, MOMENTUM):
        l2 = hyper[0]
        mu = as_dtype(hyper[1], dt) if op == MOMENTUM else 0.0
        flags = (L2 if l2 else 0) | (NESTEROV if op == MOMENTUM and hyper[2] else 0)
        return flags, as_dtype(l2, dt), 0.0, 0.0, 0.0, 0.0, 0.0, mu
    wd, b1, b2, eps = hyper
    l2 = wd if op == ADAM else 0.0
    return ((L2 if l2 else 0), as_dtype(l2, dt), as_dtype(b1, dt), as_dtype(1 - b1, dt),
            as_dtype(b2, dt), as_dtype(1 - b2, dt), as_dtype(eps, dt), 0.0)


def layout(cls, entries) -> Layout:
    """The :class:`Layout` of ``entries`` for optimizer class ``cls``."""
    op = kernel_op(cls)
    if op is None:
        raise TypeError(f"{cls.__name__}.update has no kernel")
    rows = [i for i, e in enumerate(entries) if e.param.numel()]
    meta = np.zeros(len(rows), META)
    memo = {}
    for r, i in enumerate(rows):
        e = entries[i]
        for t in (e.param, e.grad) + (() if e.low is None else (e.low,)):
            if t.dtype not in DTYPES:
                raise TypeError(f"multi_tensor_update takes float32, bfloat16 or float16, "
                                f"got {t.dtype}")
        dt = e.param.dtype
        key = (dt, e.hyper)
        if key not in memo:
            memo[key] = _static(op, dt, e.hyper)
        flags, *scalars = memo[key]
        row = meta[r]
        row["n"] = e.param.numel()
        row["op"], row["dtype"], row["gdtype"] = op, DTYPES[dt], DTYPES[e.grad.dtype]
        row["lowdtype"] = 0 if e.low is None else DTYPES[e.low.dtype]
        row["flags"] = flags | (CLIP if e.scale is not None else 0)
        for name, value in zip(("l2", "b1", "omb1", "b2", "omb2", "eps", "mu"), scalars):
            row[name] = value
    launches = []
    for a in range(0, len(rows), MAX_TENSORS):
        b = min(a + MAX_TENSORS, len(rows))
        chunks = np.ceil(meta["n"][a:b] / CHUNK).astype(np.int64)
        meta["first_chunk"][a:b] = np.concatenate(([0], np.cumsum(chunks)[:-1]))
        launches.append((a, b, int(chunks.sum())))
    return Layout(op, len(entries), rows, meta, launches)


def _per_step(op, dt, lr, t, hyper):
    """(lr, decay, 1 / c1, 1 / c2): the scalars that move with the step,
    as the composed update computes them (``tensor / c`` on the card is a
    multiply by the f32 reciprocal of ``c``)."""
    from ..optimizer.algorithms import _bias_corrections

    lr_r = as_dtype(lr, dt)
    if op in (SGD, MOMENTUM):
        return lr_r, 1.0, 1.0, 1.0
    b1, b2 = hyper[1], hyper[2]
    c1, c2 = _bias_corrections(b1, b2, t, dt)
    decay = (as_dtype(1 - as_dtype(lr_r * as_dtype(hyper[0], dt), dt), dt) if op == ADAMW
             else 1.0)
    return lr_r, decay, float(_F(1) / _F(c1)), float(_F(1) / _F(c2))


def _fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load("fused_optimizer"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check_abi():
    abi = (ctypes.c_longlong * 3)()
    _fn("fused_optimizer_abi", [ctypes.c_void_p], None)(ctypes.addressof(abi))
    if tuple(abi) != (META.itemsize, CHUNK, MAX_TENSORS):
        raise RuntimeError(f"fused_optimizer.cu has Meta size, chunk and launch size "
                           f"{tuple(abi)}, the wrapper {(META.itemsize, CHUNK, MAX_TENSORS)}")


def _tensors(e: Entry, slots, device):
    """The tensors of ``e`` the kernel reads and writes, checked."""
    g = e.grad.contiguous()
    state = [e.state[k] for k in slots]
    for t in (e.param, g, *state) + (() if e.low is None else (e.low,)):
        if t.device != device:
            raise ValueError(f"multi_tensor_update: tensors on {t.device} and {device}")
        if t.numel() != e.param.numel():
            raise ValueError("multi_tensor_update: a gradient or state of another size than "
                             "its parameter")
    for t in (e.param, *state) + (() if e.low is None else (e.low,)):
        if not t.is_contiguous():
            raise ValueError("multi_tensor_update: parameters and state must be contiguous")
    for t in state:
        if t.dtype != e.param.dtype:
            raise TypeError(f"multi_tensor_update: state of {t.dtype} on a {e.param.dtype} "
                            "parameter")
    if e.low is not None and (e.param.dtype != torch.float32
                              or e.low.dtype == torch.float32):
        raise TypeError("multi_tensor_update: a low-precision copy needs an f32 master and a "
                        "bf16 or fp16 copy")
    if e.scale is not None and (e.scale.dtype != torch.float32 or e.scale.numel() != 1
                                or e.scale.device != device):
        raise ValueError("multi_tensor_update: the clip's scale must be one f32 on the card")
    return g, state


def multi_tensor_update(cls, entries, t: int, lay: Layout | None = None):
    """Update ``entries`` in place with optimizer class ``cls``'s update at
    step ``t`` (CUDA: the kernel, CPU: the plain version). ``lay`` is the
    :class:`Layout` of entries with the same :func:`signature`, or None to
    build it. Returns the layout used."""
    if not entries:
        return lay
    device = entries[0].param.device
    if device.type == "cpu":
        return multi_tensor_update_plain(cls, entries, t, lay)
    if device.type != "cuda":
        raise ValueError(f"multi_tensor_update runs on cuda or cpu, not {device}")
    if lay is None:
        lay = layout(cls, entries)
    if lay.count != len(entries) or lay.op != kernel_op(cls):
        raise ValueError("multi_tensor_update: the layout is of other entries")
    if not lay.rows:
        return lay
    if "fused_optimizer" not in _build._loaded:
        _check_abi()
    meta = lay.meta.copy()
    # keep: the contiguous copies of gradients stay referenced until the
    # launches are queued; their memory is reused only after them on this stream
    keep, memo = [], {}
    slots = SLOTS[lay.op]
    for r, i in enumerate(lay.rows):
        e = entries[i]
        row = meta[r]
        if row["n"] != e.param.numel() or row["dtype"] != DTYPES[e.param.dtype]:
            raise ValueError("multi_tensor_update: the layout is of other entries")
        g, state = _tensors(e, slots, device)
        keep.append(g)
        row["p"], row["g"] = e.param.data_ptr(), g.data_ptr()
        for name, s in zip(("s1", "s2"), state):
            row[name] = s.data_ptr()
        if e.low is not None:
            row["low"] = e.low.data_ptr()
        if e.scale is not None:
            row["scale"] = e.scale.data_ptr()
        key = (e.param.dtype, e.lr, e.hyper)
        if key not in memo:
            memo[key] = _per_step(lay.op, e.param.dtype, e.lr, t, e.hyper)
        row["lr"], row["decay"], row["inv_c1"], row["inv_c2"] = memo[key]
    raw = meta.view(np.uint8).reshape(-1)
    host = torch.empty(raw.size, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = raw
    dev = torch.empty(raw.size, dtype=torch.uint8, device=device)
    dev.copy_(host, non_blocking=True)
    fn = _fn("multi_tensor_update", [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p])
    stream = _build.launch_stream(device)
    for a, b, chunks in lay.launches:
        rc = fn(dev.data_ptr() + a * META.itemsize, b - a, chunks, stream)
        if rc != 0:
            raise RuntimeError(f"multi_tensor_update kernel launch failed: CUDA error {rc}")
        multi_tensor_update.launches += 1
        master = any(entries[i].low is not None for i in range(a, b))
        multi_tensor_update.by_mode["master" if master else "direct"] += 1
    return lay


#: kernel launches since the last reset (the CPU path never counts), in all
#: and by mode: "master" where an entry updates an f32 master and writes
#: its low-precision copy, else "direct"
multi_tensor_update.launches = 0
multi_tensor_update.by_mode = {"direct": 0, "master": 0}


def multi_tensor_update_plain(cls, entries, t: int, lay: Layout | None = None):
    """The plain version: per entry, the clip's ``round(g * scale)``, then
    ``cls.update(param, g.to(param.dtype), ...)`` composed of torch ops,
    copied into the parameter, the state and the low-precision copy.
    Takes and returns ``lay`` unused, as :func:`multi_tensor_update`."""
    for e in entries:
        g = e.grad if e.scale is None else scale_grad(e.grad, e.scale)
        new_p, new_state = cls.update(e.param, g.to(e.param.dtype), e.state, e.lr, t, e.hyper)
        e.param.copy_(new_p)
        for k, v in new_state.items():
            if v is not e.state[k]:
                e.state[k].copy_(v)
        if e.low is not None:
            e.low.copy_(new_p)
    return lay

