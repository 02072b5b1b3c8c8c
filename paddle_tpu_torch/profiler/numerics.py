"""Numerics sentinels (counterpart of ``paddle_tpu/profiler/numerics.py``).

:func:`sentinel_tree` reads a step's loss, gradients and pre-update
parameters (``{name: tensor}``) and gives the reference's keys, as torch
tensors on the step's device:

- ``grad_norm``          global L2 norm of every gradient, f32
- ``loss_nonfinite`` / ``grad_nonfinite`` / ``param_nonfinite``
                         NaN and Inf element counts
- ``group_nonfinite_grad`` / ``group_nonfinite_param``
                         the same counts per tensor group (a bounded
                         name prefix, :func:`group_of`), which lets the
                         watchdog name the poisoned group
- ``digest``             the wrapping u32 sum of every gradient's f32 bit
                         patterns: exact, order-independent, equal across
                         ranks iff the gradients' bits are equal
- mode ``trace`` adds per-group ``group_absmax`` / ``group_absmean`` of
                         the gradients

On the card one kernel (``ops/sentinels.py``, ``csrc/sentinels.cu``) reads
every gradient and every parameter once, the bytes of one read each; no
f32 copy is made. ``params`` are the PRE-update parameters: the caller
takes the sentinels on the stream before the update writes them, so a
poisoned input names its own group, where a NaN loss back-propagates NaN
into every gradient group at once. The sentinels are pure reads: a step's
outputs are the same bits with them on and off.

Every value lives in one packed f64 tensor (f64 holds an f32, a u32 and a
count exactly), so :func:`host_sentinels` reads the whole tree in one
device-to-host copy, one synchronisation, as the reference's one
``device_get``. :func:`publish` folds the fetched values into the
registry: ``train.loss`` / ``train.grad_norm`` gauges and histograms, the
``train.nonfinite{tensor_group,tensor}`` counters;
``distributed/resilience/watchdog.py`` runs the spike and NaN detectors
over them.

Env knobs:
- PADDLE_NUMERICS            sentinel mode off/summary/trace
                             (default: summary, the plane is on)
- PADDLE_SPIKE_SIGMA         the watchdog's robust z-score threshold
"""

from __future__ import annotations

import os
from bisect import bisect_left as _bisect_left

import torch

__all__ = ["MODES", "DEFAULT_MODE", "resolve_mode", "group_of",
           "group_names", "sentinel_tree", "host_sentinels", "publish",
           "nonfinite_groups"]

MODES = ("off", "summary", "trace")
DEFAULT_MODE = "summary"


def resolve_mode(ctor: str | None = None) -> str:
    """Sentinel mode: ctor kwarg > ``PADDLE_NUMERICS`` env > default
    (``summary``, default-on)."""
    mode = ctor if ctor is not None else (
        os.environ.get("PADDLE_NUMERICS") or DEFAULT_MODE)
    mode = str(mode).strip().lower()
    if mode in ("0", "false", "none"):
        mode = "off"
    elif mode in ("1", "true", "on"):
        mode = "summary"
    if mode not in MODES:
        raise ValueError(
            f"numerics mode {mode!r} not one of {MODES} "
            "(PADDLE_NUMERICS or the TrainStep numerics= kwarg)")
    return mode


def group_of(name: str) -> str:
    """Tensor group of a dotted parameter name: the first two path segments
    (``blocks.0.fc1.weight`` -> ``blocks.0``), one for shallow names
    (``fc1.weight`` -> ``fc1``). Bounded cardinality: one a repeated
    block, not one a tensor."""
    parts = str(name).split(".")
    return ".".join(parts[:2]) if len(parts) > 2 else parts[0]


def group_names(names) -> dict:
    """Deterministic ``{group: [param names]}`` (both levels sorted)."""
    out: dict[str, list] = {}
    for n in sorted(names):
        out.setdefault(group_of(n), []).append(n)
    return out


_GIDX: dict = {}


def _group_index(sizes: tuple, device) -> torch.Tensor:
    """Each tensor's group index (groups of ``sizes`` tensors in order), on
    ``device``; cached, so a step sends nothing to the card for it."""
    key = (sizes, str(device))
    idx = _GIDX.get(key)
    if idx is None:
        idx = torch.repeat_interleave(torch.arange(len(sizes)), torch.tensor(sizes)).to(device)
        _GIDX[key] = idx
    return idx


def sentinel_tree(loss, grads: dict, params: dict, mode: str, reduce=None) -> dict:
    """The sentinel summary of one step, as tensors on the step's device;
    one :func:`~paddle_tpu_torch.ops.sentinels.tensor_stats` call over the
    gradients and the pre-update parameters, then a few small ops over its
    per-tensor results. The values are views of one packed f64 tensor
    (``"_packed"``), which :func:`host_sentinels` copies once.

    Under a sharded step ``grads`` and ``params`` hold this rank's part of
    each tensor, and ``reduce(names, sums, maxes) -> (sums, maxes)`` folds
    the per-tensor statistics over the ranks whose parts make the whole
    tensor: it sums each column of ``sums`` (f64 ``[k, T]``, one column a
    tensor of ``names``: the sum of squares, the digest, the gradient's and
    the parameter's counts, in ``trace`` mode the absolute sum and the
    element count) and takes the largest of ``maxes`` (``trace`` mode's
    absolute maxima, else None). Every value is then that of the whole
    tensors, the same on every rank."""
    from ..ops.sentinels import tensor_stats

    groups = group_names(grads.keys())
    names = [n for ns in groups.values() for n in ns]   # sorted by group, then name
    T = len(names)
    with torch.no_grad():
        sq, ints = tensor_stats([grads[n] for n in names] + [params[n] for n in names])
        dev = sq.device
        gidx = _group_index(tuple(len(ns) for ns in groups.values()), dev)
        G = len(groups)
        rows = [sq[:T].double(), ints[0, :T].double(), ints[1, :T].double(),
                ints[1, T:].double()]
        maxes = None
        if mode == "trace":
            rows.append(torch.stack([torch.linalg.vector_norm(grads[n], 1, dtype=torch.float32)
                                     for n in names]).double())
            rows.append(torch.tensor([grads[n].numel() for n in names],
                                     dtype=torch.float64).to(dev))
            maxes = torch.stack([torch.linalg.vector_norm(grads[n], float("inf"),
                                                          dtype=torch.float32)
                                 for n in names]).double()[None]
        sums = torch.stack(rows)
        if reduce is not None:
            sums, maxes = reduce(names, sums, maxes)
        per_group = torch.zeros((2, G), dtype=torch.float64, device=dev)
        per_group[0].index_add_(0, gidx, sums[2])
        per_group[1].index_add_(0, gidx, sums[3])
        # a digest under 2^32 a tensor and rank: f64 holds their sums exactly
        head = torch.stack([
            torch.sqrt(torch.sum(sums[0].float())).double(),
            (torch.sum(sums[1].long()) & 0xFFFFFFFF).double(),
            torch.sum(~torch.isfinite(loss.detach().float())).double(),
            sums[2].sum(), sums[3].sum()])
        parts = [head, per_group.reshape(-1)]
        if mode == "trace":
            ends = torch.tensor([len(ns) for ns in groups.values()]).cumsum(0).tolist()
            gmax = torch.stack([maxes[0, a:b].max() for a, b in zip([0] + ends[:-1], ends)])
            gsum = torch.zeros((2, G), dtype=torch.float64, device=dev)
            gsum[0].index_add_(0, gidx, sums[4])
            gsum[1].index_add_(0, gidx, sums[5])
            parts += [gmax, gsum[0] / gsum[1]]
        packed = torch.cat(parts)
    gnames = list(groups)
    sent = {"grad_norm": packed[0], "digest": packed[1], "loss_nonfinite": packed[2],
            "grad_nonfinite": packed[3], "param_nonfinite": packed[4],
            "group_nonfinite_grad": {g: packed[5 + i] for i, g in enumerate(gnames)},
            "group_nonfinite_param": {g: packed[5 + G + i] for i, g in enumerate(gnames)}}
    if mode == "trace":
        base = 5 + 2 * G
        sent["group_absmax"] = {g: packed[base + i] for i, g in enumerate(gnames)}
        sent["group_absmean"] = {g: packed[base + G + i] for i, g in enumerate(gnames)}
    sent["_packed"] = packed
    return sent


_INT_KEYS = ("digest", "loss_nonfinite", "grad_nonfinite", "param_nonfinite",
             "group_nonfinite_grad", "group_nonfinite_param")


def host_sentinels(sent: dict) -> dict:
    """One step's sentinel tree as plain python scalars, read in ONE
    device-to-host copy (of the packed tensor; a tree without one is
    stacked first). Counts and the digest come back as ints, the rest as
    floats."""
    packed = sent.get("_packed")
    keys, leaves = [], []
    for k, v in sent.items():
        if k == "_packed":
            continue
        if isinstance(v, dict):
            keys += [(k, g) for g in v]
            leaves += list(v.values())
        else:
            keys.append((k, None))
            leaves.append(v)
    if packed is None:
        packed = torch.stack([torch.as_tensor(x).double().reshape(()) for x in leaves])
        index = list(range(len(leaves)))
    else:
        index = [x.storage_offset() - packed.storage_offset() for x in leaves]
    vals = packed.cpu().tolist()
    out: dict = {}
    for (k, g), i in zip(keys, index):
        v = vals[i]
        if k in _INT_KEYS:
            v = int(v)
        if g is None:
            out[k] = v
        else:
            out.setdefault(k, {})[g] = v
    # derived total so the per-step consumers (publish and the watchdog's
    # healthy check) read ONE key instead of three
    out["nonfinite"] = ((out.get("loss_nonfinite") or 0)
                        + (out.get("grad_nonfinite") or 0)
                        + (out.get("param_nonfinite") or 0))
    return out


def nonfinite_groups(sent: dict) -> dict:
    """``{group: {"param": n, "grad": n}}`` restricted to groups with a
    nonzero NaN/Inf count: the watchdog's naming input."""
    out: dict[str, dict] = {}
    for kind, key in (("grad", "group_nonfinite_grad"),
                      ("param", "group_nonfinite_param")):
        for g, c in (sent.get(key) or {}).items():
            if c:
                out.setdefault(g, {})[kind] = int(c)
    return out


#: cached (loss gauge, loss histogram, grad-norm gauge, grad-norm
#: histogram): the every-step fold pays attribute bumps, not registry
#: lookups (telemetry.reset() zeroes the same instances)
_HANDLES: tuple | None = None


def _handles():
    global _HANDLES
    if _HANDLES is None:
        from . import telemetry as _telemetry

        _HANDLES = (_telemetry.gauge("train.loss"),
                    _telemetry.histogram("train.loss"),
                    _telemetry.gauge("train.grad_norm"),
                    _telemetry.histogram("train.grad_norm"))
    return _HANDLES


def publish(sent: dict, loss: float | None = None) -> None:
    """Host half of the plane: fold one step's fetched sentinel dict into
    the registry: gauges and histograms for loss and grad norm, a
    ``train.nonfinite{tensor_group,tensor}`` counter per offending group.
    Runs every step, so the handles are held and the histogram bodies
    inlined; the per-group loop only runs on a nonzero count."""
    h = _HANDLES
    if h is None:
        h = _handles()
    gl, hl, gg, hg = h
    if loss is not None:
        loss = float(loss)
        gl.value = loss
        hl.counts[_bisect_left(hl.bounds, loss)] += 1
        hl.total += loss
        hl.count += 1
    gn = sent.get("grad_norm")
    if gn is not None:
        gn = float(gn)
        gg.value = gn
        hg.counts[_bisect_left(hg.bounds, gn)] += 1
        hg.total += gn
        hg.count += 1
    nf = sent.get("nonfinite")
    if nf is None:
        nf = sent.get("grad_nonfinite") or sent.get("param_nonfinite")
    if nf:
        from . import telemetry as _telemetry

        for kind, key in (("grad", "group_nonfinite_grad"),
                          ("param", "group_nonfinite_param")):
            for g, c in (sent.get(key) or {}).items():
                if c:
                    _telemetry.counter(
                        "train.nonfinite",
                        tensor_group=g, tensor=kind).bump(int(c))
