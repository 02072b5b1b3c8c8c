"""Parameters kept as shards, and the optimizer step over them: the
machinery of the ZeRO stages (``fleet.sharding``, ``parallelize``) and of
the partitioning tier (``partitioning``).

A sharded tensor carries a :class:`ShardInfo`: its full shape, the dim
cut over a group of ``k`` ranks (the shard axis, ``fsdp`` or ``sharding``:
gathered where it runs), the dim cut over the tensor axis (``tensor`` /
``mp``: resident, each rank computing on its columns or rows), this rank's
slice, and the replica group: the ranks holding the same slice whose
gradients are summed (the data ranks, and the tensor ranks where the
gradient of a parameter replicated across them is partial: the norms
under sequence parallelism, K and V when the tensor size does not divide
their heads). Each parameter stays a tensor of its own; nothing is
flattened across parameters at rest.

- **Stage 3** (``at_rest``): the parameter's data is its slice.
  :func:`install_gathers` wraps each block of the model (the children of
  its ``LayerList``s, as ``distributed.recompute`` finds them; the rest of
  the parameters gather at the model's own forward) so that its sliced
  parameters are all-gathered, one collective a dtype, just before the
  block runs, and their gradients reduce-scattered to the slices in the
  backward (then summed over the replica group and divided by the number
  of data ranks). Under a recompute policy the gather sits inside the
  recomputed function: the backward gathers again, and no full parameter
  outlives the forward. Without one, autograd keeps the gathered
  parameters that the backward reads until it has run.
- **Stages 1 and 2**: the parameter stays whole; the optimizer state
  covers its slice. Stage 1 all-reduces the gradient, stage 2
  reduce-scatters it to the slice; after the update the slices are
  all-gathered into the parameter. Beside a tensor axis the parameter is
  its tensor slice and the state a slice of that (:func:`plan_specs`); a
  gradient partial over tensor is summed over data and tensor
  (``sum_group``).
- A Mixture-of-Experts layer's expert weights cut over a data axis
  (``dp``: :func:`plan_specs`) are resident slices, as the tensor axis's:
  each rank runs its experts on the rows the all-to-all brings it
  (``fleet.moe``), so a slice's gradient is complete after the exchange's
  backward (``ShardInfo.expert``): it is summed over the other data axes
  only and divided like the data mean. Cut over the tensor axis (or a
  legacy mesh's ``ep``) they are tensor slices.
- A parameter without a divisible dim stays whole. Its gradient, and
  stage 1's, is all-reduced over the data ranks by one
  ``fused_allreduce`` a dtype after the backward, not overlapped with it
  (``DataParallel``'s buckets are); at one data rank there is nothing to
  sum and no collective runs.

:class:`ShardedUpdate` is one optimizer step: reduce, clip (the global
norm sums the squared norms of the slices over the groups that cut them,
and those of the parameters that no axis cuts once, before the square
root), update every slice in place with the fused kernel
(``optimizer.fused_step``: one launch for up to 128 tensors), then gather
stages 1 and 2. A two-byte float
gradient is reduced in f32 over gloo, whose reductions run on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import collective as _c

__all__ = ["ShardInfo", "info_of", "place", "gather_full", "install_gathers",
           "ShardedUpdate", "plan_specs"]


@dataclasses.dataclass(eq=False)
class ShardInfo:
    full_shape: tuple
    dim: int | None            # the dim cut over ``group`` (None: not cut there)
    group: object              # the shard axis's group (k ranks), gathered where it runs
    replica_group: object      # the ranks holding this slice whose gradients are summed
    at_rest: bool              # the tensor's data is the slice (stage 3)
    tdim: int | None = None    # the dim cut over ``tgroup`` (the tensor axis), resident
    tgroup: object = None
    copies: object = None      # ranks holding this slice whose gradients are not summed
    norm_group: object = None  # the ranks whose slices make the whole parameter
    sum_group: object = None   # stage 1: the ranks whose whole gradients are summed, when
                               # not the data ranks (a gradient partial over the tensor axis)
    expert: bool = False       # an expert slice over a data axis (``tgroup``): its gradient
                               # complete here, summed over ``replica_group`` only

    @property
    def k(self) -> int:
        return self.group.nranks if self.dim is not None else 1

    @property
    def tk(self) -> int:
        return self.tgroup.nranks if self.tdim is not None else 1

    @property
    def local_shape(self) -> tuple:
        """The shape of this rank's tensor slice: what the shard axis
        gathers, and what the rank computes on."""
        return tuple(n // self.tk if d == self.tdim else n for d, n in enumerate(self.full_shape))

    @property
    def index(self) -> tuple:
        """This rank's slice of :attr:`local_shape` along the shard axis."""
        idx = [slice(0, n) for n in self.local_shape]
        if self.dim is not None:
            n = self.local_shape[self.dim] // self.k
            c = self.group.rank
            idx[self.dim] = slice(c * n, (c + 1) * n)
        return tuple(idx)

    @property
    def held_index(self) -> tuple:
        """The part of the full tensor this rank holds: its tensor slice,
        and at rest its slice of that along the shard axis."""
        idx = list(self.index if self.at_rest else [slice(0, n) for n in self.local_shape])
        if self.tdim is not None:
            n = self.local_shape[self.tdim]
            off = self.tgroup.rank * n
            s = idx[self.tdim]
            idx[self.tdim] = slice(off + s.start, off + s.stop)
        return tuple(idx)

    @property
    def shard_shape(self) -> tuple:
        return tuple(s.stop - s.start for s in self.index)

    @property
    def sliced(self) -> bool:
        return self.dim is not None or self.tdim is not None

    @property
    def cut_group(self):
        """The group over whose slices the parameter's norm is summed."""
        if self.norm_group is not None:
            return self.norm_group
        return self.group if self.dim is not None else None

    @property
    def writer(self) -> bool:
        """Whether this rank writes the slice to a checkpoint (the first
        of the ranks that hold it)."""
        return all(g is None or g.rank == 0 for g in (self.replica_group, self.copies))


def register(t, info) -> None:
    t.dist_shard = info


def info_of(t) -> ShardInfo | None:
    """The :class:`ShardInfo` that ``t`` carries (``Layer.state_dict()``
    carries it onto its detached copies), None when it has none."""
    return getattr(t, "dist_shard", None)


def divisible_dim(shape, k, largest=False):
    """The dim to cut over ``k`` ranks: the first divisible one, or the
    largest (the first of equals); None when none divides."""
    dims = range(len(shape))
    if largest:
        dims = sorted(dims, key=lambda d: -shape[d])
    for d in dims:
        if k > 1 and shape[d] % k == 0:
            return d
    return None


def place(p, info: ShardInfo) -> None:
    """Record ``info`` on parameter ``p`` (of the full shape); keep only its
    tensor slice, and at rest only its slice of that."""
    if info.tdim is not None or (info.at_rest and info.dim is not None):
        with torch.no_grad():
            p.data = p.data[info.held_index].clone()
    register(p, info)


def _reduce_dtype(dtype, group):
    if dtype in (torch.bfloat16, torch.float16) and group is not None \
            and group.backend == "gloo":
        return torch.float32
    return dtype


def _to_rows(full, info):
    """``full`` as [k, numel / k], row r the slice of rank r."""
    d, k = info.dim, info.k
    shape = full.shape
    return full.reshape(shape[:d] + (k, shape[d] // k) + shape[d + 1:]).movedim(d, 0) \
        .reshape(k, -1)


def _from_rows(rows, info):
    """The full tensor from [k, numel / k] rows of slices."""
    d, k = info.dim, info.k
    shard = info.shard_shape
    return rows.reshape((k,) + shard).movedim(0, d).reshape(info.local_shape)


def gather_many(shards, infos):
    """The full tensors of ``shards`` (all cut over one group), one
    all-gather a dtype."""
    group = infos[0].group
    out = [None] * len(shards)
    by_dtype: dict = {}
    for i, s in enumerate(shards):
        by_dtype.setdefault(s.dtype, []).append(i)
    for dtype in sorted(by_dtype, key=str):
        idx = by_dtype[dtype]
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        rows = torch.empty((group.nranks, flat.numel()), dtype=dtype, device=flat.device)
        _c.all_gather(rows, flat, group=group)
        off = 0
        for i in idx:
            n = shards[i].numel()
            out[i] = _from_rows(rows[:, off:off + n], infos[i])
            off += n
    return out


def reduce_many(fulls, infos, divisor):
    """Each full gradient's slice summed over the shard group (one
    reduce-scatter a dtype), then over the replica group, then divided by
    ``divisor``: the mean over the data ranks, in the gradients' dtypes."""
    group, replicas = infos[0].group, infos[0].replica_group
    out = [None] * len(fulls)
    by_dtype: dict = {}
    for i, g in enumerate(fulls):
        by_dtype.setdefault(g.dtype, []).append(i)
    for dtype in sorted(by_dtype, key=str):
        idx = by_dtype[dtype]
        rdt = _reduce_dtype(dtype, group)
        rows = torch.cat([_to_rows(fulls[i].to(rdt), infos[i]) for i in idx], dim=1)
        flat = torch.empty(rows.shape[1], dtype=rdt, device=rows.device)
        _c.reduce_scatter(flat, rows.reshape(-1), group=group)
        if replicas is not None and replicas.nranks > 1:
            _c.all_reduce(flat, group=replicas)
        flat = flat / divisor
        off = 0
        for i in idx:
            n = fulls[i].numel() // infos[i].k
            out[i] = flat[off:off + n].reshape(infos[i].shard_shape).to(dtype)
            off += n
    return out


def gather_full(t, info=None):
    """The full tensor of shard ``t`` (``t`` itself when whole): gathered
    over the shard axis, then over the tensor axis."""
    info = info or info_of(t)
    if info is None:
        return t
    if info.dim is not None and info.at_rest:
        t = gather_many([t.detach()], [info])[0]
    if info.tdim is not None:
        from .tensor_parallel import gather_dim

        t = gather_dim(t.detach(), info.tdim, info.tgroup)
    return t


class _Block:
    """The sliced parameters one block gathers: ``slots`` of (module,
    attribute name, parameter)."""

    def __init__(self, slots, divisor):
        self.slots = slots
        self.divisor = divisor
        self.infos = [info_of(p) for _, _, p in slots]

    def gather(self, shards):
        out = [None] * len(shards)
        for idx in self._by_group():
            got = gather_many([shards[i] for i in idx], [self.infos[i] for i in idx])
            for i, g in zip(idx, got):
                out[i] = g
        return out

    def reduce(self, grads):
        out = [None] * len(grads)
        for idx in self._by_group():
            fulls = [torch.zeros(self.infos[i].local_shape, dtype=self.slots[i][2].dtype,
                                 device=self.slots[i][2].device)
                     if grads[i] is None else grads[i] for i in idx]
            got = reduce_many(fulls, [self.infos[i] for i in idx], self.divisor)
            for i, g in zip(idx, got):
                out[i] = g
        return out

    def _by_group(self):
        groups: dict = {}
        for i, info in enumerate(self.infos):
            groups.setdefault((info.group.id, id(info.replica_group)), []).append(i)
        return list(groups.values())


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, *shards):
        ctx.block = block
        return tuple(block.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.block.reduce(grads))


def _blocks_of(model):
    from .recompute import remat_targets

    return [b for b in remat_targets(model) if b is not model]


def install_gathers(model, divisor: int) -> int:
    """Wrap the forward of each block of ``model`` (and of ``model``
    itself, for the sliced parameters outside every block) so that its
    sliced parameters are whole while it runs (see the module docstring);
    returns the number of blocks that gather."""
    claimed: set = set()
    wrapped = 0
    for block in _blocks_of(model) + [model]:
        slots = []
        for mod in block.modules():
            for name, p in mod._parameters.items():
                info = info_of(p) if p is not None else None
                if info is None or not info.at_rest or info.dim is None or id(p) in claimed:
                    continue
                claimed.add(id(p))
                slots.append((mod, name, p))
        if not slots:
            continue
        _wrap(block, _Block(slots, divisor))
        wrapped += 1
    return wrapped


def _wrap(module, block):
    inner = module.forward

    def forward(*args, **kwargs):
        fulls = _Gather.apply(block, *[p for _, _, p in block.slots])
        for (mod, name, _), full in zip(block.slots, fulls):
            mod._parameters[name] = full
        try:
            return inner(*args, **kwargs)
        finally:
            for mod, name, p in block.slots:
                mod._parameters[name] = p

    module.forward = forward


class ShardedUpdate:
    """One optimizer step over the parameters of a sharded model: see the
    module docstring. ``data_group`` holds every data rank (``divisor`` of
    them); ``infos[id(p)]`` is each parameter's :class:`ShardInfo` (absent:
    whole and replicated); ``stage`` 1 all-reduces the gradients of the
    parameters that stay whole, 2 and 3 reduce-scatter them. The optimizer
    state of each parameter lives on its slice, in :attr:`states`."""

    def __init__(self, infos: dict, data_group, divisor: int, stage: int):
        self.infos = infos
        self.data_group = data_group
        self.divisor = divisor
        self.stage = stage
        self.states: dict = {}
        self.slices: dict = {}      # id(p) -> the slice of a whole parameter
        self._layout = (None, None)
        self.last_clip_scale = None  # the global-norm clip's last scale

    def _sliced(self, p) -> bool:
        info = self.infos.get(id(p))
        return info is not None and info.dim is not None

    def _slice(self, p):
        info = self.infos.get(id(p))
        if info is None or info.dim is None or info.at_rest:
            return p.detach()
        s = self.slices.get(id(p))
        if s is None:
            s = p.detach()[info.index].contiguous().clone()
            self.slices[id(p)] = s
        return s

    def state_of(self, cls, p) -> dict:
        st = self.states.get(id(p))
        if st is None:
            st = cls.init_state(self._slice(p))
            info = self.infos.get(id(p))
            if info is not None and info.sliced:
                for v in st.values():
                    if torch.is_tensor(v):
                        register(v, dataclasses.replace(info, at_rest=True))
            self.states[id(p)] = st
        return st

    def _reduce(self, params, grads):
        """Each gradient as the update reads it: the mean over the data
        ranks, of the slice where the state is sliced."""
        out = list(grads)
        whole, scatter = {}, {}
        for i, p in enumerate(params):
            info = self.infos.get(id(p))
            if info is not None and info.at_rest and info.dim is not None:
                continue            # reduced by the gather's backward
            if info is None:
                whole.setdefault(id(self.data_group), (self.data_group, []))[1].append(i)
            elif info.expert:
                whole.setdefault(id(info.replica_group), (info.replica_group, []))[1].append(i)
            elif info.dim is None or self.stage == 1:
                # summed whole over the data ranks (and tensor where partial): at stage 1
                # the sum group, else the slice's replicas
                group = (info.sum_group or (info.replica_group if info.dim is None else None)
                         or self.data_group)
                whole.setdefault(id(group), (group, []))[1].append(i)
            else:
                scatter.setdefault((info.group.id, id(info.replica_group)), []).append(i)
        for group, idx in whole.values():
            dtypes = [grads[i].dtype for i in idx]
            summed = [grads[i] for i in idx]
            if group is not None and group.nranks > 1:     # one rank: nothing to sum
                summed = _c.fused_allreduce(
                    [g.to(_reduce_dtype(d, group)) for g, d in zip(summed, dtypes)],
                    group=group)
            for i, s, d in zip(idx, summed, dtypes):
                g = (s if self.divisor == 1 else s / self.divisor).to(d)
                out[i] = g[self.infos[id(params[i])].index].contiguous() \
                    if self._sliced(params[i]) else g
        for idx in scatter.values():
            got = reduce_many([grads[i] for i in idx],
                              [self.infos[id(params[i])] for i in idx], self.divisor)
            for i, g in zip(idx, got):
                out[i] = g
        return out

    def _clip(self, desc, params, grads, need_clip):
        """``(grads, scales)`` under the clip ``desc``, every norm that of
        the whole parameter's gradient."""
        from ..nn.clip import scale_grad

        none = [None] * len(grads)
        if desc is None:
            return grads, none
        if desc[0] == "value":
            return [torch.clamp(g, desc[1], desc[2]) for g in grads], none
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square() for g in grads]
        by_group: dict = {}
        for i, p in enumerate(params):
            info = self.infos.get(id(p))
            group = info.cut_group if info is not None else None
            if group is not None and group.nranks > 1:
                by_group.setdefault(group.id, (group, []))[1].append(i)
        for group, idx in by_group.values():
            vec = torch.stack([sq[i] for i in idx])
            _c.all_reduce(vec, group=group)
            for j, i in enumerate(idx):
                sq[i] = vec[j]
        if desc[0] == "global_norm":
            chosen = [s for s, nc in zip(sq, need_clip) if nc]
            if not chosen:
                return grads, none
            total = chosen[0]
            for s in chosen[1:]:
                total = total + s
            scale = desc[1] / torch.clamp_min(torch.sqrt(total), desc[1])
            self.last_clip_scale = scale
            return grads, [scale if nc else None for nc in need_clip]
        if desc[0] == "norm":
            return [scale_grad(g, torch.clamp_max(desc[1] / torch.clamp_min(torch.sqrt(s), 1e-12),
                                                  1.0)) for g, s in zip(grads, sq)], none
        raise NotImplementedError(f"unknown clip descriptor {desc!r}")

    def sentinel_parts(self, params) -> tuple:
        """What a sharded step's numerics sentinels read beside the reduced
        gradients: ``(parts, fold)``. ``parts`` is this rank's part of each
        parameter before the update, the part :meth:`_reduce` leaves of its
        gradient; ``fold`` is ``profiler.numerics.sentinel_tree``'s
        ``reduce``: it sums the per-tensor statistics (and takes the largest
        of the maxima) over each tensor's :attr:`ShardInfo.cut_group`, the
        groups the clip's norm is summed over, so every rank reads the whole
        tensors' values."""
        groups = {}
        for n, p in params.items():
            info = self.infos.get(id(p))
            group = info.cut_group if info is not None else None
            if group is not None and group.nranks > 1:
                groups[n] = group

        def fold(names, sums, maxes):
            by_group: dict = {}
            for j, n in enumerate(names):
                g = groups.get(n)
                if g is not None:
                    by_group.setdefault(g.id, (g, []))[1].append(j)
            for group, cols in by_group.values():
                idx = torch.tensor(cols, device=sums.device)
                part = sums[:, idx]
                _c.all_reduce(part, group=group)
                sums[:, idx] = part
                if maxes is not None:
                    part = maxes[:, idx]
                    _c.all_reduce(part, op=_c.ReduceOp.MAX, group=group)
                    maxes[:, idx] = part
            return sums, maxes

        return [self._slice(p) for p in params.values()], fold

    def step(self, cls, params, grads, lrs, hypers, need_clip, clip_desc, t: int,
             reduced: bool = False) -> None:
        """Reduce (unless ``reduced``: the gradients are :meth:`_reduce`'s
        already), clip, update and (stages 1 and 2) gather; ``lrs``,
        ``hypers`` and ``need_clip`` are per parameter."""
        from ..ops import fused_optimizer as fo
        from ..optimizer import fused_step

        if not reduced:
            grads = self._reduce(params, grads)
        grads, scales = self._clip(clip_desc, params, grads, need_clip)
        entries = [fo.Entry(self._slice(p), g, self.state_of(cls, p), lr, hyper, scale)
                   for p, g, lr, hyper, scale in zip(params, grads, lrs, hypers, scales)]
        sig = tuple(map(fo.signature, entries))
        if self._layout[0] != sig:
            self._layout = (sig, fused_step.layout_of(cls, entries))
        with torch.no_grad():
            fused_step.apply_update(cls, entries, t, self._layout[1])
            by_group: dict = {}
            for p in params:
                if id(p) in self.slices:
                    by_group.setdefault(self.infos[id(p)].group.id, []).append(p)
            for ps in by_group.values():
                fulls = gather_many([self.slices[id(p)] for p in ps],
                                    [self.infos[id(p)] for p in ps])
                for p, f in zip(ps, fulls):
                    p.data.copy_(f)


def plan_specs(model, mesh, specs: dict, data_axes: tuple, tensor_axis: str, *, stage: int = 3,
               partial: set | None = None) -> ShardedUpdate:
    """Cut every parameter of ``model`` (a Layer, or a list of them: a
    pipeline stage's pieces) by its placement (``specs[id(p)]``, one entry
    a dim): the dim on ``tensor_axis`` stays resident (each rank computes on
    its slice through the collectives that
    :mod:`~paddle_tpu_torch.distributed.tensor_parallel` installs in the
    model, unless ``partial`` says they are installed already and which
    parameters' gradients they leave partial), the dim on any other axis is
    kept at rest as a slice and gathered where its block runs. At ``stage``
    1 or 2 a parameter that no such axis cuts keeps its optimizer state on
    its slice of the ``sharding`` axis (the first dim of its tensor slice
    that the axis divides): stage 1 all-reduces its gradient, stage 2
    reduce-scatters it. Returns the model's :class:`ShardedUpdate` over the
    data ranks (``data_axes``). A context axis across processes not among
    ``data_axes`` (``sep``: the gradients partial over it) is summed over
    with the data axes and left out of the divisor.

    A Mixture-of-Experts layer's expert weights whose dim 0 (the expert
    axis) alone is on a data axis stay resident slices there
    (``ShardInfo.expert``), reached by the all-to-all; on ``tensor_axis``
    they are its slices; cut on another dim, or on none, they are any
    parameter's (gathered where their block runs, their state on the
    ``sharding`` slice at stages 1 and 2) and every expert runs here. Each layer gets its
    :class:`~paddle_tpu_torch.distributed.fleet.moe.ExpertPlan`: routing
    over the data ranks, its experts' axis and the load-balance loss's
    backward factor (the data ranks over the tensor ranks that sum the
    router's gradient)."""
    from . import tensor_parallel
    from .fleet.moe import MoELayer
    from .mesh import context_axes

    pieces = list(model) if isinstance(model, (list, tuple)) else [model]
    params = [p for piece in pieces for p in piece.parameters()]
    moes = [m for piece in pieces for m in piece.modules() if isinstance(m, MoELayer)]
    experts = {id(w) for m in moes for w in (m.w_gate, m.w_up, m.w_down)}
    tsize = mesh.get_dim_size(tensor_axis) if tensor_axis in mesh.dim_names else 1
    tgroup = mesh.get_group(tensor_axis) if tsize > 1 else None
    installed = partial is not None
    partial = set(partial or ())
    if tgroup is not None:
        if not installed:
            for piece in pieces:
                partial |= tensor_parallel.install(piece, tgroup, specs, tensor_axis)
        partial |= {id(p) for p in params if getattr(p, "sequence_parallel", False)}
    data_axes = tuple(a for a in data_axes if a in mesh.dim_names)
    divisor = int(np.prod([mesh.get_dim_size(a) for a in data_axes])) if data_axes else 1
    ctx = tuple(a for a in context_axes(mesh) if a not in data_axes)
    if moes and (ctx or installed):
        raise NotImplementedError(
            "a Mixture-of-Experts layer beside " + ("a context axis across processes" if ctx
                                                    else "the pipe axis")
            + ": the reference's tests reach no such program, and the port routes only over "
            "the data ranks of one program")

    def ordered(axes):          # a group's key in the mesh's order (made up front)
        return tuple(a for a in mesh.dim_names if a in axes)

    state_group = (mesh.get_group("sharding") if stage in (1, 2) and "sharding" in data_axes
                   and mesh.get_dim_size("sharding") > 1 else None)
    infos = {}
    for p in params:
        if id(p) in infos:
            continue
        held = info_of(p)          # cut already: a tensor-parallel layer's own slice
        dim, shard_axes, at_rest = None, (), True
        tdim = held.tdim if held is not None else None
        for d, entry in enumerate(specs.get(id(p), ()) if held is None else ()):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            if tensor_axis in axes:
                if len(axes) > 1:
                    raise NotImplementedError(f"dim {d} cut over {axes}: the tensor axis shares "
                                              "a dim with no other axis")
                tdim = d
            elif dim is not None:
                raise NotImplementedError(f"dims {dim} and {d} both gathered: a parameter is "
                                          "cut over one gathered dim")
            else:
                dim, shard_axes = d, axes
        full = held.full_shape if held is not None else tuple(p.shape)
        if id(p) in experts and dim == 0 and tdim is None and len(shard_axes) == 1 \
                and shard_axes[0] in data_axes:
            axis = shard_axes[0]
            rest = ordered(tuple(a for a in data_axes if a != axis) + ctx)
            info = ShardInfo(full, None, None, mesh.get_group(rest) if rest else None,
                             at_rest=True, tdim=0, tgroup=mesh.get_group(axis),
                             copies=tgroup, norm_group=mesh.get_group(axis), expert=True)
            place(p, info)
            infos[id(p)] = info
            continue
        if dim is None and state_group is not None:
            local = tuple(n // tsize if d == tdim else n for d, n in enumerate(full))
            dim = divisible_dim(local, state_group.nranks)
            if dim is not None:
                shard_axes, at_rest = ("sharding",), False
        part = id(p) in partial
        if held is not None and dim is None:
            infos[id(p)] = held
            continue
        if dim is None and tdim is None and not part:
            continue
        rest = ordered(tuple(a for a in data_axes if a not in shard_axes) + ctx
                       + ((tensor_axis,) if part else ()))
        cut = shard_axes + ((tensor_axis,) if tdim is not None else ())
        info = ShardInfo(full, dim, mesh.get_group(shard_axes) if dim is not None else None,
                         mesh.get_group(rest) if rest else None, at_rest=at_rest, tdim=tdim,
                         tgroup=tgroup if tdim is not None else None,
                         copies=tgroup if tdim is None and not part else None,
                         norm_group=mesh.get_group(cut) if cut else None,
                         sum_group=(mesh.get_group(ordered(data_axes + ctx + (tensor_axis,)))
                                    if part and not at_rest else None))
        if held is not None:
            register(p, info)
        else:
            place(p, info)
        infos[id(p)] = info
    for piece in pieces:
        install_gathers(piece, divisor)
    _plan_experts(moes, infos, partial, mesh.get_group(ordered(data_axes)) if divisor > 1
                  else None, divisor, tsize)
    return ShardedUpdate(infos, mesh.get_group(ordered(data_axes + ctx)), divisor, stage)


def _plan_experts(moes, infos, partial, route, divisor: int, tsize: int) -> None:
    """Each MoE layer's ``ExpertPlan`` (see :func:`plan_specs`)."""
    from .fleet._ep_a2a import ExpertLink
    from .fleet.moe import ExpertPlan

    for m in moes:
        info = infos.get(id(m.w_gate))
        if info is not None and info.expert:
            plan = ExpertPlan(route, "data", ExpertLink(info.tgroup, route))
        elif info is not None and info.tdim == 0:
            plan = ExpertPlan(route, "tensor")
        elif route is not None:
            plan = ExpertPlan(route, "whole")
        else:
            continue                    # one data rank, every expert here: one program's layer
        plan.aux_scale = divisor / (tsize if id(m.gate.gate.weight) in partial else 1)
        m._ep = plan
