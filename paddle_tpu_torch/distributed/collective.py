"""Collective communication (counterpart of
``paddle_tpu/distributed/collective.py:42-1100``, the public surface).

Every operation runs on a :class:`Group`'s ``torch.distributed`` process
group: NCCL on the card, gloo on the CPU (or on the card where gloo is
named). Paddle's semantics hold: the tensor argument is the result, filled
in place (``all_reduce``, ``broadcast``, ``reduce_scatter``, ``scatter``,
``recv``, the output tensor of ``all_gather``), and peers and roots are
global ranks. ``sync_op=False`` returns a :class:`Task` whose ``wait()``
finishes the operation. The reference's striped host transport has no
counterpart: NCCL and gloo are the transport.

- ``ReduceOp.AVG`` is NCCL's own average on NCCL; on gloo it is a SUM
  followed by a division by the group's size, so its bits can differ from
  NCCL's in the last place.
- A group of one process outside a world of one has no process group of
  its own (``torch.distributed.new_group`` is not called for it): its
  operations leave their tensors as they are, which is their result.
- A caller outside the group raises; nothing runs on a copy.
- ``new_group``, ``split_group`` and the mesh's and topology's groups are
  collective calls: every process of the world makes them, in the same
  order, as ``torch.distributed.new_group`` requires.

:func:`stats` counts the operations and their bytes by kind since the last
:func:`reset_stats` (the port's collective counters).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import env as _env

__all__ = ["ReduceOp", "Group", "Task", "new_group", "get_group", "split_group",
           "all_reduce", "all_gather", "all_gather_object", "reduce_scatter", "all_to_all",
           "all_to_all_single", "broadcast", "broadcast_object_list", "reduce", "scatter",
           "gather", "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "barrier", "wait", "fused_allreduce", "destroy_process_group", "stats",
           "reset_stats"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT}

_stats = {"calls": {}, "bytes": {}}


def stats() -> dict:
    """``{"calls": {kind: n}, "bytes": {kind: n}}`` since the last reset."""
    return {k: dict(v) for k, v in _stats.items()}


def reset_stats() -> None:
    for v in _stats.values():
        v.clear()


def _count(kind: str, *tensors) -> None:
    _stats["calls"][kind] = _stats["calls"].get(kind, 0) + 1
    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))
    _stats["bytes"][kind] = _stats["bytes"].get(kind, 0) + nbytes


class Group:
    """``paddle.distributed`` group: global ``ranks`` (sorted), ``nranks``,
    this process's ``rank`` in it (-1 outside), its ``process_group``
    (None for a group of one outside a world of one) and ``backend``."""

    _next_id = 1

    def __init__(self, ranks, pg, backend=None, name=None, gid=None):
        self.ranks = sorted(int(r) for r in ranks)
        self.nranks = len(self.ranks)
        self.process_group = pg
        self.backend = backend or _env.backend()
        if gid is None:
            gid = Group._next_id
            Group._next_id += 1
        self.id = gid
        self.name = name or f"group_{self.id}"

    @property
    def rank(self) -> int:
        me = _env.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    @property
    def world_size(self) -> int:
        return self.nranks

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks}, backend={self.backend})"


_groups: dict = {}


def _world() -> Group:
    if not _env.is_initialized():
        raise RuntimeError("collectives need the process group: call "
                           "paddle_tpu_torch.distributed.init_parallel_env() first")
    g = _groups.get(0)
    if g is None:
        g = Group(range(dist.get_world_size()), dist.group.WORLD, name="default", gid=0)
        _groups[0] = g
    return g


def _resolve(group) -> Group:
    g = _world() if group is None else group
    if g.rank < 0:
        raise ValueError(f"rank {_env.get_rank()} is not a member of {g}: a collective "
                         "runs only on its group's members")
    return g


def _make(ranks, backend=None, timeout=None) -> Group:
    """One group over ``ranks``, made collectively (every process calls)."""
    world = _world()
    ranks = sorted(int(r) for r in ranks)
    if ranks == world.ranks and backend in (None, world.backend):
        return Group(ranks, world.process_group, world.backend)
    if len(ranks) == 1:
        return Group(ranks, None, backend or world.backend)
    kw = {}
    if timeout is not None:
        import datetime

        kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                         else datetime.timedelta(seconds=float(timeout)))
    pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg, backend or world.backend)


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over the global ``ranks`` (all when None). Every process of
    the world calls it, members or not."""
    ranks = list(range(_world().nranks)) if ranks is None else list(ranks)
    g = _make(ranks, backend, timeout)
    _groups[g.id] = g
    return g


def make_groups(rank_lists, backend=None) -> Group | None:
    """Groups over each list of ``rank_lists`` (every process makes every
    one, in order); returns the one holding this process, None if none."""
    me, mine = _env.get_rank(), None
    for ranks in rank_lists:
        g = new_group(ranks, backend)
        if me in g.ranks:
            mine = g
    return mine


def split_group(parent=None, split_sizes=None) -> Group | None:
    """Split ``parent`` (the world) into consecutive groups of
    ``split_sizes``; returns the one holding this process."""
    parent = parent if parent is not None else _world()
    if not split_sizes:
        raise ValueError("split_group: split_sizes is required")
    sizes = [int(s) for s in split_sizes]
    if any(s <= 0 for s in sizes) or sum(sizes) != parent.nranks:
        raise ValueError(f"split_group: sizes {sizes} must be positive and sum to the "
                         f"parent's {parent.nranks} ranks")
    lists, start = [], 0
    for s in sizes:
        lists.append(parent.ranks[start:start + s])
        start += s
    return make_groups(lists)


def get_group(gid: int = 0) -> Group:
    """The group of id ``gid`` (0: the world)."""
    if gid == 0:
        return _world()
    if gid not in _groups:
        raise ValueError(f"no group of id {gid}")
    return _groups[gid]


def destroy_process_group(group=None) -> None:
    """Leave ``group``, or the world (then every group is gone)."""
    if group is not None:
        if group.process_group is not None and group.process_group is not dist.group.WORLD:
            dist.destroy_process_group(group.process_group)
        _groups.pop(group.id, None)
        return
    if _env.is_initialized():
        dist.destroy_process_group()
    _groups.clear()
    _env._state.update(initialized=False, backend=None, device=None)


class Task:
    """An operation in flight: ``wait()`` finishes it (and whatever the
    port does after the transfer, such as gloo's AVG division) and returns
    True; ``is_completed()``."""

    def __init__(self, works=(), then=None):
        self._works = [w for w in works if w is not None]
        self._then = then
        self._done = False

    def wait(self, timeout=None):
        if not self._done:
            for w in self._works:
                w.wait()
            if self._then is not None:
                self._then()
            self._done = True
        return True

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)


def _finish(works, then, sync_op, result):
    """``result`` after ``works`` (and ``then``) when ``sync_op``, else the
    :class:`Task`."""
    task = Task(works if isinstance(works, (list, tuple)) else [works], then)
    if sync_op:
        task.wait()
        return result
    return task


def _divide(tensor, n):
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(n)
    else:
        tensor.floor_divide_(n)


def _op(op, g):
    """(torch op, divisor applied after the transfer or None)."""
    if op == ReduceOp.AVG:
        if g.backend == "nccl":
            return dist.ReduceOp.AVG, None
        return dist.ReduceOp.SUM, g.nranks
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    return _TORCH_OPS[op], None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place; returns it (a
    :class:`Task` when not ``sync_op``)."""
    g = _resolve(group)
    _count("all_reduce", tensor)
    if g.process_group is None:
        return _finish([], None, sync_op, tensor)
    top, div = _op(op, g)
    work = dist.all_reduce(tensor, op=top, group=g.process_group, async_op=True)
    return _finish(work, (lambda: _divide(tensor, div)) if div else None, sync_op, tensor)


def all_gather(tensor_or_tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Gather every rank's ``tensor``: into the list (appended when empty,
    filled when it holds one tensor a rank), or into an output tensor of
    the group's size times ``tensor``'s elements (ranks along dim 0: the
    concatenation ``[n * d0, ...]`` or the stack ``[n, ...]``); with no
    output, returns the stack."""
    if tensor is None:
        tensor, out = tensor_or_tensor_list, None
    else:
        out = tensor_or_tensor_list
    g = _resolve(group)
    _count("all_gather", tensor)
    src = tensor.contiguous()
    if isinstance(out, list):
        bufs = [torch.empty_like(src) for _ in range(g.nranks)]
        if g.process_group is None:
            bufs[0].copy_(src)
            work = None
        else:
            work = dist.all_gather(bufs, src, group=g.process_group, async_op=True)

        def then():
            if out:
                if len(out) != g.nranks:
                    raise ValueError(f"all_gather: the output list holds {len(out)} "
                                     f"tensors for {g.nranks} ranks")
                for o, b in zip(out, bufs):
                    o.copy_(b)
            else:
                out.extend(bufs)
        return _finish([work], then, sync_op, out)
    target = out if out is not None else torch.empty((g.nranks,) + tuple(src.shape),
                                                     dtype=src.dtype, device=src.device)
    if target.numel() != g.nranks * src.numel() or not target.is_contiguous():
        raise ValueError(f"all_gather: an output of {target.numel()} elements for "
                         f"{g.nranks} ranks of {src.numel()}")
    flat = target.view(-1)
    if g.process_group is None:
        flat.copy_(src.reshape(-1))
        return _finish([], None, sync_op, target)
    work = _gather_into(flat, src.reshape(-1), g, async_op=True)
    return _finish(work, None, sync_op, target)


def _gather_into(out, inp, g, async_op):
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, inp, group=g.process_group, async_op=async_op)


def _scatter_into(out, inp, op, g, async_op):
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    return fn(out, inp, op=op, group=g.process_group, async_op=async_op)


def all_gather_object(object_list, obj, group=None):
    """Append every rank's picklable ``obj`` to ``object_list``."""
    g = _resolve(group)
    _count("all_gather_object")
    if g.process_group is None:
        object_list.append(obj)
        return object_list
    got = [None] * g.nranks
    dist.all_gather_object(got, obj, group=g.process_group)
    object_list.extend(got)
    return object_list


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM, group=None, sync_op=True):
    """``tensor`` = this rank's part of the reduction of every rank's input
    (a list of one tensor a rank, or one tensor cut along dim 0)."""
    g = _resolve(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        if len(src) != g.nranks:
            raise ValueError(f"reduce_scatter: {len(src)} inputs for {g.nranks} ranks")
        src = torch.cat([t.reshape(-1) for t in src])
    _count("reduce_scatter", src)
    src = src.contiguous().view(-1)
    if src.numel() != g.nranks * tensor.numel():
        raise ValueError(f"reduce_scatter: an input of {src.numel()} elements for "
                         f"{g.nranks} parts of {tensor.numel()}")
    if g.process_group is None:
        tensor.copy_(src.view_as(tensor))
        return _finish([], None, sync_op, tensor)
    top, div = _op(op, g)
    out = tensor if tensor.is_contiguous() else torch.empty_like(tensor, memory_format=torch.contiguous_format)
    work = _scatter_into(out.view(-1), src, top, g, async_op=True)

    def then():
        if out is not tensor:
            tensor.copy_(out)
        if div:
            _divide(tensor, div)
    return _finish(work, then, sync_op, tensor)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Send ``in_tensor_list[j]`` to rank j; ``out_tensor_list`` receives one
    tensor from each rank (appended when empty). Over gloo, whose list
    ``alltoall`` some releases lack, the tensors travel as one flat
    :func:`all_to_all_single` (one dtype, staged as it stages)."""
    g = _resolve(group)
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"all_to_all: {len(in_tensor_list)} inputs for {g.nranks} ranks")
    _count("all_to_all", *in_tensor_list)
    ins = [t.contiguous() for t in in_tensor_list]
    fresh = not out_tensor_list
    outs = [torch.empty_like(t) for t in ins] if fresh else list(out_tensor_list)
    flat = None
    if g.process_group is None:
        outs[0].copy_(ins[0])
        work = None
    elif g.backend == "gloo":
        flat = torch.empty(sum(o.numel() for o in outs), dtype=ins[0].dtype,
                           device=ins[0].device)
        work = _single(flat, torch.cat([t.reshape(-1) for t in ins]),
                       [o.numel() for o in outs], [t.numel() for t in ins], g)
    else:
        work = dist.all_to_all(outs, ins, group=g.process_group, async_op=True)

    def then():
        if flat is not None:
            for o, part in zip(outs, flat.split([o.numel() for o in outs])):
                o.copy_(part.view(o.shape))
        if fresh:
            out_tensor_list.extend(outs)
    return _finish([work], then, sync_op, out_tensor_list)


_pinned: dict = {}


def host_buffer(cache: dict, key, shape, dtype):
    """A pinned host tensor of ``shape`` and ``dtype``, a view of the
    buffer kept in ``cache`` under ``key`` (made anew when too short): where
    a device tensor is staged for gloo, which takes no CUDA tensor. Tensors
    in flight together take different keys."""
    numel = 1
    for n in shape:
        numel *= int(n)
    buf = cache.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        buf = torch.empty(max(numel, 1), dtype=dtype, pin_memory=True)
        cache[key] = buf
    return buf[:numel].view(shape)


def _single(out, src, out_splits, in_splits, g):
    """One ``all_to_all_single`` of ``src`` into ``out`` over ``g``'s
    process group; returns its work, or None where it finished: over gloo a
    CUDA tensor or a two-byte float goes through host tensors (pinned
    buffers for a CUDA tensor), a two-byte float as f32, counted under
    ``host_stage`` each way."""
    two_byte = src.dtype in (torch.bfloat16, torch.float16)
    if g.backend != "gloo" or (src.device.type != "cuda" and not two_byte):
        return dist.all_to_all_single(out, src, output_split_sizes=out_splits,
                                      input_split_sizes=in_splits, group=g.process_group,
                                      async_op=True)
    wire = torch.float32 if two_byte else src.dtype
    if src.device.type == "cuda":
        send = host_buffer(_pinned, "a2a_send", src.shape, wire)
        send.copy_(src)
        recv = host_buffer(_pinned, "a2a_recv", out.shape, wire)
    else:
        send = src.to(wire)
        recv = torch.empty(out.shape, dtype=wire)
    _count("host_stage", send)
    dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=g.process_group)
    _count("host_stage", recv)
    out.copy_(recv)
    return None


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None, in_split_sizes=None,
                      group=None, sync_op=True):
    """``in_tensor`` cut along dim 0 (``in_split_sizes`` rows a rank, even
    when None; a split may be 0) to the ranks; ``out_tensor`` their parts in
    rank order. Over gloo, which takes neither a CUDA tensor nor a two-byte
    float here, the rows travel through host tensors (pinned buffers for a
    CUDA tensor), a two-byte float as f32, counted under ``host_stage``
    each way; such a call finishes before it returns."""
    g = _resolve(group)
    _count("all_to_all_single", in_tensor)
    if g.process_group is None:
        out_tensor.copy_(in_tensor)
        return _finish([], None, sync_op, out_tensor)
    work = _single(out_tensor, in_tensor.contiguous(), out_split_sizes, in_split_sizes, g)
    return _finish([work], None, sync_op, out_tensor)


def _member(peer: int, g: Group, what: str) -> int:
    if peer not in g.ranks:
        raise ValueError(f"{what}: rank {peer} is not a member of {g}")
    return int(peer)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` = the global rank ``src``'s, in place."""
    g = _resolve(group)
    _member(src, g, "broadcast")
    _count("broadcast", tensor)
    if g.process_group is None:
        return _finish([], None, sync_op, tensor)
    work = dist.broadcast(tensor, src=src, group=g.process_group, async_op=True)
    return _finish(work, None, sync_op, tensor)


def broadcast_object_list(object_list, src=0, group=None):
    """``object_list``'s items = the global rank ``src``'s, in place."""
    g = _resolve(group)
    _member(src, g, "broadcast_object_list")
    _count("broadcast_object_list")
    if g.process_group is not None:
        dist.broadcast_object_list(object_list, src=src, group=g.process_group)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in ``tensor`` on the global rank ``dst``."""
    g = _resolve(group)
    _member(dst, g, "reduce")
    _count("reduce", tensor)
    if g.process_group is None:
        return _finish([], None, sync_op, tensor)
    top, div = _op(op, g)
    work = dist.reduce(tensor, dst=dst, op=top, group=g.process_group, async_op=True)
    then = (lambda: _divide(tensor, div)) if div and _env.get_rank() == dst else None
    return _finish(work, then, sync_op, tensor)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` = ``tensor_list[group rank]`` of the global rank ``src``."""
    g = _resolve(group)
    _member(src, g, "scatter")
    _count("scatter", tensor)
    mine = _env.get_rank() == src
    if mine and (tensor_list is None or len(tensor_list) != g.nranks):
        raise ValueError(f"scatter: the source needs {g.nranks} tensors")
    if g.process_group is None:
        tensor.copy_(tensor_list[0])
        return _finish([], None, sync_op, tensor)
    work = dist.scatter(tensor, [t.contiguous() for t in tensor_list] if mine else None,
                        src=src, group=g.process_group, async_op=True)
    return _finish(work, None, sync_op, tensor)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` appended to ``gather_list`` on the global
    rank ``dst``."""
    g = _resolve(group)
    _member(dst, g, "gather")
    _count("gather", tensor)
    mine = _env.get_rank() == dst
    bufs = [torch.empty_like(tensor) for _ in range(g.nranks)] if mine else None
    if g.process_group is None:
        bufs[0].copy_(tensor)
        work = None
    else:
        work = dist.gather(tensor.contiguous(), bufs, dst=dst, group=g.process_group,
                           async_op=True)

    def then():
        if mine:
            gather_list.extend(bufs)
    return _finish([work], then, sync_op, gather_list)


def send(tensor, dst=0, group=None, sync_op=True):
    g = _resolve(group)
    _member(dst, g, "send")
    _count("send", tensor)
    work = dist.isend(tensor.contiguous(), dst=dst, group=g.process_group)
    return _finish(work, None, sync_op, None)


def recv(tensor, src=0, group=None, sync_op=True):
    g = _resolve(group)
    _member(src, g, "recv")
    _count("recv", tensor)
    work = dist.irecv(tensor, src=src, group=g.process_group)
    return _finish(work, None, sync_op, tensor)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """``paddle.distributed.P2POp``: ``op`` is :func:`isend` or :func:`irecv`;
    ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp: op must be paddle_tpu_torch.distributed.isend or irecv")
        self.op, self.tensor, self.peer, self.group = op, tensor, int(peer), group


def batch_isend_irecv(p2p_op_list) -> list:
    """Issue every point-to-point operation at once; one :class:`Task` an
    operation, in the input's order."""
    ops = []
    for o in p2p_op_list:
        g = _resolve(o.group)
        _member(o.peer, g, "batch_isend_irecv")
        _count("send" if o.op is isend else "recv", o.tensor)
        ops.append(dist.P2POp(dist.isend if o.op is isend else dist.irecv, o.tensor, o.peer,
                              group=g.process_group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return [Task([w]) for w in works]


def barrier(group=None):
    g = _resolve(group)
    _count("barrier")
    if g.process_group is not None:
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor``'s device has finished its queued work."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    return tensor


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, it)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def fused_allreduce(tree, op=ReduceOp.SUM, group=None, async_op=False):
    """All-reduce a tree (dicts, lists, tuples) of tensors as one
    all-reduce a dtype: the leaves of one dtype are flattened into one
    contiguous buffer in leaf order, reduced, and split back. Returns new
    tensors in the input's structure (a :class:`Task` with ``result`` when
    ``async_op``)."""
    g = _resolve(group)
    leaves = _leaves(tree, [])
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    bufs, works = [], []
    top, div = _op(op, g)
    for dtype in sorted(by_dtype, key=str):
        idx = by_dtype[dtype]
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        _count("fused_allreduce", buf)
        if g.process_group is not None:
            works.append(dist.all_reduce(buf, op=top, group=g.process_group, async_op=True))
        bufs.append((idx, buf))
    out = [None] * len(leaves)
    box = {}

    def then():
        for idx, buf in bufs:
            if div:
                _divide(buf, div)
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = buf[off:off + n].view(leaves[i].shape)
                off += n
        box["result"] = _rebuild(tree, iter(out))

    task = Task(works, then)
    if async_op:
        task.result = lambda: (task.wait(), box["result"])[1]
        return task
    task.wait()
    return box["result"]
