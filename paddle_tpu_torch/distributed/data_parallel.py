"""``paddle.DataParallel`` over the bucketed gradient reducer (counterpart
of ``paddle_tpu/distributed/data_parallel.py:72-692``).

At construction the wrapped layer's parameters and buffers are broadcast
from the group's first rank. In a backward, each parameter's gradient,
once accumulated (``register_post_accumulate_grad_hook``), is put into the
current bucket in the order the gradients arrive; a bucket that reaches
``comm_buffer_size`` MB (``last_comm_buffer_size`` MB once the gradients
still to come fit in that) is flattened into one contiguous buffer and
all-reduced asynchronously while the backward goes on. At the end of the
backward (a callback queued on autograd's engine) the last bucket is sent,
every bucket is waited for in order, and each gradient becomes the sum
over the ranks divided by their number. Every rank must produce the
gradients of the same parameters in the same order, as Paddle's reducer
requires.

- Over gloo, two-byte float gradients travel in f32 buckets, by design:
  gloo reduces on the host, where its support of 2-byte floats differs by
  release, and the sum is then rounded once to the gradient's dtype.
- ``PADDLE_DP_SYNC=pergrad``: each gradient is all-reduced on its own as
  it arrives, synchronously (the reference's per-gradient regime, kept as
  the oracle). Both regimes give the same bits at two ranks, where a sum
  over the ranks is one addition whatever the buffer.
- ``no_sync()``: gradients accumulate locally; the first backward after it
  reduces the accumulated gradients.
- ``find_unused_parameters=True``: nothing is sent during the backward;
  at its end every parameter, in parameter order, goes into the buckets,
  with zeros where this rank has no gradient, and a count of the ranks
  that had one goes with them; a parameter no rank reached keeps no
  gradient. Ranks that reach different parameters then still agree.
- ``scale_loss`` is the identity: the gradients are averaged.
- Under a mesh with a context-parallel axis across processes (``sep``:
  each rank holds its positions of the sequence, so its gradients are
  partial there) the buckets are summed over the mesh's data and context
  axes and divided by the data ranks alone: the mean over the data, the
  sum over ``sep`` (``fleet.SegmentParallel``).
- ``TrainStep``, which takes gradients with ``torch.autograd.grad`` and
  not into ``.grad``, reduces them through :meth:`DataParallel.reduce_gradients`,
  in buckets in the reverse order of the parameters.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

from ..nn.layer.layers import Layer
from . import collective as _c
from ._sharded import _reduce_dtype

__all__ = ["DataParallel", "sum_over_context"]

_MB = 1 << 20


def _validate(name, value):
    if not isinstance(value, (int, float)) or isinstance(value, bool) or not value > 0:
        raise ValueError(f"DataParallel: {name} is a positive bucket size in MB (the "
                         f"reference's units); got {value!r}")


class _Reducer:
    """The buckets of one :class:`DataParallel` (see the module
    docstring); :attr:`stats` counts buckets fired (full and tail) and
    gradients bucketed."""

    def __init__(self, params, group, comm_mb, last_mb, find_unused, divisor=None,
                 max_inflight=None):
        self.params = params
        self.group = group
        self.world = group.nranks if divisor is None else divisor
        self.max_inflight = max_inflight      # buckets in flight at most (None: all)
        self.cap = int(comm_mb * _MB)
        self.last_cap = int(last_mb * _MB)
        self.find_unused = find_unused
        self.enabled = True
        self.pergrad = os.environ.get("PADDLE_DP_SYNC", "bucketed").lower() == "pergrad"
        self.total = sum(self._nbytes(p) for p in params)
        self.stats = {"full": 0, "tail": 0, "grads": 0}
        self._reset()
        self._handles = [p.register_post_accumulate_grad_hook(self._on_grad) for p in params]

    def _nbytes(self, p):
        return p.numel() * torch.empty((), dtype=_reduce_dtype(p.dtype, self.group)).element_size()

    def _reset(self):
        self.bucket, self.bucket_bytes = [], 0
        self.deposited = 0
        self.inflight = []
        self.arrived = []
        self.queued = False

    def _on_grad(self, p):
        if not self.enabled:
            return
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(self.flush)
        if self.find_unused:
            self.arrived.append(p)
            return
        if self.pergrad:
            self._reduce_now(p)
            return
        self.deposit(p, p.grad)

    def _reduce_now(self, p):
        rdt = _reduce_dtype(p.grad.dtype, self.group)
        t = p.grad.to(rdt, copy=True)
        _c.all_reduce(t, group=self.group)
        self.stats["grads"] += 1
        p.grad.copy_((t / self.world).to(p.grad.dtype))

    def deposit(self, p, grad):
        if self.bucket and (_reduce_dtype(self.bucket[0][1].dtype, self.group)
                            != _reduce_dtype(grad.dtype, self.group)):
            self._fire("full")
        self.bucket.append((p, grad))
        n = self._nbytes(p)
        self.bucket_bytes += n
        self.deposited += n
        self.stats["grads"] += 1
        cap = self.last_cap if self.total - self.deposited <= self.last_cap else self.cap
        if self.bucket_bytes >= cap:
            self._fire("full")

    def _fire(self, kind):
        entries, self.bucket, self.bucket_bytes = self.bucket, [], 0
        if not entries:
            return
        self.stats[kind] += 1
        rdt = _reduce_dtype(entries[0][1].dtype, self.group)
        flat = torch.cat([g.reshape(-1).to(rdt) for _, g in entries])   # one dtype a bucket
        task = _c.all_reduce(flat, group=self.group, sync_op=False)
        self.inflight.append((task, flat, entries))
        while self.max_inflight and len(self.inflight) > self.max_inflight:
            self._settle(*self.inflight.pop(0))

    def _settle(self, task, flat, entries):
        """Wait for one bucket and write its means into its gradients."""
        task.wait()
        off = 0
        for p, g in entries:
            n = g.numel()
            g.copy_((flat[off:off + n] / self.world).view_as(g).to(g.dtype))
            off += n

    def flush(self):
        """End of a backward: send the rest, wait, write the means."""
        if self.find_unused:
            try:
                self._flush_all()
            except BaseException:
                self._reset()
                raise
        self._drain()

    def _drain(self):
        try:
            self._fire("tail")
            for entry in self.inflight:
                self._settle(*entry)
        finally:
            self._reset()

    def _flush_all(self):
        arrived = {id(p) for p in self.arrived}
        dev = self.params[0].device
        counts = torch.tensor([float(id(p) in arrived) for p in self.params], device=dev)
        _c.all_reduce(counts, group=self.group)
        for p, c in zip(self.params, counts.tolist()):
            if c == 0:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self.deposit(p, p.grad)

    def reduce(self, params, grads, inplace=False):
        """The mean over the ranks of ``grads`` (one a parameter), in
        buckets in the reverse order of ``params``; returns new tensors
        (``inplace``: ``grads`` themselves, written over)."""
        out = list(grads) if inplace else [g.clone() for g in grads]
        for i in reversed(range(len(params))):
            if self.pergrad:
                rdt = _reduce_dtype(out[i].dtype, self.group)
                t = out[i].to(rdt, copy=True)
                _c.all_reduce(t, group=self.group)
                out[i].copy_((t / self.world).to(out[i].dtype))
                continue
            self.deposit(params[i], out[i])
        self._drain()
        return out


def _reduce_group(group):
    """(the group the gradients are summed over, their divisor): ``group``
    and its size, or under a mesh with a context axis across processes the
    mesh's data and context axes and the data axes' size."""
    from .fleet.sharding import DATA_AXES
    from .mesh import context_axes, get_mesh

    mesh = get_mesh()
    ctx = context_axes(mesh)
    if not ctx:
        return group, None
    data = tuple(a for a in mesh.dim_names if a in DATA_AXES and mesh.get_dim_size(a) > 1)
    return (mesh.get_group(tuple(a for a in mesh.dim_names if a in data or a in ctx)),
            math.prod(mesh.get_dim_size(a) for a in data))


#: buckets in flight at most in :func:`sum_over_context`'s reduction
SUM_INFLIGHT = 4


def sum_over_context(model, comm_buffer_size=25, last_comm_buffer_size=1):
    """Under the current mesh's context axis across processes: give
    ``model`` a ``reduce_gradients`` (``TrainStep``'s) that sums its
    gradients over the mesh's data and context axes and divides them by
    the data ranks, in buckets as :class:`DataParallel`'s (at most
    ``SUM_INFLIGHT`` in flight, written over ``TrainStep``'s gradients: a
    model's worth of f32 buckets would double its memory), and the same
    reduction after an eager backward (hooks). Returns ``model``."""
    group, divisor = _reduce_group(None)
    if group is None:
        raise ValueError("sum_over_context needs a mesh with a context axis across processes")
    reducer = _Reducer([p for p in model.parameters() if p.requires_grad], group,
                       comm_buffer_size, last_comm_buffer_size, False, divisor, SUM_INFLIGHT)
    inner = getattr(model, "reduce_gradients", None)

    def reduce_gradients(params, grads):
        if inner is not None:
            grads = inner(params, grads)
        return reducer.reduce(params, grads, inplace=True)

    model.reduce_gradients = reduce_gradients
    return model


class DataParallel(Layer):
    """``paddle.DataParallel(layers, strategy=None, comm_buffer_size=25,
    last_comm_buffer_size=1, find_unused_parameters=False, group=None)``:
    see the module docstring. ``state_dict`` and ``set_state_dict`` are the
    wrapped layer's; other attributes are looked up on it too."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        _validate("comm_buffer_size", comm_buffer_size)
        _validate("last_comm_buffer_size", last_comm_buffer_size)
        super().__init__()
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        g = _c._resolve(group)
        self.group = g
        g, divisor = _reduce_group(g)
        with torch.no_grad():
            for t in list(layers.parameters()) + list(layers.buffers()):
                _c.broadcast(t.data, src=g.ranks[0], group=g)
        trainable = [p for p in layers.parameters() if p.requires_grad]
        self._reducer = _Reducer(trainable, g, comm_buffer_size, last_comm_buffer_size,
                                 find_unused_parameters, divisor)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_modules", {}).get("_layers")
            if inner is None:
                raise
            return getattr(inner, name)

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients of the backward passes inside stay local."""
        prev = self._reducer.enabled
        self._reducer.enabled = False
        try:
            yield
        finally:
            self._reducer.enabled = prev

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Reduce the gradients accumulated without a sync, now."""
        for p in self._reducer.params:
            if p.grad is not None:
                self._reducer.deposit(p, p.grad)
        self._reducer.flush()

    def reduce_gradients(self, params, grads):
        """The mean over the group of ``grads`` (``TrainStep``'s)."""
        return self._reducer.reduce(params, grads)

    def bucket_stats(self) -> dict:
        """Buckets fired ("full", "tail") and gradients reduced ("grads")
        since construction."""
        return dict(self._reducer.stats)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)
