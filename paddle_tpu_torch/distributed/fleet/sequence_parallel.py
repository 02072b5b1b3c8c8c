"""Sequence parallelism over the tensor axis, and context parallelism over
the mesh's ``sep`` axis (counterpart of
``paddle_tpu/distributed/fleet/sequence_parallel.py:30-169``).

Megatron's sequence parallelism (the reference's ``:30-113``, which leaves
the collectives to GSPMD): between the tensor-parallel blocks the
activations ``[b, s, h]`` are cut on the sequence (dim 1) over the model
group, and the collectives are autograd functions whose backward is the
other's:

- :func:`scatter` / :class:`ScatterOp`: this rank's part of the sequence;
  backward all-gathers;
- :func:`all_gather` / :class:`GatherOp`: the sequence gathered; backward
  keeps this rank's part;
- :class:`AllGatherOp`: gathered; backward reduce-scatters (before a
  column-parallel product, whose input gradient is partial);
- :class:`ReduceScatterOp`: the partial sums reduce-scattered onto the
  sequence; backward all-gathers (after a row-parallel product).

:class:`ColumnSequenceParallelLinear` gathers its sequence-cut input
before its column-parallel product; :class:`RowSequenceParallelLinear`
reduce-scatters its row-parallel product onto the sequence. A parameter
that sees only this rank's positions (a norm's weight, the row layer's
bias) has a partial gradient:
:func:`mark_as_sequence_parallel_parameter` marks it, and
:func:`register_sequence_parallel_allreduce_hooks` sums its gradient over
the model group, for the eager loop (a hook after the gradient is
accumulated) and for ``TrainStep``, whose ``autograd.grad`` fires no such
hook (the model's ``reduce_gradients``); the partitioner's and
``parallelize``'s sharded update sums it inside the step, and so does the
pipeline once a step (its stages accumulate every microbatch's
gradient: the hooks wait while it runs its schedule,
:func:`deferred_hooks`). The Llama
under a tensor axis with ``sequence_parallel`` runs this schedule itself
(``models.llama``).

``ring_context_attention`` is the ring over the mesh's ``sep`` axis on
one device. Ulysses' all-to-all and the ring's send and receive between
processes wait for the port's sep-across-processes slice.
"""

from __future__ import annotations

import contextlib

import torch

from ...amp import cast_inputs
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from ...ops.ring_attention import ring_attention
from .. import collective as _c
from .. import tensor_parallel as tp
from ..mesh import get_mesh
from .mp_layers import _cut, model_parallel_group

__all__ = ["scatter", "all_gather", "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter", "register_sequence_parallel_allreduce_hooks",
           "deferred_hooks",
           "ring_context_attention"]


def _group(group):
    g = model_parallel_group(group)
    if g is None:
        raise ValueError("sequence parallelism needs a model-parallel group above one rank "
                         "(fleet.init with mp_degree > 1, or a mesh with an mp axis)")
    return g


def scatter(x, group=None):
    """This rank's part of ``x``'s sequence (dim 1 of ``[b, s, h]``)."""
    return tp.scatter_seq(x, _group(group))


def all_gather(x, group=None):
    """``x``'s sequence gathered from the model group's ranks."""
    return tp.gather_seq(x, _group(group))


class ScatterOp:
    @staticmethod
    def apply(x, group=None):
        return scatter(x, group)


class GatherOp:
    @staticmethod
    def apply(x, group=None):
        return all_gather(x, group)


class AllGatherOp:
    @staticmethod
    def apply(x, group=None):
        return tp.all_gather_seq(x, _group(group))


class ReduceScatterOp:
    @staticmethod
    def apply(x, group=None):
        return tp.reduce_scatter_seq(x, _group(group))


class ColumnSequenceParallelLinear(Layer):
    """Weight ``[in, out]`` cut on ``out``; the sequence-cut input gathered
    (:class:`AllGatherOp`) before the product, whose output stays cut on its
    last dim."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=None,
                 gather_output=False, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear keeps its output cut "
                             "(gather_output=False), as the reference's")
        self.group = _group(mp_group)
        mk = dict(device=device, generator=generator)
        self.weight = _cut(self.create_parameter((in_features, out_features), weight_attr, dtype,
                                                 default_initializer=I.XavierUniform(), **mk),
                           1, self.group)
        self.bias = None
        if has_bias:
            self.bias = _cut(self.create_parameter((out_features,), None, dtype, is_bias=True,
                                                   **mk), 0, self.group)

    def forward(self, x):
        return F.linear(tp.all_gather_seq(x, self.group), self.weight, self.bias)


class RowSequenceParallelLinear(Layer):
    """Weight ``[in, out]`` cut on ``in``; the partial product
    reduce-scattered onto the sequence (:class:`ReduceScatterOp`), then the
    bias (a sequence-parallel parameter) added."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=True, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear takes its input cut "
                             "(input_is_parallel=True), as the reference's")
        self.group = _group(mp_group)
        mk = dict(device=device, generator=generator)
        self.weight = _cut(self.create_parameter((in_features, out_features), weight_attr, dtype,
                                                 default_initializer=I.XavierUniform(), **mk),
                           0, self.group)
        self.bias = None
        if has_bias:
            self.bias = mark_as_sequence_parallel_parameter(
                self.create_parameter((out_features,), None, dtype, is_bias=True, **mk))

    def forward(self, x):
        out = tp.reduce_scatter_seq(F.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


def mark_as_sequence_parallel_parameter(param):
    """Mark ``param`` as one whose gradient is partial over the model group
    (it sees this rank's positions only)."""
    param.sequence_parallel = True
    return param


_deferred = [0]     # pipelines running their schedule (the hooks run in autograd's thread)


@contextlib.contextmanager
def deferred_hooks():
    """Inside the block the hooks of
    :func:`register_sequence_parallel_allreduce_hooks` do nothing: the
    caller sums the marked gradients itself, once."""
    _deferred[0] += 1
    try:
        yield
    finally:
        _deferred[0] -= 1


def register_sequence_parallel_allreduce_hooks(model, fuse_grad=True, group=None):
    """Sum the gradients of ``model``'s sequence-parallel parameters over
    the model group: after ``backward()`` accumulates each (a hook), and in
    ``TrainStep`` (``model.reduce_gradients``, which it calls with the
    gradients it took). Returns ``model``."""
    g = _group(group)
    marked = [p for p in model.parameters() if getattr(p, "sequence_parallel", False)]
    ids = {id(p) for p in marked}

    def hook(p):
        if p.grad is not None and not _deferred[0]:
            p.grad.copy_(tp.reduce_sum(p.grad, g))

    for p in marked:
        p.register_post_accumulate_grad_hook(hook)
    inner = getattr(model, "reduce_gradients", None)

    def reduce_gradients(params, grads):
        if inner is not None:
            grads = inner(params, grads)
        idx = [i for i, p in enumerate(params) if id(p) in ids]
        if idx:
            summed = _c.fused_allreduce([grads[i].float() for i in idx], group=g)
            grads = list(grads)
            for i, s in zip(idx, summed):
                grads[i] = s.to(grads[i].dtype)
        return grads

    model.reduce_gradients = reduce_gradients
    return model


def ring_context_attention(q, k, v, causal: bool = True, axis_name: str = "sep"):
    """Attention of q [b, s, h, d] over k, v [b, s, hk, d] as a ring over
    the current mesh's ``axis_name`` (its size is the number of ranks,
    each holding s / size positions); returns [b, s, h, d]. GQA is handled
    inside the ring. Under ``amp.auto_cast`` q, k and v are first cast as
    the op ``ring_attention``."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("ring_context_attention requires an active mesh")
    if axis_name not in mesh.dim_names:
        raise ValueError(f"mesh has no {axis_name!r} axis for context parallel")
    q, k, v = cast_inputs("ring_attention", q, k, v)
    return ring_attention(q, k, v, mesh.get_dim_size(axis_name), causal=causal)
