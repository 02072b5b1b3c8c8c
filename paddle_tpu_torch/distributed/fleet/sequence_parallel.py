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

Context parallelism over the mesh's ``sep`` axis (the reference's
``:115-185``, which GSPMD lowers to collectives over the axis): in a
world of several processes each rank of the axis holds S / P positions of
the sequence (:func:`context_link`: its transport, ``_sep_p2p.SepLink``).

- :func:`ring_context_attention`: the ring (``ops.ring_attention``: the
  flash schedule, or the composed ring) over the axis's processes; q, k
  and v are this rank's rows, heads and positions. The reference cuts the
  global tensors' batch over ``dp`` and the heads over ``mp`` (``:139-169``,
  ``batch_ax`` / ``head_ax``); here the rank holds its rows and heads
  already. In a world of one process the axis is the one-process ring of
  virtual ranks over the global sequence.
- Ulysses: :func:`sep_all_to_all_qkv` exchanges ``[b, s/P, h, d]`` for
  ``[b, s, h/P, d]`` (all positions, this rank's heads) and
  :func:`sep_all_to_all_output` back, each an autograd function whose
  backward is the inverse exchange; the heads must divide over the axis.
- :func:`split_sequence`: this rank's positions of ``x`` (dim 1); its
  backward gathers them.
- :class:`SegmentParallel` (``meta_parallel/segment_parallel.py``): the
  model's parameters broadcast over the data and ``sep`` ranks, its
  gradients summed over ``sep`` (partial there: each rank's positions
  reach every parameter) and averaged over the data ranks, in the backward
  (buckets) and in ``TrainStep`` (``reduce_gradients``), as
  ``DataParallel`` under such a mesh.
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
from ..data_parallel import DataParallel
from ..mesh import context_axes, get_mesh
from ._sep_p2p import SepLink
from .mp_layers import _cut, model_parallel_group

__all__ = ["scatter", "all_gather", "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter", "register_sequence_parallel_allreduce_hooks",
           "deferred_hooks", "context_link", "split_sequence", "sep_all_to_all_qkv",
           "sep_all_to_all_output", "SegmentParallel", "ring_context_attention"]


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


def context_link(axis_name: str = "sep", mesh=None):
    """This rank's :class:`~._sep_p2p.SepLink` on ``mesh``'s (the current
    mesh's) context axis ``axis_name`` when it runs across processes (made
    once a mesh and axis), else None (no mesh, no such axis above 1, or a
    world of one process)."""
    mesh = mesh if mesh is not None else get_mesh()
    if axis_name not in context_axes(mesh):
        return None
    links = mesh.__dict__.setdefault("_links", {})
    if axis_name not in links:
        group = mesh.get_group(axis_name)
        if mesh.axis_ranks(axis_name) != group.ranks:
            raise ValueError(f"{mesh}: the {axis_name!r} axis's ranks "
                             f"{mesh.axis_ranks(axis_name)} must rise with their coordinate")
        links[axis_name] = SepLink(group)
    return links[axis_name]


def _link(axis_name):
    link = context_link(axis_name)
    if link is None:
        raise ValueError(f"no {axis_name!r} axis across processes on the current mesh "
                         f"({get_mesh()})")
    return link


def split_sequence(x, axis_name: str = "sep"):
    """This rank's part of ``x``'s sequence (dim 1) over the current mesh's
    ``axis_name`` across processes (``x`` itself in a world of one
    process); the backward gathers the parts."""
    link = context_link(axis_name)
    if link is None:
        return x
    if not x.is_floating_point():
        n = x.shape[1]
        if n % link.size:
            raise ValueError(f"{n} positions over {link.size} {axis_name} ranks: they must "
                             "divide")
        return x.narrow(1, link.index * (n // link.size), n // link.size)
    return tp.scatter_seq(x, link.group)


class _SeqToHeads(torch.autograd.Function):
    """[b, s/P, h, d] -> [b, s, h/P, d]; the backward the inverse."""

    @staticmethod
    def forward(ctx, x, link):
        ctx.link = link
        return _seq_to_heads(x, link)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.link), None


class _HeadsToSeq(torch.autograd.Function):
    """[b, s, h/P, d] -> [b, s/P, h, d]; the backward the inverse."""

    @staticmethod
    def forward(ctx, x, link):
        ctx.link = link
        return _heads_to_seq(x, link)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.link), None


def _seq_to_heads(x, link):
    return torch.cat(link.all_to_all(list(x.chunk(link.size, dim=2))), dim=1)


def _heads_to_seq(x, link):
    return torch.cat(link.all_to_all(list(x.chunk(link.size, dim=1))), dim=2)


def _check_heads(link, **heads):
    bad = {k: h for k, h in heads.items() if h % link.size}
    if bad:
        raise ValueError(f"Ulysses cuts the heads over {link.size} sep ranks: "
                         + ", ".join(f"{k} {h}" for k, h in bad.items())
                         + " do not divide")


def sep_all_to_all_qkv(q, k, v, axis_name: str = "sep"):
    """DeepSpeed-Ulysses' exchange over the current mesh's ``axis_name``:
    each of q, k, v from ``[b, s/P, h, d]`` (this rank's positions, every
    head) to ``[b, s, h/P, d]`` (every position, this rank's heads); their
    heads must divide over the axis (else ValueError naming them)."""
    link = _link(axis_name)
    _check_heads(link, **{"num_heads": q.shape[2], "num_kv_heads": k.shape[2]})
    return tuple(_SeqToHeads.apply(t, link) for t in (q, k, v))


def sep_all_to_all_output(o, axis_name: str = "sep"):
    """The inverse exchange after attention: ``[b, s, h/P, d]`` ->
    ``[b, s/P, h, d]``."""
    return _HeadsToSeq.apply(o, _link(axis_name))


def ring_context_attention(q, k, v, causal: bool = True, axis_name: str = "sep"):
    """Attention of q over k, v (GQA: fewer K/V heads) as a ring over the
    current mesh's ``axis_name``. Across processes q [b, s/P, h, d] and k,
    v [b, s/P, hk, d] are this rank's positions and the result its
    [b, s/P, h, d]; in a world of one process they are the whole sequence,
    which the one-process ring cuts into the axis's size of virtual ranks.
    Under ``amp.auto_cast`` q, k and v are first cast as the op
    ``ring_attention``."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("ring_context_attention requires an active mesh")
    if axis_name not in mesh.dim_names:
        raise ValueError(f"mesh has no {axis_name!r} axis for context parallel")
    q, k, v = cast_inputs("ring_attention", q, k, v)
    link = context_link(axis_name, mesh)
    return ring_attention(q, k, v, mesh.get_dim_size(axis_name), causal=causal, link=link)


class SegmentParallel(DataParallel):
    """``SegmentParallel(layers, hcg=None)``: see the module docstring. The
    data group is ``hcg``'s (fleet's), else the current mesh's data axes;
    a model that takes the whole sequence and keeps its own positions (the
    Llama under ``context_parallel``, ``takes_global_sequence``) gets its
    inputs whole, any other its positions of each input of two or more
    dims (:func:`split_sequence`)."""

    def __init__(self, layers, hcg=None, **kwargs):
        group = hcg.get_data_parallel_group() if hcg is not None else None
        super().__init__(layers, group=group, **kwargs)

    def forward(self, *inputs, **kwargs):
        if not getattr(self._layers, "takes_global_sequence", False):
            inputs = tuple(split_sequence(x) if torch.is_tensor(x) and x.ndim >= 2 else x
                           for x in inputs)
        return self._layers(*inputs, **kwargs)
