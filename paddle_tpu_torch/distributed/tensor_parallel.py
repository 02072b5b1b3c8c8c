"""Tensor parallelism: the collectives Megatron places by hand, as autograd
functions over the tensor axis's group, and their installation in a model.

Where the reference writes a GSPMD sharding constraint and lets XLA place
the collective, the port places it:

- ``f`` (:func:`copy_to`): identity forward, all-reduce backward; before a
  column-parallel product, whose input gradient is partial on each rank;
- ``g`` (:func:`reduce_from`): all-reduce forward, identity backward; after
  a row-parallel product, whose output is partial;
- :func:`gather_last` / :func:`split_last`: the last dim gathered (its
  backward keeps this rank's part) or cut (its backward gathers);
- on the sequence dim (Megatron's sequence parallelism, dim 1 of ``[b, s,
  h]``): :func:`scatter_seq` (cut; backward gathers), :func:`gather_seq`
  (gather; backward cuts), :func:`all_gather_seq` (gather; backward
  reduce-scatters: before a column-parallel product) and
  :func:`reduce_scatter_seq` (reduce-scatter; backward gathers: after a
  row-parallel product);
- :func:`vocab_embedding` (ids outside this rank's rows looked up as zeros,
  the partial sums reduced by the caller) and
  :func:`parallel_cross_entropy` over vocab-cut logits (the row max, then
  the sum of exps and the target logit that only its owner supplies, each
  reduced; the backward is local).

Each collective is counted by ``distributed.collective.stats()``. A
two-byte float crosses gloo as f32 (gloo reduces on the host), and is
rounded back once.

:class:`TensorParallel` is a model's view of the axis: ``enter(x,
active)`` before a block that computes on its slices and ``exit(x,
active)`` after it (``f`` / ``g``, or under sequence parallelism
all-gather / reduce-scatter on the sequence; an inactive block, whose
weights the axis does not cut, computes whole: identity, or the sequence
gathered and cut). :func:`install` hands it to a model: one that defines
``install_tensor_parallel(tp, is_cut)`` (the Llama) places its own
collectives and names its parameters whose gradients are partial across
the axis; in any other model each ``Linear`` whose weight is cut becomes
column-parallel (output gathered) or row-parallel (input cut, output
reduced), each ``Embedding`` cut on its rows vocab-parallel, and each
Mixture-of-Experts layer whose experts are cut runs its own between ``f``
and ``g`` (``MoELayer.install_tensor_parallel``). The axis may be a
legacy mesh's ``ep``, which cuts only experts.
"""

from __future__ import annotations

import torch

from . import collective as _c

__all__ = ["TensorParallel", "install", "reduce_sum", "gather_dim", "copy_to", "reduce_from",
           "gather_last", "split_last", "scatter_seq", "gather_seq", "all_gather_seq",
           "reduce_scatter_seq", "vocab_embedding", "parallel_cross_entropy", "vocab_range"]


def _wire(x, group):
    if group.backend == "gloo" and x.dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return x.dtype


def reduce_sum(x, group, op=_c.ReduceOp.SUM):
    """``x`` reduced over ``group`` (a new tensor; not differentiable)."""
    buf = x.to(_wire(x, group), copy=True).contiguous()
    _c.all_reduce(buf, op=op, group=group)
    return buf.to(x.dtype)


def gather_dim(x, dim, group):
    """The ranks' ``x`` concatenated on ``dim`` (not differentiable)."""
    n = group.nranks
    src = x.to(_wire(x, group)).contiguous()
    rows = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    _c.all_gather(rows, src, group=group)
    return torch.cat(list(rows), dim=dim).to(x.dtype)


def _split(x, dim, group):
    n = x.shape[dim]
    if n % group.nranks:
        raise ValueError(f"dim {dim} of size {n} does not split over {group.nranks} tensor ranks")
    part = n // group.nranks
    return x.narrow(dim, group.rank * part, part).contiguous()


def _reduce_scatter(x, dim, group):
    n = group.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} tensor ranks")
    wire = _wire(x, group)
    parts = [p.to(wire).reshape(-1) for p in x.chunk(n, dim)]
    out = torch.empty(parts[0].numel(), dtype=wire, device=x.device)
    _c.reduce_scatter(out, torch.cat(parts), group=group)
    shape = list(x.shape)
    shape[dim] //= n
    return out.reshape(shape).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Gather on ``dim``; the backward keeps this rank's part (``reduce``:
    reduce-scatters it, the gradient being partial)."""

    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _split(g, ctx.dim, ctx.group), None, None, None


class _Split(torch.autograd.Function):
    """This rank's part of ``dim`` (``reduce``: the reduce-scatter of the
    partial ``x``); the backward gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group) if reduce else _split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None, None


def copy_to(x, group):
    """``f``: identity forward, all-reduce of the gradient backward."""
    return _Copy.apply(x, group)


def reduce_from(x, group):
    """``g``: all-reduce forward, identity backward."""
    return _Reduce.apply(x, group)


def gather_last(x, group):
    return _Gather.apply(x, x.dim() - 1, group, False)


def split_last(x, group):
    return _Split.apply(x, x.dim() - 1, group, False)


def scatter_seq(x, group, dim=1):
    return _Split.apply(x, dim, group, False)


def gather_seq(x, group, dim=1):
    return _Gather.apply(x, dim, group, False)


def all_gather_seq(x, group, dim=1):
    return _Gather.apply(x, dim, group, True)


def reduce_scatter_seq(x, group, dim=1):
    return _Split.apply(x, dim, group, True)


def vocab_range(num_embeddings: int, group) -> tuple:
    """``(first row, rows)`` of this rank's slice of ``num_embeddings``."""
    n = num_embeddings // group.nranks
    return group.rank * n, n


def vocab_embedding(ids, weight, first: int):
    """The rows of ``weight`` (this rank's ``[rows, d]`` from row
    ``first``) for the ``ids`` it holds, zeros for the others: the partial
    sum that the caller reduces."""
    local = ids.long() - first
    held = (local >= 0) & (local < weight.shape[0])
    out = torch.nn.functional.embedding(torch.where(held, local, torch.zeros_like(local)), weight)
    return out * held.unsqueeze(-1).to(out.dtype)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, first, group, ignore_index):
        x = logits.float()
        m = reduce_sum(x.amax(dim=-1), group, _c.ReduceOp.MAX)
        e = torch.exp(x - m.unsqueeze(-1))
        lab = labels.long()
        local = lab - first
        held = (local >= 0) & (local < x.shape[-1]) & (lab != ignore_index)
        safe = torch.where(held, local, torch.zeros_like(local))
        picked = x.gather(-1, safe.unsqueeze(-1)).squeeze(-1) * held
        sums = reduce_sum(torch.stack([e.sum(dim=-1), picked]), group)
        valid = lab != ignore_index
        loss = (torch.log(sums[0]) + m - sums[1]) * valid
        ctx.save_for_backward(e, sums[0], safe, held, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, total, safe, held, valid = ctx.saved_tensors
        grad = e / total.unsqueeze(-1)
        grad.scatter_add_(-1, safe.unsqueeze(-1), -held.unsqueeze(-1).to(grad.dtype))
        grad = grad * (g.float() * valid).unsqueeze(-1)
        return grad.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits, labels, group, ignore_index=-100):
    """Per-token softmax cross entropy (f32) of vocab-cut ``logits`` ``[...,
    V / t]`` (this rank's columns of the vocabulary) against global
    ``labels``; 0 where the label is ``ignore_index``."""
    first, _ = vocab_range(logits.shape[-1] * group.nranks, group)
    return _VocabParallelCE.apply(logits, labels, first, group, ignore_index)


class TensorParallel:
    """One model's view of the tensor axis: its ``group`` (this rank's
    ``rank`` of ``size``), whether activations between blocks are cut on
    the sequence (``sequence_parallel``) and whether a column-parallel head
    gathers its output (``gather_output``; a pipeline's last stage keeps
    its vocabulary columns for ``ParallelCrossEntropy``)."""

    def __init__(self, group, sequence_parallel: bool = False, gather_output: bool = True):
        self.group = group
        self.rank = group.rank
        self.size = group.nranks
        self.sequence_parallel = bool(sequence_parallel)
        self.gather_output = bool(gather_output)

    def enter(self, x, active: bool = True):
        """The input of a block: whole (and under sequence parallelism
        gathered), ``f`` before a block that computes on its slices."""
        if self.sequence_parallel:
            return all_gather_seq(x, self.group) if active else gather_seq(x, self.group)
        return copy_to(x, self.group) if active else x

    def exit(self, x, active: bool = True):
        """The output of a block: ``g`` after one that computes partial sums
        (under sequence parallelism reduce-scattered onto the sequence)."""
        if self.sequence_parallel:
            return reduce_scatter_seq(x, self.group) if active else scatter_seq(x, self.group)
        return reduce_from(x, self.group) if active else x


def install(model, group, specs: dict, axis: str, gather_output: bool = True) -> set:
    """Hand the tensor axis (``group``) to ``model``, whose parameters are
    placed by ``specs`` (``{id(p): PartitionSpec}``, ``axis`` the tensor
    axis's name); returns the ids of the parameters replicated across the
    axis whose gradients are partial on each rank (summed over it by the
    update). Without ``gather_output`` a column-parallel ``Linear`` keeps
    its output's columns (and adds its bias's)."""
    def cut_dims(p):
        return [d for d, e in enumerate(specs.get(id(p), ()))
                if e == axis or (isinstance(e, tuple) and axis in e)]

    def is_cut(p):
        return bool(cut_dims(p))

    config = getattr(model, "config", None)
    tp = TensorParallel(group, getattr(config, "sequence_parallel", False), gather_output)
    own = getattr(model, "install_tensor_parallel", None)
    if own is not None:
        return own(tp, is_cut)
    from ..nn.layer import Embedding, Linear
    from .fleet.moe import MoELayer

    partial = set()
    for mod in model.modules():
        if isinstance(mod, MoELayer):
            partial |= mod.install_tensor_parallel(tp, is_cut)
        elif isinstance(mod, Linear) and is_cut(mod.weight):
            column = cut_dims(mod.weight) == [1]
            mod.forward = _column_forward(mod, tp) if column else _row_forward(mod, tp)
            if column and not gather_output and mod.bias is not None:
                partial.add(id(mod.bias))      # each rank adds its columns of the bias
        elif isinstance(mod, Embedding) and is_cut(mod.weight):
            mod.forward = _embedding_forward(mod, tp)
    return partial


def _column_forward(mod, tp):
    from ..nn import functional as F

    def forward(x):
        out = F.linear(copy_to(x, tp.group), mod.weight)
        if not tp.gather_output:
            n = out.shape[-1]
            return out if mod.bias is None else out + mod.bias.narrow(0, tp.rank * n, n)
        out = gather_last(out, tp.group)
        return out if mod.bias is None else out + mod.bias
    return forward


def _row_forward(mod, tp):
    from ..nn import functional as F

    def forward(x):
        out = reduce_from(F.linear(split_last(x, tp.group), mod.weight), tp.group)
        return out if mod.bias is None else out + mod.bias
    return forward


def _embedding_forward(mod, tp):
    def forward(ids):
        first = tp.rank * mod.weight.shape[0]
        return reduce_from(vocab_embedding(ids, mod.weight, first), tp.group)
    return forward
