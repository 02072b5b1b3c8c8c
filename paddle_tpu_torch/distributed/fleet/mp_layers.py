"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py:47-136``).

Each layer keeps this rank's slice of its weight, in Paddle's ``[in, out]``
layout and under Paddle's state-dict keys (``weight``, ``bias``), and
places Megatron's collectives over the model-parallel group
(``mp_group``, else fleet's model group, else the current mesh's tensor
axis; with none, or one of one rank, the layer is the plain one):

- :class:`ColumnParallelLinear`: weight ``[in, out / t]`` and bias ``[out /
  t]``; ``f`` on the input (its gradient all-reduced), and with
  ``gather_output`` the output's last dim all-gathered (its backward keeps
  this rank's part);
- :class:`RowParallelLinear`: weight ``[in / t, out]``; the input's last dim
  cut unless ``input_is_parallel``, the partial products all-reduced, the
  replicated bias added once;
- :class:`VocabParallelEmbedding`: rows ``[V / t, d]``; ids outside this
  rank's rows looked up as zeros, the sum all-reduced;
- :class:`ParallelCrossEntropy`: per-token losses over vocab-cut logits
  (the row max, the sum of exps and the target logit each reduced),
  ``ignore_index`` as the reference.

A weight is drawn whole (the reference's initializer, from ``generator``)
and cut, so a layer holds the same global weight at any tensor size. The
cut parameters carry ``is_distributed`` and their layout (``dist_shard``:
``distributed._sharded.ShardInfo``, its ``tdim`` the cut dim), which the
sharded checkpoint and ``Layer.state_dict()`` carry.
"""

from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from .. import _sharded
from .. import tensor_parallel as tp

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "ParallelLinear", "model_parallel_group"]


def model_parallel_group(mp_group=None):
    """``mp_group``, else fleet's model group, else the current mesh's
    tensor axis (``mp``, ``model`` or ``tensor``); None when there is none
    above one rank."""
    if mp_group is not None:
        return mp_group if mp_group.nranks > 1 else None
    from . import fleet as _fleet
    from ..mesh import TENSOR_AXES, get_mesh

    hcg = _fleet._hcg
    if hcg is not None and hcg.get_model_parallel_world_size() > 1:
        return hcg.get_model_parallel_group()
    mesh = get_mesh()
    for axis in TENSOR_AXES:
        if mesh is not None and axis in mesh.dim_names and mesh.get_dim_size(axis) > 1:
            return mesh.get_group(axis)
    return None


def _cut(p, dim, group):
    """Keep ``group``'s rank's slice of ``p`` along ``dim``."""
    p.is_distributed = group is not None
    if group is None:
        return p
    if p.shape[dim] % group.nranks:
        raise ValueError(f"dim {dim} of {tuple(p.shape)} does not split over {group.nranks} "
                         "model-parallel ranks")
    _sharded.place(p, _sharded.ShardInfo(tuple(p.shape), None, None, None, at_rest=True,
                                          tdim=dim, tgroup=group, norm_group=group))
    return p


class ColumnParallelLinear(Layer):
    """Weight ``[in, out]`` cut on ``out`` (see the module docstring)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=None,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        mk = dict(device=device, generator=generator)
        self.weight = _cut(self.create_parameter((in_features, out_features), weight_attr, dtype,
                                                 default_initializer=I.XavierUniform(), **mk),
                           1, self.group)
        self.weight.shard_axes = {1: "mp", 0: "fsdp"}
        self.bias = None
        if has_bias:
            self.bias = _cut(self.create_parameter((out_features,), None, dtype, is_bias=True,
                                                   **mk), 0, self.group)
            self.bias.shard_axes = {0: "mp"}

    def forward(self, x):
        if self.group is None:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(tp.copy_to(x, self.group), self.weight, self.bias)
        return tp.gather_last(out, self.group) if self.gather_output else out


class ParallelLinear(ColumnParallelLinear):
    pass


class RowParallelLinear(Layer):
    """Weight ``[in, out]`` cut on ``in`` (see the module docstring)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        mk = dict(device=device, generator=generator)
        self.weight = _cut(self.create_parameter((in_features, out_features), weight_attr, dtype,
                                                 default_initializer=I.XavierUniform(), **mk),
                           0, self.group)
        self.weight.shard_axes = {0: "mp", 1: "fsdp"}
        self.bias = (self.create_parameter((out_features,), None, dtype, is_bias=True, **mk)
                     if has_bias else None)

    def forward(self, x):
        if self.group is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = tp.split_last(x, self.group)
        out = tp.reduce_from(F.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Layer):
    """Embedding ``[num_embeddings, embedding_dim]`` cut on its rows (see
    the module docstring)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, mp_group=None,
                 name=None, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = _cut(self.create_parameter((num_embeddings, embedding_dim), weight_attr,
                                                 dtype, default_initializer=I.Normal(0.0, 1.0),
                                                 device=device, generator=generator),
                           0, self.group)
        self.weight.shard_axes = {0: "mp", 1: "fsdp"}

    def forward(self, x):
        if self.group is None:
            return F.embedding(x, self.weight)
        first, _ = tp.vocab_range(self.num_embeddings, self.group)
        return tp.reduce_from(tp.vocab_embedding(x, self.weight, first), self.group)


class ParallelCrossEntropy(Layer):
    """Per-token cross entropy (f32, shape of ``input`` without its class
    dim) over logits cut on the class dim across the model-parallel group
    (see the module docstring)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = model_parallel_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():          # a trailing class axis of size 1
            label = label.squeeze(-1)
        if self.group is None:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        loss = tp.parallel_cross_entropy(input.reshape(-1, input.shape[-1]), label.reshape(-1),
                                         self.group, self.ignore_index)
        return loss.reshape(label.shape)

