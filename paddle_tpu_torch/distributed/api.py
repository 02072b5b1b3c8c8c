"""The semi-auto parallel API: placements, ``shard_tensor`` and ``reshard``
(counterpart of ``paddle_tpu/distributed/api.py:30-234``).

A distributed tensor of the port is this rank's part of a global value,
carrying ``dist_attr`` (:class:`DistAttr`: the mesh and one
:class:`Placement` a mesh dim). Every process holds the value it shards,
as the reference's processes do on a mesh that spans them:

- :func:`shard_tensor` keeps this rank's part (a :class:`Shard` mesh dim
  cuts the tensor dim it names by the rank's coordinate on that mesh dim;
  two mesh dims on one tensor dim cut it outer first); the full value is
  recovered by :func:`unshard_dtensor`, and equals the input. Gradients
  flow: the backward gathers the parts' gradients over the cutting mesh
  dims, so the input's gradient is that of the global value.
- :func:`reshard` gathers a distributed tensor and cuts it anew: to
  ``Replicate`` on every mesh dim it is the full value on every rank.
- :class:`Partial` on a global tensor raises, as the reference's
  (``api.py:115-132``): a value is reduced before it is placed.
- :func:`shard_layer` applies ``shard_fn(name, sublayer, mesh)`` to every
  sublayer; the default replicates the parameters (their values stay).
- :func:`sharding_constraint` places a tensor (reshards a distributed
  one); :func:`dtensor_from_fn` shards what ``fn`` makes.

The collectives are ``distributed.collective``'s over the mesh's groups
(each mesh dim's group made by every process, in the same order).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import ProcessMesh
from .partitioning.rules import PartitionSpec

__all__ = ["Placement", "Shard", "Replicate", "Partial", "DistAttr", "placements_to_spec",
           "shard_tensor", "reshard", "dtensor_from_fn", "unshard_dtensor", "shard_layer",
           "sharding_constraint"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Partial(Placement):
    """A pending reduction. A global tensor is always reduced, so placing
    one as ``Partial`` raises."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("Partial", self.reduce_type))


class DistAttr:
    """The mesh and the placements of a distributed tensor."""

    def __init__(self, mesh: ProcessMesh, placements):
        self.process_mesh = mesh
        self.placements = list(placements)

    def __repr__(self):
        return f"DistAttr(mesh={self.process_mesh}, placements={self.placements})"


def placements_to_spec(placements, ndim: int, mesh: ProcessMesh) -> PartitionSpec:
    """One placement a mesh dim -> one entry a tensor dim."""
    spec: list = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            axis = mesh.dim_names[mesh_dim]
            cur = spec[pl.dim]
            spec[pl.dim] = axis if cur is None else (
                cur + (axis,) if isinstance(cur, tuple) else (cur, axis))
        elif isinstance(pl, Partial):
            raise NotImplementedError(
                "Partial placement on a global tensor: a partial sum exists only inside a "
                "collective's region; reduce before resharding")
    return PartitionSpec(*spec)


def _cuts(mesh, placements, ndim):
    """{tensor dim: [mesh axis, ...] outer first}."""
    spec = placements_to_spec(placements, ndim, mesh)
    return {d: list(e) if isinstance(e, tuple) else [e] for d, e in enumerate(spec)
            if e is not None}


def _part(t, mesh, cuts):
    coord = mesh.coordinate()
    for d, axes in cuts.items():
        index, count = 0, 1
        for a in axes:
            index, count = index * mesh.get_dim_size(a) + coord[a], count * mesh.get_dim_size(a)
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {axes}")
        n = t.shape[d] // count
        t = t.narrow(d, index * n, n)
    return t.contiguous()


def _whole(t, mesh, cuts):
    from .tensor_parallel import gather_dim

    for d, axes in cuts.items():
        for a in reversed(axes):        # the inner cut first
            t = gather_dim(t, d, mesh.get_group(a))
    return t


class _ToPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, cuts):
        ctx.mesh, ctx.cuts = mesh, cuts
        return _part(x, mesh, cuts)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.mesh, ctx.cuts), None, None


class _ToWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, cuts):
        ctx.mesh, ctx.cuts = mesh, cuts
        return _whole(x, mesh, cuts)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.mesh, ctx.cuts), None, None


def _attach(t, mesh, placements, shape):
    t.dist_attr = DistAttr(mesh, placements)
    t.global_shape = tuple(shape)
    return t


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """This rank's part of ``data`` placed by ``placements`` on ``mesh`` (see
    the module docstring); a parameter gives a parameter (a new leaf)."""
    if torch.is_tensor(data) and getattr(data, "dist_attr", None) is not None:
        return reshard(data, mesh, placements)
    t = data if torch.is_tensor(data) else torch.as_tensor(np.asarray(data))
    if dtype is not None:
        from .. import dtype as _dt

        t = t.to(_dt.convert_dtype(dtype))
    cuts = _cuts(mesh, placements, t.dim())
    if isinstance(t, torch.nn.Parameter):
        out = torch.nn.Parameter(_part(t.detach(), mesh, cuts), requires_grad=t.requires_grad)
        for k, v in vars(t).items():
            if k not in ("dist_attr", "global_shape"):
                setattr(out, k, v)
    else:
        out = _ToPart.apply(t, mesh, cuts)
    if stop_gradient is not None and out.is_leaf:
        out.requires_grad_(not stop_gradient)
    return _attach(out, mesh, placements, t.shape)


def unshard_dtensor(dist_tensor):
    """The full value of a distributed tensor (a tensor that is not one is
    returned as it is)."""
    attr = getattr(dist_tensor, "dist_attr", None)
    if attr is None:
        return dist_tensor
    mesh = attr.process_mesh
    return _ToWhole.apply(dist_tensor, mesh, _cuts(mesh, attr.placements, dist_tensor.dim()))


def reshard(dist_tensor, mesh: ProcessMesh, placements):
    """``dist_tensor`` placed anew (the full value gathered, then cut)."""
    placements_to_spec(placements, dist_tensor.dim(), mesh)
    full = unshard_dtensor(dist_tensor)
    return _attach(_ToPart.apply(full, mesh, _cuts(mesh, placements, full.dim())), mesh,
                   placements, full.shape)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """Apply ``shard_fn(name, sublayer, mesh)`` to every sublayer (default:
    each parameter replicated on every mesh dim, its value kept), and the
    optional ``input_fn(inputs, mesh)`` / ``output_fn(outputs, mesh)`` around
    ``layer``'s forward."""
    def default_shard_fn(name, sublayer, mesh):
        for p in sublayer._parameters.values():
            if p is not None:
                _attach(p, mesh, [Replicate() for _ in mesh.shape], p.shape)

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(lambda mod, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(lambda mod, inp, out: output_fn(out, process_mesh))
    return layer


def sharding_constraint(tensor, mesh: ProcessMesh, placements):
    """``tensor`` placed by ``placements`` (a distributed tensor resharded)."""
    if getattr(tensor, "dist_attr", None) is not None:
        return reshard(tensor, mesh, placements)
    return shard_tensor(tensor, mesh, placements)
