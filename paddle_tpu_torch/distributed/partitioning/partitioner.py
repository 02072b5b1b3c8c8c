"""The partitioner: the rule table resolved against a mesh, and the state
placed by it (counterpart of
``paddle_tpu/distributed/partitioning/partitioner.py:30-155``).

``Partitioner(mesh, rules)`` derives each parameter's
:class:`~.rules.PartitionSpec` from its ``logical_axes`` (else its
``shard_axes``, else replicated) and the batch's from the ``batch`` rule.
A dim whose parameter carries ``logical_units`` (a projection's heads) is
cut only where the axis divides the units, so no head is split.
:meth:`Partitioner.shard_model` keeps on each rank the slice of each
parameter that its spec gives it (on the default table: the ``embed`` dim
over ``fsdp``, gathered where its block runs, and the ``vocab``,
``heads``, ``kv`` and ``mlp`` dims over ``tensor``, resident), each
parameter its own tensor (``distributed._sharded.plan_specs``), and
hands the tensor axis to the model (``distributed.tensor_parallel``: the
Llama computes on its heads, columns and vocabulary rows). A
Mixture-of-Experts layer's experts (marked ``("ep", "dp")``, ``ep``
meaning ``tensor`` here, as in the reference) go on ``tensor`` when it is
above 1 and divides them, else on ``dp``: resident slices either way,
reached through ``f`` / ``g`` or through the all-to-all, and every layer
routes over the global batch of the data axes (``fleet.moe``).
:meth:`Partitioner.shard_batch` gives a rank its rows of a batch: its
coordinates on the batch's axes (``dp``, then ``fsdp``) select them;
the tensor ranks of one data rank see the same rows.
"""

from __future__ import annotations

import numpy as np

from .. import _sharded
from ..mesh import ProcessMesh, build_program_mesh, get_mesh
from .rules import DEFAULT_RULES, PartitionSpec, RuleTable

__all__ = ["Partitioner"]

#: the reference's physical axis names -> the program mesh's
_LEGACY_AXES = {"mp": "tensor", "sep": "tensor", "ep": "tensor", "fsdp": "fsdp",
                "sharding": "fsdp", "dp": "dp", "pp": "pipe"}


class Partitioner:
    """Rule-table resolution and state placement over one mesh (the
    current one, else ``build_program_mesh(dp=world)``)."""

    def __init__(self, mesh: ProcessMesh | None = None, rules=None):
        if mesh is None:
            mesh = get_mesh()
        if mesh is None:
            from .. import env as _env

            mesh = build_program_mesh(dp=_env.get_world_size())
        self.mesh = mesh
        self.table = rules if isinstance(rules, RuleTable) else RuleTable(
            rules if rules is not None else DEFAULT_RULES)
        self.update = None

    def spec_for(self, logical_axes, shape=None) -> PartitionSpec:
        return self.table.spec(logical_axes, shape=shape, mesh=self.mesh)

    def batch_spec(self) -> PartitionSpec:
        """The leading batch dim's placement from the ``batch`` rule (axes
        of the mesh above size 1)."""
        try:
            return self.table.spec(("batch",), mesh=self.mesh)
        except KeyError:
            return PartitionSpec()

    def _batch_axes(self) -> tuple:
        spec = self.batch_spec()
        if not spec or spec[0] is None:
            return ()
        return spec[0] if isinstance(spec[0], tuple) else (spec[0],)

    def data_axis_size(self) -> int:
        """The product of the live batch axes: the global batch must
        divide by it."""
        return int(np.prod([self.mesh.get_dim_size(a) for a in self._batch_axes()]))

    def param_spec(self, param) -> PartitionSpec:
        """``param``'s placement: its ``logical_axes`` through the table,
        else its ``shard_axes`` on the program mesh's names, else
        replicated."""
        shape = tuple(getattr(param, "dist_shard", None).full_shape
                      if getattr(param, "dist_shard", None) is not None else param.shape)
        logical = getattr(param, "logical_axes", None)
        if logical:
            units = getattr(param, "logical_units", None)
            if units is not None:
                shape = tuple(n if u is None else u for n, u in zip(shape, units))
            return self.spec_for(logical, shape)
        out, used = [None] * len(shape), set()
        for dim, names in (getattr(param, "shard_axes", None) or {}).items():
            for cand in names if isinstance(names, (list, tuple)) else (names,):
                ax = _LEGACY_AXES.get(cand, cand)
                if (ax in self.mesh.dim_names and ax not in used
                        and self.mesh.get_dim_size(ax) > 1
                        and shape[int(dim)] % self.mesh.get_dim_size(ax) == 0):
                    out[int(dim)] = ax
                    used.add(ax)
                    break
        return PartitionSpec(*out)

    def shard_model(self, model):
        """Keep on this rank its slice of every parameter (see the module
        docstring), record each one's ``parallel_spec``, and make the
        model's :class:`~paddle_tpu_torch.distributed._sharded.ShardedUpdate`
        (:attr:`update`). Returns the model."""
        try:
            axes = tuple(a for a in self.table.mesh_axes("batch") if a in self.mesh.dim_names)
        except KeyError:
            axes = ()
        specs = {}
        for p in model.parameters():
            p.parallel_spec = specs[id(p)] = self.param_spec(p)
        self.update = _sharded.plan_specs(model, self.mesh, specs, axes, "tensor")
        return model

    def batch_part(self) -> tuple:
        """``(index, count)``: this rank's part of a batch."""
        coord = self.mesh.coordinate()
        index = 0
        for a in self._batch_axes():
            index = index * self.mesh.get_dim_size(a) + coord[a]
        return index, self.data_axis_size()

    def shard_batch(self, t):
        """This rank's rows of the batch tensor ``t`` (dim 0)."""
        index, count = self.batch_part()
        if count == 1:
            return t
        if t.shape[0] % count:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over {count} data "
                             "ranks")
        n = t.shape[0] // count
        return t[index * n:(index + 1) * n]

    def describe(self) -> dict:
        """The mesh and the rules, ready for JSON (the sharding manifest)."""
        return {"mesh": {"axes": list(self.mesh.dim_names), "shape": list(self.mesh.shape)},
                "rules": self.table.describe()}

