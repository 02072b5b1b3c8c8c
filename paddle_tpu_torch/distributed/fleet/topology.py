"""Hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/fleet/topology.py:24-191``).

:class:`CommunicateTopology` is the cartesian layout of the world's ranks
over fleet's axes (``data``, ``pipe``, ``sharding``, ``sep``, ``model``);
:class:`HybridCommunicateGroup` makes the process group of every axis
(every rank makes every group, in the axes' order) and answers the rank
and world-size getters, the model group's (tensor parallelism) among
them. At ``pipe`` above 1 the mode is "pipeline": the stage id, the pipe
group (this rank's stages, in stage order) and the previous and next
stage's global ranks (cyclic, as Paddle's ``_set_p2p_prev_next``: the
interleaved schedule sends from the last stage to the first) come from
the real pipe group, at any mix of the degrees (dp x pp x sharding x
mp, and sep beside any of them); :meth:`HybridCommunicateGroup.get_parallel_mode`
keeps the reference's precedence (pipeline, then sharding, sep, model,
data): at ``sep`` above 1 alone or beside data and model the mode is
"segment_parallel", and the ``sep`` group (:meth:`get_sep_parallel_group`)
carries the ring and Ulysses' all-to-all (``fleet.sequence_parallel``).
Fleet has no ``ep_degree``, as the reference has none: experts go on a
mesh's ``ep`` or ``dp`` axis (``parallelize``, the partitioner).
"""

from __future__ import annotations

import itertools

import numpy as np

from .. import env as _env
from ..collective import make_groups
from ..mesh import ProcessMesh, check_axes

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

#: fleet's axis names -> the mesh's
_MESH_NAMES = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
               "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep", "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world_size = int(np.prod(self._dims))
        self._rank_mesh = np.arange(self._world_size).reshape(self._dims)
        self._coord_of_rank = {int(self._rank_mesh[c]): c for c in
                               itertools.product(*[range(d) for d in self._dims])}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        return int(self._rank_mesh[tuple(kwargs[n] for n in self._parallel_names)])

    def get_coord(self, rank):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name, index):
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        ax = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coord_of_rank.items() if c[ax] == index)

    def get_comm_list(self, axis_name):
        """The groups of ranks along ``axis_name``."""
        ax = self._parallel_names.index(axis_name)
        groups: dict = {}
        for r, c in self._coord_of_rank.items():
            groups.setdefault(tuple(v for i, v in enumerate(c) if i != ax), []).append((c[ax], r))
        return [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self._coord_of_rank[global_rank])
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return int(self._rank_mesh[tuple(coord)])


class HybridCommunicateGroup:
    """The groups of a :class:`CommunicateTopology` over the world (made
    at construction)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        check_axes([_MESH_NAMES.get(n, n) for n in names],
                   [topology.get_dim(n) for n in names])
        self.global_rank = _env.get_rank()
        self.nranks = topology.world_size()
        if self.nranks != _env.get_world_size():
            raise ValueError(f"the topology's degrees {dict(zip(names, topology._dims))} "
                             f"make {self.nranks} ranks, the world {_env.get_world_size()}")
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        self._groups = {n: make_groups(topology.get_comm_list(n)) for n in names}
        self._dp_degree = topology.get_dim("data")
        self._mp_degree = topology.get_dim("model")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        stages = next(g for g in topology.get_comm_list("pipe") if self.global_rank in g)
        i = stages.index(self.global_rank)
        self.prev_rank = stages[(i - 1) % self._pp_degree]
        self.next_rank = stages[(i + 1) % self._pp_degree]

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._sep_degree > 1:
            return "segment_parallel"
        if self._mp_degree > 1:
            return "model_parallel"
        return "data_parallel"

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_pipe_parallel_rank(self):
        return self._coord["pipe"]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def _get_p2p_prev_rank(self):
        """The previous stage's global rank (the last stage's before the
        first), Paddle's name."""
        return self.prev_rank

    def _get_p2p_next_rank(self):
        """The next stage's global rank (the first stage's after the last)."""
        return self.next_rank

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def get_global_rank(self):
        return self.global_rank

    def topology(self):
        return self._topo

    def build_mesh(self) -> ProcessMesh:
        """The mesh of this topology in the mesh's order (``pp``, ``dp``,
        ``sharding``, ``sep``, ``mp``), holding this object's groups."""
        topo_names = self._topo.get_hybrid_group_names()
        names = [n for n in ("pipe", "data", "sharding", "sep", "model") if n in topo_names]
        ids = np.transpose(self._topo._rank_mesh, [topo_names.index(n) for n in names])
        mesh = ProcessMesh(mesh=ids, dim_names=[_MESH_NAMES[n] for n in names])
        for n in names:
            mesh._groups[(_MESH_NAMES[n],)] = self._groups[n]
        return mesh
