"""The process mesh (counterpart of ``paddle_tpu/distributed/mesh.py:22-202``).

A :class:`ProcessMesh` lays the world's processes (one a device) out on
named axes. Its groups are made once, on first use, and kept:
:meth:`ProcessMesh.get_group` gives this process's group along one axis or
several (every process asks for the same groups in the same order, as
``torch.distributed.new_group`` needs). The meshes of the partitioning
tier (:func:`build_program_mesh`: ``dp``, ``pipe``, ``fsdp``, ``tensor``)
and of fleet's topology (:func:`init_mesh_from_topology`) are built here.

The tensor axis (``tensor`` on the partitioning tier's mesh, ``mp`` /
``model`` on fleet's) is a group like any other: the partitioner, fleet's
mp layers and ``parallelize(mp_config=...)`` place its collectives
(``distributed.tensor_parallel``). The pipe axis (``pipe`` on the
partitioning tier's mesh, ``pp`` on fleet's) carries the pipeline's
stages (``fleet.pipeline_parallel``), beside the data, sharding / fsdp
and tensor axes; its group (:meth:`ProcessMesh.get_group`) holds this
rank's stages and :meth:`ProcessMesh.axis_ranks` their global ranks in
stage order. The context axes (``sep``, ``cp``) cut the sequence over
their ranks across processes (``fleet.sequence_parallel``). The expert
axis ``ep`` holds a Mixture-of-Experts layer's experts, its ranks the same
rows (``fleet.moe``): its groups are made like any other. In a world of
one process a mesh whose only axis above 1 is ``sep`` is the one-process
ring (``ops.ring_attention``): virtual ranks of this process on its
device, which the ring attention folds into its batch.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["ProcessMesh", "set_mesh", "get_mesh", "auto_mesh", "init_mesh_from_topology",
           "init_hybrid_mesh", "build_program_mesh", "context_axes"]

_default_mesh: "ProcessMesh | None" = None

#: axis name -> the later slice of the port that brings it (none waits)
WAITING_AXES: dict = {}

#: the names of the tensor axis
TENSOR_AXES = ("tensor", "mp", "model")

#: the names of the pipe axis
PIPE_AXES = ("pipe", "pp")

#: the names of the context-parallel axes (the sequence cut over their ranks)
CONTEXT_AXES = ("sep", "cp")


def check_axes(names, sizes) -> None:
    """Raise ``NotImplementedError`` for an axis above 1 that a later
    slice brings."""
    for name, size in zip(names, sizes):
        if size > 1 and name in WAITING_AXES:
            raise NotImplementedError(
                f"mesh axis {name}={size} waits for the port's {WAITING_AXES[name]} slice")


def context_axes(mesh) -> tuple:
    """``mesh``'s context-parallel axes above 1 that run across processes:
    none in a world of one process (its ``sep`` axis is the one-process
    ring's virtual ranks)."""
    from . import env as _env

    if mesh is None or not _env.is_initialized() or _env.get_world_size() < 2:
        return ()
    return tuple(n for n, s in zip(mesh.dim_names, mesh.shape) if n in CONTEXT_AXES and s > 1)


class ProcessMesh:
    """``dist.ProcessMesh(mesh=None, dim_names=None, shape=None)``: the
    axes' sizes from ``mesh`` (an array of process ids) or ``shape``; axes
    are named ``d0, d1, ..`` unless ``dim_names`` says otherwise. Used as a
    context manager, it is the current mesh inside the block."""

    def __init__(self, mesh=None, dim_names=None, shape=None):
        if mesh is not None:
            arr = np.asarray(mesh)
            if arr.ndim == 0:
                arr = arr.reshape(1)
            shape = arr.shape
            self.process_ids = [int(x) for x in arr.reshape(-1)]
        else:
            if shape is None:
                raise ValueError("ProcessMesh needs mesh or shape")
            shape = tuple(int(s) for s in shape)
            self.process_ids = list(range(int(np.prod(shape))))
        self._shape = tuple(int(s) for s in shape)
        self.dim_names = (list(dim_names) if dim_names is not None
                          else [f"d{i}" for i in range(len(self._shape))])
        if len(self.dim_names) != len(self._shape):
            raise ValueError(f"{len(self.dim_names)} dim_names for a mesh of shape "
                             f"{list(self._shape)}")
        check_axes(self.dim_names, self._shape)
        self._groups: dict = {}

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def mesh(self):
        return np.asarray(self.process_ids).reshape(self._shape)

    @property
    def size(self) -> int:
        return len(self.process_ids)

    def get_dim_size(self, name: str) -> int:
        return self._shape[self.dim_names.index(name)]

    def get_rank_by_dim_and_process_id(self, dim, process_id) -> int:
        """The coordinate of ``process_id`` along ``dim`` (a name or an
        index)."""
        coords = np.unravel_index(self.process_ids.index(process_id), self._shape)
        return int(coords[self.dim_names.index(dim) if isinstance(dim, str) else dim])

    def coordinate(self, process_id=None) -> dict:
        """``{axis: coordinate}`` of ``process_id`` (this process)."""
        from . import env as _env

        pid = _env.get_rank() if process_id is None else process_id
        coords = np.unravel_index(self.process_ids.index(pid), self._shape)
        return {n: int(c) for n, c in zip(self.dim_names, coords)}

    def axis_ranks(self, dim: str) -> list:
        """The global ranks along ``dim`` through this process, in the order
        of their coordinates on ``dim`` (a pipeline's stage order)."""
        from . import env as _env

        coords = list(np.unravel_index(self.process_ids.index(_env.get_rank()), self._shape))
        ax = self.dim_names.index(dim)
        coords[ax] = slice(None)
        return [int(x) for x in self.mesh[tuple(coords)]]

    def get_group(self, dims):
        """This process's group along ``dims`` (an axis name or a tuple of
        them): the processes whose coordinates on the other axes are its
        own, ordered by their coordinates on ``dims``. Made the first time
        it is asked for (by every process of the world) and kept."""
        from . import collective as _c
        from . import env as _env

        key = (dims,) if isinstance(dims, str) else tuple(dims)
        if key in self._groups:
            return self._groups[key]
        _c._world()
        if self.size != _env.get_world_size():
            raise ValueError(f"{self} holds {self.size} processes, the world "
                             f"{_env.get_world_size()}")
        axes = [self.dim_names.index(d) for d in key]
        others = [i for i in range(self.ndim) if i not in axes]
        arr = self.mesh
        lists = []
        for rest in itertools.product(*[range(self._shape[i]) for i in others]):
            idx = [slice(None)] * self.ndim
            for i, c in zip(others, rest):
                idx[i] = c
            sub = np.transpose(arr[tuple(idx)] if others else arr,
                               [sorted(axes).index(a) for a in axes])
            lists.append([int(x) for x in sub.reshape(-1)])
        self._groups[key] = _c.make_groups(lists)
        return self._groups[key]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self._shape == other._shape
                and self.dim_names == other.dim_names
                and self.process_ids == other.process_ids)

    def __hash__(self):
        return hash((self._shape, tuple(self.dim_names), tuple(self.process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dim_names={self.dim_names})"

    def __enter__(self):
        self._prev = get_mesh()
        set_mesh(self)
        return self

    def __exit__(self, *exc):
        set_mesh(self._prev)
        return False


def set_mesh(mesh: ProcessMesh | None):
    global _default_mesh
    _default_mesh = mesh


def get_mesh() -> ProcessMesh | None:
    return _default_mesh


def auto_mesh(**axis_sizes) -> ProcessMesh:
    """A mesh from named axis sizes, e.g. ``auto_mesh(dp=2, fsdp=2)``."""
    names = list(axis_sizes)
    return ProcessMesh(shape=[int(axis_sizes[n]) for n in names], dim_names=names)


def init_mesh_from_topology(dp=1, mp=1, pp=1, sharding=1, sep=1) -> ProcessMesh:
    """Fleet's axis order: ``pp``, ``dp``, ``sharding``, ``sep``, ``mp``."""
    return ProcessMesh(shape=[pp, dp, sharding, sep, mp],
                       dim_names=["pp", "dp", "sharding", "sep", "mp"])


def init_hybrid_mesh(dcn=1, pp=1, dp=1, sharding=1, sep=1, mp=1) -> ProcessMesh:
    """Fleet's order behind a leading ``dcn`` axis (the nodes): the
    processes of one node are consecutive ranks, as the launcher numbers
    them."""
    return ProcessMesh(shape=[dcn, pp, dp, sharding, sep, mp],
                       dim_names=["dcn", "pp", "dp", "sharding", "sep", "mp"])


def build_program_mesh(dp=1, fsdp=1, tensor=1, pipe=1) -> ProcessMesh:
    """The partitioning tier's mesh: axes ``("dp", "pipe", "fsdp",
    "tensor")``, ``dp`` outermost (its gradient all-reduce is the
    collective that tolerates the slowest links), ``tensor`` innermost."""
    return ProcessMesh(shape=[dp, pipe, fsdp, tensor], dim_names=["dp", "pipe", "fsdp", "tensor"])
