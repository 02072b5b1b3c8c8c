"""Process mesh of one process.

Counterpart of ``paddle_tpu/distributed/mesh.py:22-111`` (``ProcessMesh``,
``set_mesh``, ``get_mesh``, ``auto_mesh``). There the mesh wraps the
devices that its axes shard over. Here, until the distributed slice of the
port, it is a plain descriptor of the virtual ranks of one process on one
device: a ``sep`` (context-parallel) axis of any size, which the ring
attention folds into its batch, and a ``dp`` axis and other axes of size 1.
Anything else needs process groups (``torch.distributed``) and raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ProcessMesh", "set_mesh", "get_mesh", "auto_mesh"]

_default_mesh: "ProcessMesh | None" = None


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
            self.process_ids = arr.reshape(-1).tolist()
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
        wide = [f"{n}={s}" for n, s in zip(self.dim_names, self._shape)
                if s != 1 and n != "sep"]
        if wide:
            raise NotImplementedError(
                f"mesh axes {', '.join(wide)} need process groups across devices, which "
                "wait for the distributed slice of the port; a one-process mesh has "
                "only a 'sep' axis of any size (the ring's virtual ranks) and axes of "
                "size 1")

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    def get_dim_size(self, name: str) -> int:
        return self._shape[self.dim_names.index(name)]

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
    """A mesh from named axis sizes, e.g. ``auto_mesh(dp=1, sep=4)``."""
    names = list(axis_sizes)
    return ProcessMesh(shape=[int(axis_sizes[n]) for n in names], dim_names=names)
