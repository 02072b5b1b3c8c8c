"""``dist.parallelize``: counterpart of
``paddle_tpu/distributed/parallelize.py:44-88``.

The reference places each parameter on the mesh by its shard axes. On a
one-process mesh (:class:`~paddle_tpu_torch.distributed.mesh.ProcessMesh`,
which refuses axes that would need process groups) every parameter stays
where it is, so this makes the mesh current and returns what the
reference returns.
"""

from __future__ import annotations

from .mesh import ProcessMesh, get_mesh, set_mesh

__all__ = ["parallelize"]


def parallelize(model, optimizer=None, mesh: ProcessMesh | None = None, config=None):
    """Make ``mesh`` (or the current mesh) current; ``(model, optimizer)``
    with an optimizer, else ``model``. ``config`` (the reference's
    ``dp_config``/``mp_config``/``pp_config``/``sharding_config``) asks
    for nothing a one-process mesh could shard over."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("parallelize needs a mesh (dist.auto_mesh / set_mesh)")
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"parallelize takes a ProcessMesh, got {type(mesh).__name__}")
    set_mesh(mesh)
    return (model, optimizer) if optimizer is not None else model
