"""The rule table's ``stage`` axis drives the pipeline (counterpart of
``paddle_tpu/distributed/partitioning/pipeline.py:23-63``).

:func:`resolve_stage_axis` names the mesh axis that the rule table
assigns to the logical ``stage`` axis (``pipe`` on the default table), or
None when no axis of the mesh above 1 carries it; :func:`pipeline_from_rules`
builds :class:`~..fleet.pipeline_parallel.PipelineParallel` over that
axis, every other keyword passed through, and the table places each
stage's parameters over the other axes (:meth:`Partitioner.param_spec`:
``tensor`` resident, ``fsdp`` at rest; the reference's
``partitioning/pipeline.py:40-63`` keeps them). When every other axis of
the mesh is 1 the mesh is squeezed to the one stage axis (the same
processes in the same order).
"""

from __future__ import annotations

import numpy as np

from ..fleet.pipeline_parallel import PipelineParallel
from ..mesh import ProcessMesh
from .partitioner import Partitioner

__all__ = ["pipeline_from_rules", "resolve_stage_axis"]


def resolve_stage_axis(partitioner: Partitioner) -> str | None:
    """The mesh axis of logical ``stage``, None when the table leaves it
    unmapped or no such axis of the mesh is above 1."""
    try:
        axes = partitioner.table.mesh_axes("stage")
    except KeyError:
        return None
    mesh = partitioner.mesh
    for ax in axes:
        if ax in mesh.dim_names and mesh.get_dim_size(ax) > 1:
            return ax
    return None


def pipeline_from_rules(first, layers, last, loss_fn, *,
                        partitioner: Partitioner | None = None, **kw):
    """``PipelineParallel`` over the axis of :func:`resolve_stage_axis`;
    a ``ValueError`` naming ``stage`` when there is none."""
    part = partitioner if partitioner is not None else Partitioner()
    axis = resolve_stage_axis(part)
    if axis is None:
        raise ValueError(
            "rule table maps logical 'stage' onto no live mesh axis "
            f"(mesh axes { {n: s for n, s in zip(part.mesh.dim_names, part.mesh.shape)} }) — "
            "a pipeline needs a 'stage' rule naming an axis of size > 1; "
            "build the mesh with pipe>1 or retable 'stage'")
    kw.setdefault("num_stages", part.mesh.get_dim_size(axis))
    kw.setdefault("param_spec", part.param_spec)
    mesh = part.mesh
    live = [n for n, s in zip(mesh.dim_names, mesh.shape) if int(s) > 1]
    if live == [axis]:
        mesh = ProcessMesh(mesh=np.asarray(mesh.mesh).reshape(-1), dim_names=[axis])
    return PipelineParallel(first, layers, last, loss_fn, mesh=mesh, axis_name=axis, **kw)
