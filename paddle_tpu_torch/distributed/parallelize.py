"""``dist.parallelize`` (counterpart of
``paddle_tpu/distributed/parallelize.py:24-123``).

``parallelize(model, optimizer, mesh, config)`` makes ``mesh`` current and
applies ``config["sharding_config"]["stage"]`` (1, 2 or 3) over the mesh's
``sharding`` axis, as ``fleet.group_sharded_parallel`` does: stage 3 cuts
each parameter on its largest dim the axis divides (the reference's
``parallelize.py:65-75``), stages 1 and 2 on the first. A mesh with a
tensor axis above 1 (or ``mp_config``) cuts each parameter by its marks
(``shard_axes``: a dim on the mesh's tensor axis, ``mp`` / ``model`` /
``tensor``, where the axis divides it, as the reference's
:func:`param_spec`) and hands the axis to the model
(``distributed.tensor_parallel``); the gradients are averaged over the
mesh's data axes in the sharded update. Beside it a sharding stage keeps
at 1 and 2 each parameter's optimizer state on its slice of the
``sharding`` axis (of the rank's tensor slice), and at 3 cuts every
parameter that the tensor axis does not on its largest dim over
``sharding``, at rest (the reference's ``parallelize.py:44-85``). A
Mixture-of-Experts model on a mesh with ``ep`` or, across processes, a
data axis above 1 is planned the same way (:func:`plan_tensor`): its
experts on ``ep`` if the mesh names it, else on ``dp`` (the reference's
``parallelize.py:24-41`` preference), else whole on every rank (a
sharding stage then cuts them, or their state, as any parameter),
routing over the global batch of the data axes (``fleet.moe``). With an
optimizer it returns ``(model, optimizer)``, the optimizer a
``fleet.sharding.GroupShardedOptimizer`` when a stage or ``mp_config``
applies. A context-parallel axis across processes (``sep``: each rank on
its positions of the sequence, the gradients partial there) is summed
over inside the sharded update, beside the data axes' mean; without a
stage or a tensor axis the model's gradients are summed over it and
averaged over the data axes (``data_parallel.sum_over_context``: the
model's ``reduce_gradients``, which ``TrainStep`` calls). A mesh of one
process with a ``sep`` axis (the one-process ring) changes no parameter. ``dp_config`` and ``pp_config`` are taken and
read no further, as in the reference (a pipeline is built with
``fleet.PipelineParallel`` or ``partitioning.pipeline_from_rules``).

:func:`shard_dataloader` gives each rank its part of every batch: the rows
of dim 0 that its coordinates on the mesh's data axes (``dcn``, ``dp``,
``sharding``) select.
"""

from __future__ import annotations

import torch

from .mesh import ProcessMesh, get_mesh, set_mesh

__all__ = ["param_spec", "parallelize", "ShardDataloader", "shard_dataloader"]


def param_spec(param, mesh: ProcessMesh, extra_axes=()):
    """The placement of ``param`` from its ``shard_axes`` ({dim: axis or
    axes in order of preference}): the first axis the mesh has above 1
    that divides the dim."""
    from .partitioning.rules import PartitionSpec

    shape = tuple(param.shape)
    units = getattr(param, "logical_units", None)
    if units is not None:
        shape = tuple(n if u is None else u for n, u in zip(shape, units))
    spec = [None] * len(shape)
    for dim, names in (getattr(param, "shard_axes", None) or {}).items():
        for name in names if isinstance(names, (list, tuple)) else (names,):
            if name in mesh.dim_names and mesh.get_dim_size(name) > 1 \
                    and shape[int(dim)] % mesh.get_dim_size(name) == 0:
                spec[int(dim)] = name
                break
    return PartitionSpec(*spec)


def parallelize(model, optimizer=None, mesh: ProcessMesh | None = None, config=None):
    """See the module docstring."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("parallelize needs a mesh (dist.auto_mesh / set_mesh)")
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"parallelize takes a ProcessMesh, got {type(mesh).__name__}")
    set_mesh(mesh)
    config = config or {}
    stage = int((config.get("sharding_config") or {}).get("stage", 0))
    from .mesh import TENSOR_AXES

    tensor = any(a in mesh.dim_names and mesh.get_dim_size(a) > 1 for a in TENSOR_AXES)
    if config.get("mp_config") is not None or tensor or _expert_parallel(model, mesh):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding stage {stage}: one of 1, 2, 3")
        if stage and "sharding" not in mesh.dim_names:
            raise ValueError(f"sharding stage {stage} needs a 'sharding' axis on {mesh}")
        update = plan_tensor(model, mesh, stage)
        if optimizer is not None:
            from .fleet.sharding import GroupShardedOptimizer

            optimizer = GroupShardedOptimizer(optimizer, update)
    elif stage:
        if stage not in (1, 2, 3):
            raise ValueError(f"sharding stage {stage}: one of 1, 2, 3")
        if "sharding" not in mesh.dim_names:
            raise ValueError(f"sharding stage {stage} needs a 'sharding' axis on {mesh}")
        from .fleet.sharding import GroupShardedOptimizer, data_groups, plan

        shard, replicas, whole, n = data_groups(mesh)
        update = plan(model.parameters(), stage, shard, replicas, whole, n, model)
        if optimizer is not None:
            optimizer = GroupShardedOptimizer(optimizer, update)
    else:
        from .mesh import context_axes

        if context_axes(mesh):
            from .data_parallel import sum_over_context

            sum_over_context(model)
    return (model, optimizer) if optimizer is not None else model


def stage3_specs(params, specs: dict, mesh: ProcessMesh) -> None:
    """Stage 3 beside the tensor axis (the reference's
    ``parallelize.py:65-75``): a parameter whose spec cuts nothing is cut on
    its largest dim that the ``sharding`` axis divides."""
    from . import _sharded
    from .partitioning.rules import PartitionSpec

    if "sharding" not in mesh.dim_names or mesh.get_dim_size("sharding") < 2:
        return
    for p in params:
        spec = specs[id(p)]
        if _sharded.info_of(p) is None and all(e is None for e in spec):
            d = _sharded.divisible_dim(tuple(p.shape), mesh.get_dim_size("sharding"),
                                       largest=True)
            if d is not None:
                specs[id(p)] = PartitionSpec(*["sharding" if i == d else None
                                               for i in range(len(spec))])


def _expert_parallel(model, mesh: ProcessMesh) -> bool:
    """Whether ``model`` holds a Mixture-of-Experts layer and ``mesh`` an
    ``ep`` axis or, across processes, a data axis above 1."""
    from . import env as _env
    from .fleet.moe import MoELayer
    from .fleet.sharding import DATA_AXES

    if not any(isinstance(m, MoELayer) for m in model.modules()):
        return False
    axes = ("ep",) + (DATA_AXES if _env.get_world_size() > 1 else ())
    return any(a in mesh.dim_names and mesh.get_dim_size(a) > 1 for a in axes)


def plan_tensor(model, mesh: ProcessMesh, stage: int = 0):
    """Cut ``model`` over ``mesh``'s tensor axis by its parameters' marks
    (see the module docstring), beside the sharding ``stage`` (0: none);
    returns its ``ShardedUpdate``. A Mixture-of-Experts model's experts go
    on ``ep`` where the mesh has it (the axis of the layers' ``f`` and
    ``g``; its ranks hold the same rows), else on ``dp`` (resident slices
    reached by the all-to-all), and every layer routes over the global
    batch of the data axes."""
    from . import _sharded
    from .fleet.sharding import DATA_AXES
    from .mesh import TENSOR_AXES

    axis = next((a for a in TENSOR_AXES if a in mesh.dim_names and mesh.get_dim_size(a) > 1),
                None)
    if "ep" in mesh.dim_names and mesh.get_dim_size("ep") > 1:
        if axis is not None:
            raise NotImplementedError(f"an ep axis beside the tensor axis {axis!r} on {mesh}: "
                                      "the port places the experts on one resident axis")
        axis = "ep"
    elif axis is None and _expert_parallel(model, mesh):
        axis = "ep"                     # absent or 1: the experts over dp, if anywhere
    if axis is None:
        raise ValueError(f"mp_config needs a tensor axis ({', '.join(TENSOR_AXES)}) above 1 "
                         f"on {mesh}")
    params = list(model.parameters())
    specs = {id(p): param_spec(p, mesh) for p in params}
    if stage == 3:
        stage3_specs(params, specs, mesh)
    return _sharded.plan_specs(model, mesh, specs,
                               tuple(a for a in mesh.dim_names if a in DATA_AXES), axis,
                               stage=stage or 3)


class ShardDataloader:
    """``dist.shard_dataloader``: each batch's tensors cut along dim 0 to
    this rank's rows (see the module docstring)."""

    def __init__(self, dataloader, meshes=None, shard_dims=None, input_keys=None,
                 dense_tensor_idx=None):
        self.dataloader = dataloader
        self.mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
        self.shard_dims = shard_dims

    def _part(self):
        from .fleet.sharding import DATA_AXES

        mesh = self.mesh or get_mesh()
        if mesh is None:
            return 0, 1
        axes = [n for n in mesh.dim_names if n in DATA_AXES[:3]]
        coord = mesh.coordinate()
        index, size = 0, 1
        for a in axes:
            index = index * mesh.get_dim_size(a) + coord[a]
            size *= mesh.get_dim_size(a)
        return index, size

    def _shard(self, t, index, size):
        if not torch.is_tensor(t) or t.ndim == 0 or size == 1:
            return t
        if t.shape[0] % size:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over {size} "
                             "data ranks")
        n = t.shape[0] // size
        return t[index * n:(index + 1) * n]

    def __iter__(self):
        index, size = self._part()
        for batch in self.dataloader:
            if isinstance(batch, (list, tuple)):
                yield type(batch)(self._shard(b, index, size) for b in batch)
            elif isinstance(batch, dict):
                yield {k: self._shard(v, index, size) for k, v in batch.items()}
            else:
                yield self._shard(batch, index, size)

    def __len__(self):
        return len(self.dataloader)


def shard_dataloader(dataloader, meshes=None, shard_dims=None, input_keys=None,
                     dense_tensor_idx=None):
    return ShardDataloader(dataloader, meshes, shard_dims, input_keys, dense_tensor_idx)
