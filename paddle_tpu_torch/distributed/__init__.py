"""``paddle.distributed`` of the port (counterpart of
``paddle_tpu/distributed/__init__.py:13-38``).

One process a device, as Paddle runs: the environment
(``init_parallel_env``, ``get_rank``, ``get_world_size``, ``ParallelEnv``),
the launcher (``python -m paddle_tpu_torch.distributed.launch``) and
``spawn``, the collectives over ``torch.distributed`` (NCCL on the card,
gloo on the CPU), ``DataParallel`` with its bucketed reducer, the mesh
(``ProcessMesh`` and the meshes of fleet and of the partitioning tier),
``parallelize`` with the ZeRO stages, ``shard_dataloader``, activation
recompute, sharded checkpoints (:mod:`.checkpoint`), the partitioning tier
(:mod:`.partitioning`: dp x fsdp x tensor), tensor parallelism
(:mod:`.tensor_parallel`), the semi-auto API (:mod:`.api`: ``shard_tensor``,
``reshard``, the placements) and :mod:`.fleet` (``fleet.init``, the
topology, the mp layers, Megatron's sequence parallelism,
``group_sharded_parallel``, the ring's context attention on one device,
the Mixture-of-Experts layer and the pipeline: the schedules,
``PipelineParallel``, ``PipelineLayer`` and ``pipeline_apply`` over a
``pp`` / ``pipe`` axis beside the data, tensor, sharding and sep axes;
context parallelism across processes; expert parallelism: the MoE layer
routing the global batch, its experts over ``dp`` through the all-to-all
or over ``tensor`` / ``ep`` with partial sums).
"""

from . import checkpoint, env, fleet, partitioning, resilience, tensor_parallel  # noqa: F401
from .api import (DistAttr, Partial, Placement, Replicate, Shard, dtensor_from_fn,
                  placements_to_spec, reshard, shard_layer, shard_tensor, sharding_constraint,
                  unshard_dtensor)
from .collective import (P2POp, ReduceOp, Group, all_gather, all_gather_object, all_reduce,
                         all_to_all, all_to_all_single, barrier, batch_isend_irecv, broadcast,
                         broadcast_object_list, destroy_process_group, fused_allreduce, gather,
                         get_group, irecv, isend, new_group, recv, reduce, reduce_scatter,
                         scatter, send, split_group, wait)
from .data_parallel import DataParallel
from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized
from .mesh import (ProcessMesh, auto_mesh, build_program_mesh, get_mesh, init_hybrid_mesh,
                   init_mesh_from_topology, set_mesh)
from .parallelize import ShardDataloader, parallelize, shard_dataloader
from .recompute import recompute, recompute_sequential
from .spawn import spawn

__all__ = ["ProcessMesh", "auto_mesh", "get_mesh", "set_mesh", "init_hybrid_mesh",
           "init_mesh_from_topology", "build_program_mesh", "parallelize", "ShardDataloader",
           "shard_dataloader", "fleet", "checkpoint", "partitioning", "env", "recompute",
           "recompute_sequential", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "spawn", "DataParallel", "ReduceOp", "Group",
           "P2POp", "new_group", "get_group", "split_group", "all_reduce", "all_gather",
           "all_gather_object", "reduce_scatter", "all_to_all", "all_to_all_single",
           "broadcast", "broadcast_object_list", "reduce", "scatter", "gather", "send", "recv",
           "isend", "irecv", "batch_isend_irecv", "barrier", "wait", "fused_allreduce",
           "destroy_process_group", "tensor_parallel", "Placement", "Shard", "Replicate",
           "Partial", "DistAttr", "placements_to_spec", "shard_tensor", "reshard",
           "dtensor_from_fn", "unshard_dtensor", "shard_layer", "sharding_constraint"]
