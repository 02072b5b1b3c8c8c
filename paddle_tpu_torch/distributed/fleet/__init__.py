"""``paddle.distributed.fleet`` of the port (counterpart of
``paddle_tpu/distributed/fleet/__init__.py:27-176``).

``fleet.init(strategy=...)`` joins the process group, lays the world out
on ``strategy.hybrid_configs``' degrees (:class:`CommunicateTopology`),
makes every axis's group (:class:`HybridCommunicateGroup`) and makes the
topology's mesh current (its ``mp`` axis the model group).
``distributed_model`` wraps the model in ``DataParallel`` when the mode is
data parallel over more than one rank, shards it (stage 3) when
``sharding_configs["stage"]`` is 3, and at ``mp_degree`` above 1 (the
model-parallel mode, or the sharding mode beside it) cuts it over the
``mp`` axis by its marks, as the reference's ``parallelize``
(``parallelize(mp_config=..., sharding_config=...)``: at stages 1 and 2
the optimizer state on its slice of the ``sharding`` axis, at 3 the
parameters that ``mp`` does not cut kept at rest over it);
``distributed_optimizer`` carries ``gradient_merge``'s ``k_steps`` to
``TrainStep(accumulate_steps=)`` and, in the sharding mode, returns the
sharded optimizer (stage 1 or 2 from ``sharding_configs``, 3 after a
stage-3 model), and beside ``mp`` the optimizer over the cut model, which
averages over the data ranks and sums the gradients that are partial
across the model group. At ``pp_degree`` above 1 (the pipeline mode,
beside any of ``dp_degree``, ``sharding_degree`` and ``mp_degree``) the
mesh has its ``pp`` axis and ``distributed_model`` and
``distributed_optimizer`` return the model and the optimizer, as the
reference's: pipelines are built with :class:`PipelineParallel` or
``partitioning.pipeline_from_rules``, which place each rank's stages over
the ``mp`` and ``sharding`` axes (its optimizer state at the strategy's
sharding stage). At ``sep_degree`` above 1 (the segment-parallel mode:
each rank of the ``sep`` axis on its positions of the sequence)
``distributed_model`` returns :class:`SegmentParallel` (gradients summed
over ``sep``, averaged over the data ranks), or beside ``mp`` / a
sharding stage the cut or sharded model, whose update sums over ``sep``
too. ``localsgd`` waits for ``incubate.optimizer.LocalSGD``.

Also here: the tensor-parallel layers (:mod:`.mp_layers`),
:mod:`.sequence_parallel` (Megatron's sequence parallelism and the
ring's context attention), the Mixture-of-Experts layer (:mod:`.moe`;
across processes its experts cut over a data axis reached through
:mod:`._ep_a2a`'s all-to-all, or over the tensor axis), the pipeline (:mod:`.pipeline_parallel`: the
schedules and :class:`PipelineParallel`; :mod:`.pp_layers`;
:mod:`.pipeline_engine`), :mod:`.sharding`, :mod:`.topology` and
:mod:`.random`.
"""

from __future__ import annotations

from .. import env as _env
from ..mesh import set_mesh
from . import (moe, mp_layers, pipeline_engine, pipeline_parallel, pp_layers,  # noqa: F401
               random, sequence_parallel, sharding, topology)
from .moe import MoELayer
from .pipeline_engine import pipeline_apply, scan_layers, stack_stage_params
from .pipeline_parallel import (PipelineParallel, PipelineSchedule, build_pipeline_schedule,
                                gather_pipeline_tree, make_pipeline_step, schedule_cost,
                                verify_schedule)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy, ParallelLinear,
                        RowParallelLinear, VocabParallelEmbedding)
from .random import RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed
from .sequence_parallel import SegmentParallel, ring_context_attention
from .sharding import DygraphShardingOptimizer, group_sharded_parallel
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["moe", "mp_layers", "sequence_parallel", "sharding", "topology", "random",
           "MoELayer", "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "ParallelLinear",
           "ring_context_attention", "SegmentParallel", "DistributedStrategy", "Fleet", "fleet", "init",
           "distributed_model", "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker", "barrier_worker",
           "CommunicateTopology", "HybridCommunicateGroup", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "DygraphShardingOptimizer", "group_sharded_parallel", "pipeline_engine",
           "pipeline_parallel", "pp_layers", "pipeline_apply", "scan_layers",
           "stack_stage_params", "PipelineParallel", "PipelineSchedule",
           "build_pipeline_schedule", "gather_pipeline_tree", "make_pipeline_step",
           "schedule_cost", "verify_schedule", "LayerDesc", "PipelineLayer", "SharedLayerDesc"]


class DistributedStrategy:
    """``fleet.DistributedStrategy``: the hybrid degrees and the strategy
    switches Paddle's proto holds."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.find_unused_parameters = False
        self.tensor_parallel_configs = {}
        self.gradient_scale_configs = {"scale_strategy": "avg"}


class Fleet:
    """``fleet.Fleet``."""

    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._topology = None
        self._mesh = None
        self._model_update = None

    @property
    def _is_initialized(self) -> bool:
        return self._hcg is not None

    def init(self, role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
        """Join the world and lay it out (see the module docstring); a
        ``dp_degree`` of 1 that leaves ranks over takes them."""
        self._strategy = strategy or DistributedStrategy()
        _env.init_parallel_env()
        hc = self._strategy.hybrid_configs
        rest = [int(hc.get(k, 1)) for k in ("pp_degree", "sharding_degree", "sep_degree",
                                             "mp_degree")]
        dp = int(hc.get("dp_degree", 1))
        world = _env.get_world_size()
        others = rest[0] * rest[1] * rest[2] * rest[3]
        if dp * others != world and dp == 1 and world % others == 0:
            dp = world // others
        self._topology = CommunicateTopology(["data", "pipe", "sharding", "sep", "model"],
                                             [dp] + rest)
        self._hcg = HybridCommunicateGroup(self._topology)
        self._mesh = self._hcg.build_mesh()
        set_mesh(self._mesh)
        return self

    def _need_init(self):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init(...) first")

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    @property
    def worker_num(self):
        return _env.get_world_size()

    def worker_index(self):
        return _env.get_rank()

    def is_first_worker(self):
        return _env.get_rank() == 0

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    def _sharding_stage(self) -> int:
        return int((self._strategy.sharding_configs or {}).get("stage", 1))

    def distributed_model(self, model):
        """The model in the pipeline mode; at ``mp_degree`` above 1 the
        model on its slices of the ``mp`` axis (beside the sharding stage);
        ``DataParallel`` over the data group in the data-parallel mode with
        more than one rank; the model sharded when the strategy's sharding
        stage is 3; else the model."""
        self._need_init()
        hcg = self._hcg
        if hcg.get_parallel_mode() == "pipeline":
            return model
        if hcg.get_model_parallel_world_size() > 1:
            from ..parallelize import plan_tensor

            stage = self._sharding_stage() if hcg.get_sharding_parallel_world_size() > 1 else 0
            self._model_update = plan_tensor(model, self._mesh, stage)
            return model
        if hcg.get_parallel_mode() == "sharding_parallel" and self._sharding_stage() == 3:
            from .sharding import data_groups, plan

            shard, replicas, whole, n = data_groups(self._mesh)
            self._model_update = plan(model.parameters(), 3, shard, replicas, whole, n, model)
            return model
        if hcg.get_parallel_mode() == "segment_parallel":
            return SegmentParallel(model, hcg,
                                   find_unused_parameters=self._strategy.find_unused_parameters)
        if hcg.get_parallel_mode() == "data_parallel" and hcg.get_data_parallel_world_size() > 1:
            from ..data_parallel import DataParallel

            return DataParallel(model, group=hcg.get_data_parallel_group(),
                                find_unused_parameters=self._strategy.find_unused_parameters)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """The optimizer with the strategy's gradient merge (read by
        ``TrainStep``), sharded in the sharding mode."""
        ds = strategy or self._strategy
        if ds is not None and ds.localsgd:
            raise NotImplementedError("localsgd waits for the port's incubate.optimizer.LocalSGD")
        if ds is not None and ds.gradient_merge:
            cfg = ds.gradient_merge_configs or {}
            k = int(cfg.get("k_steps", 1))
            if k > 1:
                optimizer._accumulate_steps = k
                optimizer._accumulate_avg = bool(cfg.get("avg", True))
        mode = self._hcg.get_parallel_mode() if self._hcg is not None else None
        if mode in ("model_parallel", "sharding_parallel", "segment_parallel") \
                and self._hcg.get_model_parallel_world_size() > 1:
            from .sharding import GroupShardedOptimizer

            if self._model_update is None:
                raise ValueError("mp_degree above 1 cuts the model: call "
                                 "fleet.distributed_model(model) before distributed_optimizer")
            update, self._model_update = self._model_update, None
            optimizer = GroupShardedOptimizer(optimizer, update)
        elif mode == "sharding_parallel":
            from .sharding import GroupShardedOptimizer, data_groups, plan

            if self._model_update is not None:
                update, self._model_update = self._model_update, None
            elif self._sharding_stage() == 3:
                raise ValueError("sharding stage 3 cuts the model: call "
                                 "fleet.distributed_model(model) before distributed_optimizer")
            else:
                shard, replicas, whole, n = data_groups(self._mesh)
                update = plan(optimizer._parameter_list, self._sharding_stage(), shard,
                              replicas, whole, n)
            optimizer = GroupShardedOptimizer(optimizer, update)
        return optimizer


fleet = Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker


def worker_num():
    return _env.get_world_size()


def worker_index():
    return _env.get_rank()
