"""The partitioning tier (counterpart of
``paddle_tpu/distributed/partitioning/``): the logical-axis rule table
(:mod:`.rules`), the :class:`Partitioner` that resolves it against a mesh
and shards a model (:mod:`.partitioner`), :class:`PartitionedTrainStep`
(:mod:`.train_step`), its checkpoints (:mod:`.checkpoint`) and the
``stage`` rule's pipeline (:mod:`.pipeline`: ``pipeline_from_rules``,
``resolve_stage_axis``). The lint and the planner wait for a later
slice."""

from .checkpoint import MANIFEST_NAME, load_partitioned, read_sharding_manifest, save_partitioned
from .partitioner import Partitioner
from .pipeline import pipeline_from_rules, resolve_stage_axis
from .rules import (DEFAULT_RULES, PartitionSpec, RuleConflictError, RuleTable, mark_logical,
                    validate_rules)
from .train_step import PartitionedTrainStep

__all__ = ["DEFAULT_RULES", "PartitionSpec", "RuleConflictError", "RuleTable", "mark_logical",
           "validate_rules", "Partitioner", "PartitionedTrainStep", "MANIFEST_NAME",
           "save_partitioned", "load_partitioned", "read_sharding_manifest",
           "pipeline_from_rules", "resolve_stage_axis"]
