"""``PartitionedTrainStep``: ``TrainStep`` over a model the rule table
shards (counterpart of
``paddle_tpu/distributed/partitioning/train_step.py:25-152``).

The model is sharded at construction (:meth:`Partitioner.shard_model`:
the ``fsdp`` slices at rest, each decoder layer's slices all-gathered just
before it runs and its gradients reduce-scattered to them; the ``tensor``
slices resident, the model computing on them through Megatron's
collectives). A call takes the global batch (every tensor leads with it,
divisible by :meth:`Partitioner.data_axis_size`), runs this rank's rows
of it (the ``("dp", "fsdp")`` data axes; the tensor ranks of a data rank
run the same rows), and returns the global mean loss. The gradients that
are partial across the tensor ranks are summed inside the step. The
update is the fused kernel over this rank's slices (one launch for up to
128 tensors), after the global-norm clip summed the squared norms of the
slices over the groups that cut them. The optimizer state lives on the slices
only. A Mixture-of-Experts layer routes the global batch and keeps its
experts as resident slices (``fleet.moe``; their gradients complete
after the all-to-all's backward). Under ``recompute_policy`` the gathers run again in the backward
(they sit inside the recomputed blocks); without one, autograd keeps the
gathered parameters its backward reads.

The numerics sentinels read the gradients after the step's reduction
(each rank its slices, the per-tensor statistics summed over the ranks
whose slices make the whole tensor) and the global mean loss, so
``train.loss``, ``train.grad_norm``, the digest and the watchdog's events
are the same on every rank, those of the reference's one program.
"""

from __future__ import annotations

import torch

from ...jit.training import TrainStep
from .. import collective as _c
from ..fleet.sharding import GroupShardedOptimizer
from .partitioner import Partitioner

__all__ = ["PartitionedTrainStep"]


class PartitionedTrainStep(TrainStep):
    """``TrainStep`` whose model and optimizer state are sharded by
    ``partitioner`` (a :class:`Partitioner` over the current mesh when
    None)."""

    def __init__(self, model, optimizer, loss_fn, partitioner: Partitioner | None = None, **kw):
        self._partitioner = partitioner if partitioner is not None else Partitioner()
        self._partitioner.shard_model(model)
        super().__init__(model, GroupShardedOptimizer(optimizer, self._partitioner.update),
                         loss_fn, **kw)

    @property
    def partitioner(self) -> Partitioner:
        return self._partitioner

    def __call__(self, *batch):
        part = self._partitioner
        local = [part.shard_batch(t) if torch.is_tensor(t) and t.ndim else t for t in batch]
        return super().__call__(*local)

    def _global_loss(self, loss):
        """The mean of the data ranks' losses: what the call returns, and
        what the numerics plane publishes and watches."""
        loss = loss.clone()
        _c.all_reduce(loss, group=self._partitioner.update.data_group)
        return loss / self._partitioner.data_axis_size()
