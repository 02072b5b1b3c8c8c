"""``paddle.distributed.fleet`` of the port, for one device so far:
:mod:`~paddle_tpu_torch.distributed.fleet.sequence_parallel`'s ring
context attention and :mod:`~paddle_tpu_torch.distributed.fleet.moe`'s
Mixture-of-Experts layer."""

from . import moe, sequence_parallel  # noqa: F401
from .moe import MoELayer
from .sequence_parallel import ring_context_attention

__all__ = ["moe", "sequence_parallel", "MoELayer", "ring_context_attention"]
