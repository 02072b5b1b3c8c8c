"""``paddle.distributed.fleet`` of the port: so far only
:mod:`~paddle_tpu_torch.distributed.fleet.sequence_parallel`'s ring
context attention."""

from . import sequence_parallel  # noqa: F401
from .sequence_parallel import ring_context_attention

__all__ = ["sequence_parallel", "ring_context_attention"]
