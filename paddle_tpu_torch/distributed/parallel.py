"""``paddle.distributed.parallel`` (counterpart of
``paddle_tpu/distributed/parallel.py``): ``DataParallel`` and
``init_parallel_env``, whose homes are :mod:`.data_parallel` and
:mod:`.env`."""

from .data_parallel import DataParallel
from .env import init_parallel_env

__all__ = ["DataParallel", "init_parallel_env"]
