"""``paddle.hapi`` of the port (counterpart of ``paddle_tpu/hapi``): the
high-level ``Model`` (fit / evaluate / predict over ``TrainStep`` and
``EvalStep``), its callbacks and ``summary``."""

from .callbacks import (Callback, EarlyStopping, ModelCheckpoint, ProgBarLogger, VisualDL)
from .callbacks import LRScheduler as LRSchedulerCallback
from .model import Model
from .summary import summary

__all__ = ["Callback", "EarlyStopping", "LRSchedulerCallback", "ModelCheckpoint",
           "ProgBarLogger", "VisualDL", "Model", "summary"]
