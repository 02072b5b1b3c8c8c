"""Training and evaluation steps of the port (counterpart of
``paddle_tpu/jit``)."""

from .training import EvalStep, TrainStep

__all__ = ["EvalStep", "TrainStep"]
