"""Distributed checkpoints with reshard on load (counterpart of
``paddle_tpu/distributed/checkpoint/``): :mod:`.save_load`."""

from .save_load import CheckpointCorruptError, load_state_dict, save_state_dict, wait_async_save

__all__ = ["CheckpointCorruptError", "load_state_dict", "save_state_dict", "wait_async_save"]
