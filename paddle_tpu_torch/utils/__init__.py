"""Utilities of the port (counterpart of ``paddle_tpu/utils``): the
``LogWriter`` that the ``VisualDL`` callback writes with."""

from .log_writer import LogWriter

__all__ = ["LogWriter"]
