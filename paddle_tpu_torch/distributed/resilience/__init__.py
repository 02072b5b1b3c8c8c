"""Resilience of the port (counterpart of
``paddle_tpu/distributed/resilience``): so far the numerics watchdog's
detectors (:mod:`.watchdog`). Chaos injection, retry, verified
checkpoints, preemption, the readiness handshake and the straggler
detector come with the resilience slice."""

from . import watchdog  # noqa: F401
from .watchdog import NumericsWatchdog, spike_sigma  # noqa: F401

__all__ = ["watchdog", "NumericsWatchdog", "spike_sigma"]
