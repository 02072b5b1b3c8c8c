"""NaN / loss-spike watchdog (counterpart of
``paddle_tpu/distributed/resilience/watchdog.py``, its detectors).

A host-side state machine over the numerics sentinels
(``profiler/numerics.py``). Two detectors:

- **nonfinite**: any NaN/Inf count in loss, gradients or parameters fires
  at once, naming the offending tensor group(s) (the per-group counts make
  this exact);
- **loss spike**: a robust z-score over a rolling loss window (median /
  MAD, so one spike cannot poison its own baseline) clears
  ``PADDLE_SPIKE_SIGMA`` (default 6; 0 disables). The window only absorbs
  losses judged healthy.

On an event: a flight-ring record and dump (kind ``numerics``) with the
offending step and groups named, a ``train.numerics_events{kind}``
counter, and the handling's wall time booked as
``goodput.lost_us{reason=numerics}``.

The reference's rollback (``PADDLE_NUMERICS_ROLLBACK=1``: restore the last
verified checkpoint through the autopilot's decision barrier, with a
rollback intent exchanged over the rendezvous store) needs
``distributed.resilience.verified`` and ``autopilot.decision``, which come
with later slices of the port: asking for it raises
``NotImplementedError``. Without it no store is read, so the store of the
launcher's environment is ``None`` in every process here.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque

__all__ = ["NumericsWatchdog", "spike_sigma"]


def spike_sigma() -> float:
    try:
        return float(os.environ.get("PADDLE_SPIKE_SIGMA", "6"))
    except ValueError:
        return 6.0


def _rollback_enabled() -> bool:
    return os.environ.get("PADDLE_NUMERICS_ROLLBACK", "").lower() in (
        "1", "true", "on")


def _store_from_env():
    """(store, rank, world) for the rollback intent exchange: ``None``.
    The store is read only in rollback mode, which comes with the
    resilience slice, so no process of the port opens one here."""
    return None


def _refuse_rollback():
    raise NotImplementedError(
        "PADDLE_NUMERICS_ROLLBACK=1 comes with the port's distributed.resilience.verified "
        "and autopilot.decision modules (the verified checkpoint and the decision "
        "barrier the rollback restores through)")


class NumericsWatchdog:
    """Per-process watchdog endpoint; ``observe(step, loss, sent)`` is
    the only hot-path call (a few float compares on the healthy path)."""

    #: healthy appends between median/MAD refreshes: the robust stats
    #: summarize the whole window and move slowly, so they are recomputed
    #: every 16 appends, not every step
    STATS_REFRESH = 16

    def __init__(self, train_step=None, sigma: float | None = None,
                 window: int | None = None, min_window: int = 8,
                 rollback: bool | None = None, root: str | None = None,
                 store=None, rank: int = 0, world: int = 1):
        self.train_step = train_step
        self.sigma = sigma if sigma is not None else spike_sigma()
        self.window = window if window is not None else max(
            int(os.environ.get("PADDLE_SPIKE_WINDOW", "32") or 32), 2)
        self.min_window = min_window
        self.rollback_enabled = (rollback if rollback is not None
                                 else _rollback_enabled())
        if self.rollback_enabled:
            _refuse_rollback()
        self.root = root
        if store is not None:
            self._store, self.rank, self.world = store, int(rank), int(world)
        else:
            env = _store_from_env()
            self._store, self.rank, self.world = env if env else (None, 0, 1)
        self._losses: deque = deque(maxlen=self.window)
        self._stats: tuple | None = None  # cached (median, scale)
        # start at the refresh threshold so the first refresh fires on
        # the first append at/after min_window
        self._stats_age = self.STATS_REFRESH
        # spike threshold in LOSS units (median + sigma*scale, from the
        # cached stats): the healthy check is one float compare; inf until
        # the window fills
        self._spike_hi = float("inf")
        self.last_event: dict | None = None
        self.events = 0

    # -- detection --------------------------------------------------------

    def _refresh_stats(self) -> tuple:
        xs = sorted(self._losses)
        n = len(xs)
        med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
        dev = sorted(abs(x - med) for x in xs)
        mad = dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1]
                                               + dev[n // 2])
        self._stats = (med, 1.4826 * mad + 1e-12)
        self._stats_age = 0
        if self.sigma > 0 and n >= self.min_window:
            self._spike_hi = med + self.sigma * self._stats[1]
        return self._stats

    def z_score(self, loss: float) -> float | None:
        """Robust z of ``loss`` against the rolling window (median /
        1.4826*MAD, refreshed every STATS_REFRESH healthy appends);
        None until ``min_window`` healthy losses exist."""
        if len(self._losses) < self.min_window:
            return None
        stats = self._stats
        if stats is None or self._stats_age >= self.STATS_REFRESH:
            stats = self._refresh_stats()
        return (loss - stats[0]) / stats[1]

    def observe(self, step: int, loss: float, sent: dict | None = None):
        """Feed one completed step's loss and fetched sentinel dict; returns
        the event dict when one fired (handled in line), else None."""
        loss = float(loss)
        sent = sent if sent is not None else {}
        nf = sent.get("nonfinite")
        if nf is None:  # hand-built dicts without the derived total
            nf = (sent.get("loss_nonfinite") or sent.get("grad_nonfinite")
                  or sent.get("param_nonfinite"))
        if not nf and math.isfinite(loss):
            # the spike check is one compare against the threshold in loss
            # units (loss > median + sigma*scale <=> z > sigma)
            if loss <= self._spike_hi:
                losses = self._losses
                age = self._stats_age
                if age >= self.STATS_REFRESH \
                        and len(losses) >= self.min_window:
                    self._refresh_stats()
                    age = 0
                losses.append(loss)
                self._stats_age = age + 1
                return None
            stats = self._stats
            event = {"kind": "spike", "step": int(step), "loss": loss,
                     "z": round((loss - stats[0]) / stats[1], 3),
                     "sigma": self.sigma}
        else:
            from ...profiler import numerics as _numerics

            event = {"kind": "nonfinite", "step": int(step), "loss": loss,
                     "groups": _numerics.nonfinite_groups(sent),
                     "loss_nonfinite": int(sent.get("loss_nonfinite") or 0),
                     "grad_nonfinite": int(sent.get("grad_nonfinite") or 0),
                     "param_nonfinite": int(
                         sent.get("param_nonfinite") or 0)}
        self._handle(event)
        return event

    # -- event handling ---------------------------------------------------

    def _handle(self, event: dict) -> None:
        from ...profiler import goodput as _goodput
        from ...profiler import telemetry as _telemetry

        t0 = time.perf_counter()
        self.events += 1
        self.last_event = event
        _telemetry.counter("train.numerics_events",
                           kind=event["kind"]).bump()
        try:
            from ...profiler import flight_recorder as _flight

            _flight.recorder().record("numerics", op="train.sentinel",
                                      extra=event)
            _flight.dump(reason=f"numerics:{event['kind']}")
        except Exception:
            pass
        _goodput.note_loss("numerics", (time.perf_counter() - t0) * 1e6,
                           site="train_step.numerics")
