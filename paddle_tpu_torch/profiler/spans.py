"""Low-overhead span tracing: the timeline tier (counterpart of
``paddle_tpu/profiler/spans.py``).

Every phase boundary the port owns (``TrainStep``'s ``jit.dispatch``, the
loader's ``dataload.fetch``, the optimizer's ``opt.step``, serving's
admit, prefill, decode dispatch and sync, the speculative draft and
verify) records a *span* (begin timestamp, duration, thread, step,
attributes) into a preallocated per-process ring:

- ``with span("name", step=n, **attrs): ...``: enter and exit touch a
  thread-local stack and ``perf_counter`` only; one small dict is stored
  into a ring slot at exit, under the ring's lock.
- default-on, like the telemetry registry; ``PADDLE_SPANS=0`` (or
  ``PADDLE_TELEMETRY=0``) turns spans into no-ops.
- a span that never exits (a hang inside its body) is not in the ring.

Every span has a process-unique id (``sid``); a flight-recorder entry
recorded while a span is open carries the innermost open span's id
(:func:`current_id`).

Timestamps are host ``perf_counter`` readings, converted to absolute
epoch microseconds through one per-process anchor captured at import, so
per-rank exports share the machine's wall clock. They time the host: a
span around an eager CUDA call closes when the call is enqueued, not when
the device is done.

While a :class:`paddle_tpu_torch.profiler.Profiler` records, each span
also opens a ``torch.profiler.record_function`` range of its name, so the
device kernels launched inside it can be found under it in the trace
(``Profiler.device_trace_summary``).

Env flags:
- PADDLE_SPAN_BUFFER   ring capacity (default 4096 spans)
- PADDLE_SPANS=0       disable span capture (counters stay on)
- PADDLE_TRACE_DIR     default export directory (timeline.py)
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from . import telemetry

__all__ = ["Span", "span", "event", "SpanRing", "ring", "current_id",
           "entries", "clear", "enabled", "ANCHOR_EPOCH_US",
           "ANCHOR_PERF_US", "epoch_us", "annotate"]

# one per-process wall-clock anchor: span timestamps are perf_counter
# reads (monotonic, ns resolution) shifted onto the epoch through this
# pair, so every span in a process shares one consistent clock
ANCHOR_EPOCH_US = time.time() * 1e6
ANCHOR_PERF_US = time.perf_counter() * 1e6


def epoch_us(perf_s: float) -> float:
    """Map a ``perf_counter()`` reading (seconds) onto absolute epoch
    microseconds via the process anchor."""
    return ANCHOR_EPOCH_US + (perf_s * 1e6 - ANCHOR_PERF_US)


#: set by a recording Profiler: spans then open record_function ranges
_annotate = False


def annotate(on: bool) -> None:
    """While ``on``, every span also opens a ``torch.profiler``
    ``record_function`` range of its name (a recording Profiler sets it)."""
    global _annotate
    _annotate = bool(on)


_enabled_cache: bool | None = None
_enabled_uses = 0
# environ reads cost ~1us each, too much for a per-span check. The
# resolved flag is cached and re-read every
# _RECHECK_EVERY enters, so a mid-process env flip still lands (within
# 256 spans); tests flipping PADDLE_SPANS call enabled(refresh=True).
_RECHECK_EVERY = 256


def enabled(refresh: bool = False) -> bool:
    """Spans are DEFAULT-ON; PADDLE_SPANS=0 (or the global
    PADDLE_TELEMETRY=0) disables capture. The env is re-read every
    :data:`_RECHECK_EVERY` calls (or on ``refresh=True``) — the steady
    state pays a counter bump, not an environ read."""
    global _enabled_cache, _enabled_uses
    _enabled_uses += 1
    if (_enabled_cache is None or refresh
            or _enabled_uses >= _RECHECK_EVERY):
        _enabled_uses = 0
        _enabled_cache = (
            os.environ.get("PADDLE_SPANS", "1").lower()
            not in ("0", "false", "off")
            and telemetry.enabled())
    return _enabled_cache


def _default_capacity() -> int:
    try:
        return max(16, int(os.environ.get("PADDLE_SPAN_BUFFER", "4096")))
    except ValueError:
        return 4096


_ids = itertools.count(1)      # 0 is reserved for "no span"
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_id() -> int | None:
    """Innermost OPEN span's id on this thread (the flight-recorder
    correlation hook), or None outside any span."""
    s = getattr(_tls, "stack", None)
    return s[-1].sid if s else None


class SpanRing:
    """Preallocated bounded ring of completed spans (one dict per slot).
    Normally used via the module singleton (:func:`ring`); tests build
    their own for wrap/clear checks."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity if capacity is not None else _default_capacity()
        self._slots: list = [None] * self.capacity
        self._n = 0          # total spans ever stored
        self._lock = threading.Lock()
        self.dropped = 0     # spans overwritten by ring wrap

    def store(self, entry: dict) -> None:
        with self._lock:
            slot = self._n % self.capacity
            if self._slots[slot] is not None:
                self.dropped += 1
            self._slots[slot] = entry
            self._n += 1

    def entries(self) -> list:
        """Live spans ordered by begin timestamp (oldest survivor first)."""
        with self._lock:
            live = [e for e in self._slots if e is not None]
        return sorted(live, key=lambda e: (e["ts_us"], e["sid"]))

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._n = 0
            self.dropped = 0


_ring: SpanRing | None = None
_ring_lock = threading.Lock()


def ring() -> SpanRing:
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = SpanRing()
    return _ring


def entries() -> list:
    return ring().entries()


def clear() -> None:
    ring().clear()


class Span:
    """One timed region. Use via the ``span(...)`` alias as a context
    manager; ``set(**attrs)`` adds attributes while open (e.g. a dispatch
    span marking ``traced=True`` after the fact), ``elapsed_us()`` reads
    the running duration (goodput attribution of an in-flight phase)."""

    __slots__ = ("name", "step", "attrs", "sid", "parent", "_t0", "_rf")

    def __init__(self, name: str, step: int | None = None, **attrs):
        self.name = name
        self.step = step
        self.attrs = attrs or None
        self.sid = 0          # 0 = disabled / not yet entered
        self.parent = None
        self._t0 = 0.0
        self._rf = None

    def __enter__(self):
        if not enabled():
            return self
        stack = _stack()
        self.parent = stack[-1].sid if stack else None
        self.sid = next(_ids)
        stack.append(self)
        if _annotate:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs) -> None:
        if self.sid:
            if self.attrs is None:
                self.attrs = attrs
            else:
                self.attrs.update(attrs)

    def elapsed_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6 if self.sid else 0.0

    def __exit__(self, exc_type, exc, tb):
        if not self.sid:
            return False
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:   # out-of-order exit (generator misuse): heal
            stack.remove(self)
        if exc_type is not None:
            self.set(error=f"{exc_type.__name__}: {exc}")
        ring().store({
            "sid": self.sid, "parent": self.parent, "name": self.name,
            "ts_us": epoch_us(self._t0),
            "dur_us": round((t1 - self._t0) * 1e6, 1),
            "tid": threading.get_native_id(), "step": self.step,
            "attrs": self.attrs,
        })
        return False


#: the public spelling: ``with span("forward", step=n): ...``
span = Span


def event(name: str, step: int | None = None, **attrs) -> int:
    """Instant (zero-duration) timeline marker: evictions, retirements. Returns the span id (0 when disabled)."""
    if not enabled():
        return 0
    sid = next(_ids)
    ring().store({
        "sid": sid, "parent": current_id(), "name": name,
        "ts_us": epoch_us(time.perf_counter()), "dur_us": 0.0,
        "tid": threading.get_native_id(), "step": step,
        "attrs": attrs or None,
    })
    return sid
