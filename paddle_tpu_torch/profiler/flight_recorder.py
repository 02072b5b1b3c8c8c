"""Flight recorder: a bounded per-rank ring of collective, phase and
numerics events, dumped to per-rank JSONL on a collective timeout, SIGTERM,
a numerics event or an explicit ``dump()`` (counterpart of
``paddle_tpu/profiler/flight_recorder.py``, in its dump format).

Each entry carries a global sequence number, and collective / p2p
entries a collective sequence number (``cseq``), the key on which the
per-rank streams of a hang are aligned. ``record()`` does no formatting
and no IO: it builds one small dict into a preallocated ring slot; the
stack summary is two frames of ``f_code.co_filename`` / ``f_lineno``
reads. ``PADDLE_TELEMETRY=0`` turns ``record()`` into a no-op.

Producers in the port: the numerics watchdog (``kind="numerics"``, then a
dump named ``numerics:<kind>``), the serving engine's NaN guard (a
``numerics`` record of the evicted lane) and ``amp``'s overflow
attribution. The collective and checkpoint producers come with the
resilience slice.

Env flags:
- PADDLE_FLIGHT_BUFFER   ring capacity (default 1024 entries)
- PADDLE_FLIGHT_DIR      dump directory (default <tmp>/paddle_flight)
- PADDLE_TELEMETRY=0     disables event capture (counters stay on)
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time

from . import spans as _spans
from . import telemetry

__all__ = ["FlightRecorder", "recorder", "record_collective", "phase",
           "dump", "dump_dir", "install_signal_handler",
           "on_collective_timeout", "load_dump"]

# entry kinds that carry the cross-rank collective sequence number (cseq),
# the alignment key; host-local events ride the same ring without one
_COLLECTIVE_KINDS = ("collective", "p2p")


def _default_capacity() -> int:
    try:
        return max(8, int(os.environ.get("PADDLE_FLIGHT_BUFFER", "1024")))
    except ValueError:
        return 1024


def dump_dir() -> str:
    d = os.environ.get("PADDLE_FLIGHT_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "paddle_flight")
    return d


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


def _stack_summary(depth: int = 3, skip: int = 2) -> str:
    """`file:line;file:line` of the caller's frames — raw frame-attribute
    reads, no traceback machinery. skip hops over the recorder's own
    frames."""
    parts = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ""
    while f is not None and len(parts) < depth:
        code = f.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{f.f_lineno}")
        f = f.f_back
    return ";".join(parts)


class FlightRecorder:
    """Per-process bounded event ring. Normally used via the module-level
    singleton (``recorder()``); tests construct their own for wrap/dump/
    restore checks."""

    def __init__(self, capacity: int | None = None, rank: int | None = None):
        self.capacity = capacity if capacity is not None else _default_capacity()
        self._slots: list = [None] * self.capacity   # preallocated ring
        self._seq = 0        # global event sequence (all kinds)
        self._cseq = 0       # collective/p2p sequence — the alignment key
        self._lock = threading.Lock()
        self.rank = rank if rank is not None else _rank()
        self.dropped = 0     # events overwritten by ring wrap

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, op: str = "", shapes=(), dtypes=(),
               axes=None, world=None, peer=None, duration_us=None,
               phase=None, extra=None, stack: bool = True) -> int:
        """Store one event; returns its global sequence number (-1 when
        telemetry is disabled). No formatting happens here — entries are
        serialized only at dump() time."""
        if not telemetry.enabled():
            return -1
        with self._lock:
            seq = self._seq
            self._seq += 1
            cseq = None
            if kind in _COLLECTIVE_KINDS:
                cseq = self._cseq
                self._cseq += 1
            slot = seq % self.capacity
            if self._slots[slot] is not None:
                self.dropped += 1
            self._slots[slot] = {
                "seq": seq, "cseq": cseq, "ts": time.time(),
                "rank": self.rank, "kind": kind, "op": op,
                "shapes": shapes, "dtypes": dtypes, "axes": axes,
                "world": world, "peer": peer, "duration_us": duration_us,
                "phase": phase, "extra": extra,
                # correlation id: the innermost open span on this thread,
                # so an entry can be found in the exported timeline
                "corr": _spans.current_id(),
                "stack": _stack_summary() if stack else "",
            }
        return seq

    def update_duration(self, seq: int, duration_us: float) -> None:
        """Patch an entry's duration after the timed body ran (entry-then-
        patch keeps the event visible even if the body hangs)."""
        if seq < 0:
            return
        with self._lock:
            e = self._slots[seq % self.capacity]
            if e is not None and e["seq"] == seq:
                e["duration_us"] = round(duration_us, 1)

    # -- reading -----------------------------------------------------------
    def entries(self) -> list:
        """Live entries in sequence order (oldest survivor first)."""
        with self._lock:
            live = [e for e in self._slots if e is not None]
        return sorted(live, key=lambda e: e["seq"])

    # -- dumping -----------------------------------------------------------
    def dump(self, path: str | None = None, reason: str = "explicit") -> str:
        """Write the ring to per-rank JSONL: one header line (rank,
        capacity, dropped count, reason) then one line per entry. Returns
        the path written. Safe to call from signal handlers (no locks held
        across IO beyond the snapshot)."""
        entries = self.entries()
        if path is None:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flight.{self.rank}.jsonl")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "header": True, "rank": self.rank, "reason": reason,
                "capacity": self.capacity, "dropped": self.dropped,
                "ts": time.time(), "pid": os.getpid(),
            }) + "\n")
            for e in entries:
                f.write(json.dumps(e, default=str) + "\n")
        os.replace(tmp, path)  # atomic: a reader never sees a half dump
        telemetry.counter("flight.dumps", reason=reason).bump()
        return path

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._seq = 0
            self._cseq = 0
            self.dropped = 0


def load_dump(path: str) -> tuple[dict, list]:
    """(header, entries) from a dump file: the restore half of the
    wrap/dump/restore contract."""
    header, entries = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("header"):
                header = rec
            else:
                entries.append(rec)
    entries.sort(key=lambda e: e["seq"])
    return header, entries


# -- module-level singleton + convenience hooks ----------------------------
_recorder: FlightRecorder | None = None
_rec_lock = threading.Lock()


def recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _rec_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_collective(op: str, shapes=(), dtypes=(), axes=None, world=None,
                      peer=None, kind: str = "collective") -> int:
    return recorder().record(kind, op=op, shapes=shapes, dtypes=dtypes,
                             axes=axes, world=world, peer=peer)


class phase:
    """Context manager recording begin/end events of a named phase
    (checkpoint save/load, jit compile...). Exceptions are recorded on the
    end event before propagating."""

    def __init__(self, name: str, **extra):
        self.name = name
        self.extra = extra or None
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        recorder().record("phase", op=self.name, phase="begin",
                          extra=self.extra)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = (time.perf_counter() - self._t0) * 1e6
        extra = dict(self.extra or {})
        if exc_type is not None:
            extra["error"] = f"{exc_type.__name__}: {exc}"
        recorder().record("phase", op=self.name, phase="end",
                          duration_us=round(dur, 1), extra=extra or None)
        return False


def dump(reason: str = "explicit", path: str | None = None) -> str:
    return recorder().dump(path=path, reason=reason)


def on_collective_timeout(what: str) -> str:
    """Watchdog entry point: a collective/p2p wait timed out — dump the
    ring NOW so the hang is attributable post-mortem, then let the caller
    raise."""
    telemetry.counter("flight.timeouts").bump()
    return recorder().dump(reason=f"collective_timeout:{what}")


_prev_sigterm = None
_signal_installed = False


def install_signal_handler() -> bool:
    """Dump the ring on SIGTERM (the launcher's kill path), chaining to
    any previous handler. Main-thread only (signal module constraint);
    returns whether the handler is installed."""
    global _prev_sigterm, _signal_installed
    if _signal_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        try:
            recorder().dump(reason="sigterm")
        except Exception:
            pass
        if callable(_prev_sigterm):
            _prev_sigterm(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # non-main thread race
        return False
    _signal_installed = True
    return True
