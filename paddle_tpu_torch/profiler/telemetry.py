"""Process-wide runtime telemetry: counters, gauges and histograms,
default-on (counterpart of ``paddle_tpu/profiler/telemetry.py``).

The hot path pays one attribute increment and nothing else: no
formatting, and no allocation once the metric object exists. Hold the
object a get-or-create call returns and bump it. ``c.value += n`` is for a
counter with a single writing thread (the step loop); a metric produced
from more than one thread goes through ``bump()`` / ``observe()``, which
take the metric's lock (``+=`` on an attribute is a load, an add and a
store, and a thread switch between them loses an update).

Surface:
- ``counter(name, **labels)`` / ``gauge(name, **labels)`` /
  ``histogram(name, **labels)``: get-or-create, memoized per (name,
  labels). Histograms have fixed log-spaced buckets (1-2.5-5 a decade);
  ``histogram_summaries()`` gives count, sum, mean, p50, p90, p99.
- ``snapshot()``: every metric under its Prometheus-style key.
- ``export_jsonl(logdir)``: one snapshot appended a call through
  :class:`paddle_tpu_torch.utils.LogWriter`.
- ``prometheus_text()``: the text exposition format.
- ``reset()``: zero everything and run the reset hooks (tests).
- ``PADDLE_TELEMETRY=0`` turns off the optional layers (the flight
  recorder's capture, spans, attribution); counters stay on.
  ``PADDLE_TELEMETRY_SNAPSHOT=<path>`` writes the snapshot as JSON at
  interpreter exit (a directory gets ``snapshot.<pid>.json``).

The producers of the port keep the reference's metric names and label
keys: ``TrainStep`` (``jit/training.py``: goodput, attribution, the
numerics sentinels and watchdog, the JSONL export), the serving engine
(``serve.*``), the loader (``dataload.fetch`` span, goodput ``stall``),
the optimizer (``opt.dispatches``, ``opt.step_us{regime}``,
``opt.fused_cache_*``, ``opt.fused_steps``), the clippers
(``clip.fused_calls``) and ``amp`` (``amp.unscale_dispatches``,
``amp.overflow{group}``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left as _bisect_left

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "histogram_summaries", "snapshot", "reset", "prometheus_text",
    "export_jsonl", "enabled",
]


def enabled() -> bool:
    """Telemetry is DEFAULT-ON; PADDLE_TELEMETRY=0 turns off the optional
    layers (flight-recorder event capture). Counters are unconditional —
    an int bump is the off-switch-free design."""
    return os.environ.get("PADDLE_TELEMETRY", "1").lower() not in (
        "0", "false", "off")


class Counter:
    """Monotonic counter. ``bump(n)`` is thread-safe; ``c.value += n``
    stays available for hot paths whose counter has exactly ONE writing
    thread (the step loop idiom) — cross-thread producers (async
    checkpoint writers, completion probes, serving workers) must go
    through ``bump``."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0
        self._lock = threading.Lock()

    def bump(self, n: int = 1):
        # += on an attribute is LOAD/ADD/STORE: a thread switch between
        # them loses a concurrent update
        with self._lock:
            self.value += n

    def __repr__(self):
        return f"Counter({_metric_key(self.name, self.labels)}={self.value})"


class Gauge:
    """Last-write-wins value (queue depths, cache sizes)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v):
        self.value = v

    def __repr__(self):
        return f"Gauge({_metric_key(self.name, self.labels)}={self.value})"


# log-spaced 1-2.5-5 decades, microsecond-denominated for latencies but
# unit-agnostic; the +inf overflow bucket is counts[len(bounds)]
_HIST_BOUNDS = (
    1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1_000, 2_500, 5_000, 10_000, 25_000, 50_000, 100_000, 250_000, 500_000,
    1_000_000, 2_500_000, 5_000_000, 10_000_000,
)


class Histogram:
    """Fixed-bucket distribution (collective latencies, bucket sizes).
    ``observe(v)`` is the only producer API: one bisect + two bumps."""

    __slots__ = ("name", "labels", "bounds", "counts", "total", "count",
                 "_lock")

    def __init__(self, name: str, labels: tuple = (), bounds=_HIST_BOUNDS):
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v):
        # three read-modify-writes that must agree with each other even
        # when producer threads interleave (see Counter.bump)
        with self._lock:
            self.counts[_bisect_left(self.bounds, v)] += 1
            self.total += v
            self.count += 1

    def _quantile(self, q: float):
        """Upper bound of the bucket holding the q-quantile (overflow
        clamps to the last finite bound) — bucket-resolution, which is
        what fixed-bucket histograms buy."""
        if not self.count:
            return None
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return float(self.bounds[min(i, len(self.bounds) - 1)])
        return float(self.bounds[-1])

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.total, 1),
            "mean": round(self.total / self.count, 1) if self.count else None,
            "p50": self._quantile(0.50),
            "p90": self._quantile(0.90),
            "p99": self._quantile(0.99),
        }

    def __repr__(self):
        return (f"Histogram({_metric_key(self.name, self.labels)} "
                f"count={self.count} sum={self.total})")


_registry: dict = {}          # (kind, name, labels) -> Counter | Gauge
_registry_lock = threading.Lock()
_collectors: list = []        # () -> dict[str, number], merged into snapshot
_reset_hooks: list = []       # () -> None, run by reset() (goodput state)
_export_step = 0


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _metric_key(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def counter(name: str, **labels) -> Counter:
    key = ("c", name, _labels_key(labels))
    c = _registry.get(key)
    if c is None:
        with _registry_lock:
            c = _registry.setdefault(key, Counter(name, _labels_key(labels)))
    return c


def gauge(name: str, **labels) -> Gauge:
    key = ("g", name, _labels_key(labels))
    g = _registry.get(key)
    if g is None:
        with _registry_lock:
            g = _registry.setdefault(key, Gauge(name, _labels_key(labels)))
    return g


def histogram(name: str, **labels) -> Histogram:
    key = ("h", name, _labels_key(labels))
    h = _registry.get(key)
    if h is None:
        with _registry_lock:
            h = _registry.setdefault(key, Histogram(name, _labels_key(labels)))
    return h


def histogram_summaries() -> dict:
    """{metric key: summary dict} for every non-empty histogram — the
    human/bench-facing view (Profiler.summary prints these)."""
    out = {}
    for (kind, name, labels), m in sorted(_registry.items()):
        if kind == "h" and m.count:
            out[_metric_key(name, labels)] = m.summary()
    return out


def register_collector(fn) -> None:
    """Register a pull-based stats source: fn() -> {metric_key: number}.
    Used where the canonical state lives elsewhere (e.g. cache sizes)."""
    _collectors.append(fn)


def register_reset_hook(fn) -> None:
    """Register extra state to zero alongside reset() — modules keeping
    derived accounting outside the registry (profiler/goodput.py) hook in
    here so tests resetting telemetry reset the whole ledger."""
    _reset_hooks.append(fn)


def snapshot() -> dict:
    """Every metric as {prometheus-style key: value}; histograms flatten
    to <key>.count/.sum/.p50/.p99; collectors merged."""
    out = {}
    for (kind, name, labels), m in sorted(_registry.items()):
        key = _metric_key(name, labels)
        if kind == "h":
            s = m.summary()
            out[f"{key}.count"] = s["count"]
            out[f"{key}.sum"] = s["sum"]
            if s["count"]:
                out[f"{key}.p50"] = s["p50"]
                out[f"{key}.p99"] = s["p99"]
        else:
            out[key] = m.value
    for fn in list(_collectors):
        try:
            out.update(fn())
        except Exception:  # a broken collector must not kill observability
            pass
    return out


def reset() -> None:
    """Zero all counters/gauges/histograms (tests). Registered objects
    stay valid — hot-path holders keep bumping the same instances."""
    for m in _registry.values():
        if isinstance(m, Histogram):
            m.counts = [0] * (len(m.bounds) + 1)
            m.total = 0.0
            m.count = 0
        else:
            m.value = 0
    for fn in list(_reset_hooks):
        try:
            fn()
        except Exception:
            pass


def prometheus_text() -> str:
    """Prometheus text exposition format (one family per name;
    histograms emit the standard cumulative _bucket/_sum/_count form)."""
    lines = []
    seen_type = set()
    for (kind, name, labels), m in sorted(_registry.items()):
        pname = "paddle_tpu_" + name.replace(".", "_").replace("-", "_")
        if pname not in seen_type:
            seen_type.add(pname)
            mtype = {"c": "counter", "g": "gauge", "h": "histogram"}[kind]
            lines.append(f"# TYPE {pname} {mtype}")
        inner = ",".join(f'{k}="{v}"' for k, v in m.labels)
        if kind == "h":
            acc = 0
            for bound, c in zip(m.bounds, m.counts):
                acc += c
                le = f'le="{bound}"'
                sep = "," if inner else ""
                lines.append(f"{pname}_bucket{{{inner}{sep}{le}}} {acc}")
            sep = "," if inner else ""
            lines.append(f'{pname}_bucket{{{inner}{sep}le="+Inf"}} {m.count}')
            suffix = f"{{{inner}}}" if inner else ""
            lines.append(f"{pname}_sum{suffix} {m.total}")
            lines.append(f"{pname}_count{suffix} {m.count}")
        elif inner:
            lines.append(f"{pname}{{{inner}}} {m.value}")
        else:
            lines.append(f"{pname} {m.value}")
    return "\n".join(lines) + ("\n" if lines else "")


def export_jsonl(logdir: str, step: int | None = None) -> str:
    """Append one full snapshot to ``logdir`` through utils/log_writer
    (kind=scalar records, tag='telemetry/<metric>'). Returns the JSONL
    path written."""
    from ..utils.log_writer import LogWriter

    global _export_step
    if step is None:
        step = _export_step
        _export_step += 1
    with LogWriter(logdir, file_name=f"telemetry.{os.getpid()}.jsonl") as w:
        now = time.time()
        for key, val in snapshot().items():
            w.add_scalar(f"telemetry/{key}", val, step, walltime=now)
        return w._path


def dump_json() -> str:
    """One-line JSON of the snapshot (log-line friendly)."""
    return json.dumps(snapshot(), sort_keys=True)


def write_snapshot_file(path: str) -> str:
    """Atomically write the full snapshot as JSON to ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snapshot(), f, sort_keys=True, indent=1)
    os.replace(tmp, path)
    return path


# the process exports its final counter state at exit, so a supervisor can
# read it without IPC. A directory target (or a trailing separator) gets
# one snapshot.<pid>.json per process: the multi-worker launch case.
def _export_snapshot_at_exit():
    path = os.environ.get("PADDLE_TELEMETRY_SNAPSHOT")
    if not path:
        return
    try:
        if path.endswith(os.sep) or os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, f"snapshot.{os.getpid()}.json")
        write_snapshot_file(path)
    except OSError:
        pass  # a dead export target must not mask the process's own exit


if os.environ.get("PADDLE_TELEMETRY_SNAPSHOT"):
    import atexit

    atexit.register(_export_snapshot_at_exit)
