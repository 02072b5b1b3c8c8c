"""Profiler summary statistics (counterpart of
``paddle_tpu/profiler/statistic.py``): the per-name table (calls, total,
average, max, min, ratio) that ``Profiler.summary`` prints, built from the
``RecordEvent`` ranges of a session.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    Calls = 4


@dataclass
class _Agg:
    calls: int = 0
    total_ns: int = 0
    max_ns: int = 0
    min_ns: int = 0


@dataclass
class EventStatistics:
    """Aggregates (name, dur_ns) spans into a per-name table."""

    _by_name: dict = field(default_factory=dict)

    def add(self, name: str, dur_ns: int):
        a = self._by_name.setdefault(name, _Agg(min_ns=dur_ns))
        a.calls += 1
        a.total_ns += dur_ns
        a.max_ns = max(a.max_ns, dur_ns)
        a.min_ns = min(a.min_ns, dur_ns)

    def clear(self):
        self._by_name.clear()

    def rows(self, sorted_by: SortedKeys = SortedKeys.CPUTotal) -> list[dict]:
        total = sum(a.total_ns for a in self._by_name.values()) or 1
        rows = [
            {
                "name": n,
                "calls": a.calls,
                "total_ms": a.total_ns / 1e6,
                "avg_ms": a.total_ns / a.calls / 1e6,
                "max_ms": a.max_ns / 1e6,
                "min_ms": a.min_ns / 1e6,
                "ratio": a.total_ns / total,
            }
            for n, a in self._by_name.items()
        ]
        key = {
            SortedKeys.CPUTotal: lambda r: -r["total_ms"],
            SortedKeys.CPUAvg: lambda r: -r["avg_ms"],
            SortedKeys.CPUMax: lambda r: -r["max_ms"],
            SortedKeys.CPUMin: lambda r: -r["min_ms"],
            SortedKeys.Calls: lambda r: -r["calls"],
        }[sorted_by]
        rows.sort(key=key)
        return rows

    def table(self, sorted_by: SortedKeys = SortedKeys.CPUTotal,
              time_unit: str = "ms", row_limit: int = 30) -> str:
        rows = self.rows(sorted_by)[:row_limit]
        if not rows:
            return "(no events recorded)"
        scale = {"s": 1e-3, "ms": 1.0, "us": 1e3}.get(time_unit, 1.0)
        name_w = max(24, max(len(r["name"]) for r in rows) + 2)
        hdr = (f"{'Name':<{name_w}}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
               f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}"
               f"{'Min(' + time_unit + ')':>12}{'Ratio':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in rows:
            lines.append(
                f"{r['name']:<{name_w}}{r['calls']:>8}"
                f"{r['total_ms'] * scale:>14.3f}{r['avg_ms'] * scale:>12.3f}"
                f"{r['max_ms'] * scale:>12.3f}{r['min_ms'] * scale:>12.3f}"
                f"{r['ratio'] * 100:>7.1f}%")
        return "\n".join(lines)


# process-global collector fed by RecordEvent
_GLOBAL = EventStatistics()


def global_statistics() -> EventStatistics:
    return _GLOBAL
