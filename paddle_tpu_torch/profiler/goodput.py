"""Goodput accounting (counterpart of ``paddle_tpu/profiler/goodput.py``).

Every step boundary folds the wall time since the previous boundary into
*productive* time and *lost* time; losses are noted by the instrumented
sites with a reason:

- ``stall``       the trainer waited for data (the loader's
                  ``dataload.fetch``, site ``dataload``)
- ``eviction``    a serving lane's work thrown away by a cancel or a
                  failure: the time the lane was held since admission
- ``numerics``    the watchdog's handling of a numerics event
- ``unattributed`` a step that ran far slower than the best step seen
                  with no noted loss (if this grows, a site is missing)

and the reference's other reasons (``retry``, ``recompile``,
``preemption``, ``fault``, ``remat``, ``offload``), whose producers come
with later slices of the port.

Telemetry: ``goodput.lost_us{reason,site}``, ``goodput.productive_us``,
``goodput.steps{kind}`` counters and the ``goodput.fraction`` gauge
(cumulative productive / (productive + lost)).

A step whose un-lost wall time exceeds ``PADDLE_GOODPUT_STALL_FACTOR``
(default 2.0) times the best step seen so far books the excess as
``unattributed``: only the part beyond the factored best, so ordinary
jitter never registers.
"""

from __future__ import annotations

import os
import threading

from . import telemetry

__all__ = ["note_loss", "step", "fraction", "summary", "reset",
           "register_step_hook", "unregister_step_hook", "LOSS_REASONS"]

LOSS_REASONS = ("retry", "recompile", "eviction", "preemption", "stall",
                "fault", "remat", "offload", "unattributed")

_lock = threading.Lock()
_state = {
    "window_lost": 0.0,   # losses noted since the last step boundary
    "lost_total": 0.0,
    "productive_total": 0.0,
    "best": {},           # kind -> best (lowest) un-lost step wall us
}


# step-boundary subscribers: fn(wall_us, kind, folded_dict) per completed
# step fold.
# Hooks run OUTSIDE the ledger lock; a broken hook never corrupts
# accounting or kills the training loop.
_step_hooks: list = []


def register_step_hook(fn) -> None:
    """Subscribe ``fn(wall_us, kind, folded)`` to every :func:`step`
    fold."""
    if fn not in _step_hooks:
        _step_hooks.append(fn)


def unregister_step_hook(fn) -> None:
    try:
        _step_hooks.remove(fn)
    except ValueError:
        pass


def _stall_factor() -> float:
    try:
        return max(1.0, float(os.environ.get(
            "PADDLE_GOODPUT_STALL_FACTOR", "2.0")))
    except ValueError:
        return 2.0


def note_loss(reason: str, us: float, site: str | None = None) -> None:
    """Book ``us`` microseconds of lost time under ``reason`` (one of
    :data:`LOSS_REASONS`; free-form accepted). ``site`` labels the
    responsible subsystem (dataload, serve, train_step) so the
    loss is attributable to its subsystem."""
    if us <= 0:
        return
    us = float(us)
    if site is not None:
        telemetry.counter("goodput.lost_us", reason=reason,
                          site=site).bump(int(us))
    else:
        telemetry.counter("goodput.lost_us", reason=reason).bump(int(us))
    with _lock:
        _state["window_lost"] += us
        _state["lost_total"] += us
    _set_fraction()


def step(wall_us: float, kind: str = "train", scope=None) -> dict:
    """Fold one completed step: losses noted since the previous boundary
    (clamped to the step's wall time; any excess carries into the next
    window — an async checkpoint's loss may straddle boundaries) are
    subtracted, the rest books as productive. Returns this step's
    ``{wall_us, lost_us, productive_us, unattributed_us}``.

    ``scope`` keys the unattributed-stall baseline: steps of DIFFERENT
    programs (a tiny model vs an 8B-shape bench entry, both kind="train")
    must not share a best-step floor, or the slower program's every step
    reads as a stall — callers pass a per-instance token (TrainStep and
    ServingEngine pass ``id(self)``)."""
    wall_us = max(0.0, float(wall_us))
    factor = _stall_factor()
    with _lock:
        lost_w = min(_state["window_lost"], wall_us)
        _state["window_lost"] -= lost_w
        residual = wall_us - lost_w
        bkey = (kind, scope)
        best = _state["best"].get(bkey)
        unattributed = 0.0
        if best is not None and residual > factor * best:
            unattributed = residual - factor * best
            residual -= unattributed
            _state["lost_total"] += unattributed
        # a fully-lost step (residual 0) says nothing about healthy step
        # time — it must not poison the stall baseline
        if residual > 0:
            _state["best"][bkey] = (residual if best is None
                                    else min(best, residual))
        _state["productive_total"] += residual
    telemetry.counter("goodput.productive_us").bump(int(residual))
    telemetry.counter("goodput.steps", kind=kind).bump()
    if unattributed:
        telemetry.counter("goodput.lost_us", reason="unattributed").bump(
            int(unattributed))
    _set_fraction()
    folded = {"wall_us": wall_us, "lost_us": lost_w,
              "productive_us": residual, "unattributed_us": unattributed}
    for fn in list(_step_hooks):
        try:
            fn(wall_us, kind, folded)
        except Exception:
            pass  # a broken subscriber must not poison the ledger
    return folded


def _set_fraction() -> None:
    with _lock:
        p, l = _state["productive_total"], _state["lost_total"]
    if p + l > 0:
        telemetry.gauge("goodput.fraction").set(round(p / (p + l), 4))


def fraction() -> float | None:
    """Cumulative goodput fraction, None before any accounting."""
    with _lock:
        p, l = _state["productive_total"], _state["lost_total"]
    return p / (p + l) if p + l > 0 else None


def summary() -> dict:
    """Human/bench-facing rollup: totals, fraction, and the per-reason
    loss breakdown pulled back out of the telemetry registry."""
    by_reason: dict = {}
    for (kind, name, labels), m in sorted(telemetry._registry.items()):
        if kind == "c" and name == "goodput.lost_us" and m.value:
            lab = dict(labels)
            key = lab.get("reason", "?")
            if lab.get("site"):
                key = f"{key}:{lab['site']}"
            by_reason[key] = by_reason.get(key, 0) + m.value
    with _lock:
        p, l = _state["productive_total"], _state["lost_total"]
    return {
        "productive_us": round(p, 1), "lost_us": round(l, 1),
        "fraction": round(p / (p + l), 4) if p + l > 0 else None,
        "lost_by_reason": by_reason,
    }


def reset() -> None:
    """Zero the accountant's internal state (tests). The telemetry
    counters themselves are zeroed by ``telemetry.reset()``, which calls
    this via its reset hook."""
    with _lock:
        _state["window_lost"] = 0.0
        _state["lost_total"] = 0.0
        _state["productive_total"] = 0.0
        _state["best"] = {}


telemetry.register_reset_hook(reset)
