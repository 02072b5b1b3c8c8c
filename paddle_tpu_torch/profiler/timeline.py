"""Chrome ``trace_event`` export of the span ring, and the overlap
fraction (counterpart of ``paddle_tpu/profiler/timeline.py``).

:func:`export_trace` writes the per-process :mod:`spans` ring in the
Chrome Trace Event JSON object format, ``{"traceEvents": [...]}`` with
one complete (``"ph": "X"``) event a span, loadable into Perfetto or
chrome://tracing. Each rank writes ``trace.<rank>.json`` under
``PADDLE_TRACE_DIR``; the files of several ranks merge on one clock (span
timestamps are absolute epoch microseconds, so ranks of one host line up
as they are; a rank on another host records its measured offset,
:func:`clock_sync`, as ``clock_offset_us`` in the file's metadata, which
a merge subtracts).

:func:`compute_overlap` folds ``dp.bucket_sync`` spans against the
enclosing ``backward`` span: the fraction of a collective's in-flight
time covered by backward compute,

    covered  = max(0, min(end, backward.end) - begin - host_us)
    fraction = sum(covered) / sum(end - begin)        in [0, 1]
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from . import spans as _spans

__all__ = ["export_trace", "trace_events", "compute_overlap", "trace_dir",
           "clock_sync"]

#: span name whose [begin, end] is a fused-collective in-flight window
COLLECTIVE_SPAN = "dp.bucket_sync"
#: span name bounding one backward sweep
BACKWARD_SPAN = "backward"


def trace_dir() -> str:
    d = os.environ.get("PADDLE_TRACE_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "paddle_trace")
    return d


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:
        return 0


def trace_events(entries: list, pid: int) -> list:
    """Chrome trace_event dicts for span entries: one complete event per
    span plus process-name metadata. ``cat`` is the span name's first
    dotted component (Perfetto track grouping)."""
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"rank {pid}"},
    }]
    for e in entries:
        args = {"sid": e["sid"]}
        if e.get("parent"):
            args["parent"] = e["parent"]
        if e.get("step") is not None:
            args["step"] = e["step"]
        if e.get("attrs"):
            args.update(e["attrs"])
        events.append({
            "name": e["name"], "cat": e["name"].split(".", 1)[0],
            "ph": "X", "ts": round(e["ts_us"], 1),
            "dur": round(e["dur_us"], 1),
            "pid": pid, "tid": e["tid"], "args": args,
        })
    return events


def export_trace(path: str | None = None, rank: int | None = None,
                 clock_offset_us: float = 0.0, ring=None) -> str:
    """Write this process's span ring as one Perfetto-loadable JSON file;
    returns the path. ``clock_offset_us`` (from :func:`clock_sync`) rides
    in the metadata for a merge to subtract; the events themselves keep the
    local clock, so a single-rank file is self-consistent."""
    rank = _rank() if rank is None else int(rank)
    r = ring if ring is not None else _spans.ring()
    if path is None:
        d = trace_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace.{rank}.json")
    doc = {
        "traceEvents": trace_events(r.entries(), pid=rank),
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": "chrome-trace-events",
            "rank": rank, "pid": os.getpid(),
            "capacity": r.capacity, "dropped": r.dropped,
            "clock_offset_us": round(float(clock_offset_us), 1),
            "anchor_epoch_us": round(_spans.ANCHOR_EPOCH_US, 1),
            "exported_at": time.time(),
        },
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # atomic: a merge never sees a half export
    from . import telemetry

    telemetry.counter("spans.exports").bump()
    return path


def compute_overlap(events: list,
                    collective: str = COLLECTIVE_SPAN,
                    backward: str = BACKWARD_SPAN) -> float | None:
    """Overlap fraction from trace_event dicts (single rank or merged —
    pids are folded independently): the fraction of fused-collective
    in-flight time covered by still-running backward compute. None when
    no collective spans exist. See module docstring for the formula."""
    by_pid: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        by_pid.setdefault(e.get("pid", 0), []).append(e)
    total = covered = 0.0
    for evs in by_pid.values():
        bwd = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                     if e["name"] == backward)
        for e in evs:
            if e["name"] != collective:
                continue
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            total += t1 - t0
            host_us = float((e.get("args") or {}).get("host_us", t1 - t0))
            # the enclosing backward window (if any) bounds the compute
            # this collective could have overlapped
            b_end = next((b1 for b0, b1 in bwd if b0 <= t0 <= b1), t1)
            covered += max(0.0, min(t1, b_end) - t0 - host_us)
    if total <= 0:
        return None
    return max(0.0, min(1.0, covered / total))


def _try_get(store, key: str):
    """``store``'s value of ``key``, or None while it is missing (a
    ``torch.distributed`` store's ``get`` would wait for it)."""
    check = getattr(store, "check", None)
    if check is not None:
        return store.get(key) if check([key]) else None
    return store.get(key)


def clock_sync(store, rank: int, world: int, probes: int = 3,
               timeout_s: float = 10.0, gen: str | None = None) -> float:
    """Estimate this rank's wall-clock offset (us) relative to rank 0
    over a key-value store (a ``torch.distributed`` store, or any object
    with ``set`` and a ``get`` that returns a false value for a missing
    key). Subtracting the returned offset from local epoch timestamps
    puts them on rank 0's clock.

    Cristian's algorithm per probe: the peer stamps a request key, rank 0
    answers with its clock, the peer takes the request/response midpoint;
    the median across ``probes`` absorbs polling jitter. Accuracy is
    bounded by half the store round-trip (~ms) — plenty to order phase
    spans across ranks. Rank 0 serves every peer's probes (until done or
    deadline) and returns 0.0. Single-process worlds return 0.0."""
    if world <= 1 or store is None:
        return 0.0
    gen = gen if gen is not None else os.environ.get("PADDLE_RPC_GEN", "0")
    pre = f"profiler/clk/{gen}"
    deadline = time.monotonic() + timeout_s
    if rank == 0:
        pending = {(r, i) for r in range(1, world) for i in range(probes)}
        while pending and time.monotonic() < deadline:
            served = set()
            for r, i in pending:
                if _try_get(store, f"{pre}/req/{r}/{i}"):
                    store.set(f"{pre}/resp/{r}/{i}",
                              str(time.time() * 1e6))
                    served.add((r, i))
            pending -= served
            if pending:
                time.sleep(0.002)
        return 0.0
    offsets = []
    for i in range(probes):
        t0 = time.time() * 1e6
        store.set(f"{pre}/req/{rank}/{i}", "1")
        raw = None
        while not raw:
            raw = _try_get(store, f"{pre}/resp/{rank}/{i}")
            if raw:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"clock_sync: rank 0 never answered probe {i} within "
                    f"{timeout_s}s (is rank 0 running clock_sync too?)")
            time.sleep(0.002)
        t1 = time.time() * 1e6
        t_ref = float(raw)
        offsets.append((t0 + t1) / 2.0 - t_ref)
    offsets.sort()
    return offsets[len(offsets) // 2]
