"""paddle.profiler for the port (counterpart of
``paddle_tpu/profiler/__init__.py``).

:class:`Profiler` runs over ``torch.profiler``: ``ProfilerTarget.CPU`` is
host activity, ``ProfilerTarget.GPU`` CUDA activity (kernels, copies,
sets) recorded through CUPTI. It keeps the reference's surface:
``scheduler=make_scheduler(...)`` or a ``(start, end)`` step range,
``step()``, ``start()`` / ``stop()`` or ``with``, ``export(path,
format="json")`` (a Chrome trace of the session: host ops, the
``RecordEvent`` and span ranges, the device's kernels by name),
``summary()`` (step times, the ``RecordEvent`` table of
:mod:`.statistic`, the device's kernels, and the telemetry, goodput and
numerics sections), ``export_timeline`` (the span ring, :mod:`.timeline`)
and ``export_chrome_tracing(dir)`` as an ``on_trace_ready`` handler.

:class:`RecordEvent` is a ``torch.profiler.record_function`` range that
also feeds :func:`global_statistics`, as the reference's does.
While a session records, every span (:mod:`.spans`) opens a range of its
name too, so :meth:`Profiler.device_trace_summary` can give the device
time of the kernels launched under each host annotation (``jit.dispatch``,
``serve.decode.dispatch``, ...): each kernel is linked to its launch by
the CUPTI correlation id, and the launch placed inside an annotation's
interval. It is the port's counterpart of the reference's
``xplane_device_summary``, which scans its XLA trace files for device
planes.

The reference also streams ``RecordEvent`` spans into a native
Chrome-trace recorder of its own (``core_native``); the port has no such
recorder: its Chrome trace is ``torch.profiler``'s.

The always-on tiers live in the submodules: :mod:`.telemetry`,
:mod:`.spans`, :mod:`.goodput`, :mod:`.flight_recorder`,
:mod:`.timeline`, :mod:`.numerics`, :mod:`.attribution`.
"""

from __future__ import annotations

import os
import tempfile
import time
from enum import Enum

import torch

from . import attribution, flight_recorder, goodput, numerics, spans, statistic, telemetry, \
    timeline  # noqa: F401
from .spans import span  # noqa: F401
from .statistic import EventStatistics, SortedKeys, global_statistics  # noqa: F401

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent", "SortedKeys",
           "benchmark", "export_chrome_tracing", "make_scheduler", "span", "attribution",
           "flight_recorder", "goodput", "numerics", "spans", "statistic", "telemetry",
           "timeline", "global_statistics", "EventStatistics"]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    def scheduler(step: int):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = (step - skip_first) % max(closed + ready + record, 1)
        if s < closed:
            return ProfilerState.CLOSED
        if s < closed + ready:
            return ProfilerState.READY
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name: str, worker_name=None):
    """An ``on_trace_ready`` handler writing the session's Chrome trace
    JSON into ``dir_name``."""

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        prof.export(os.path.join(dir_name, f"{name}.pt.trace.json"), format="json")
    return handler


class RecordEvent:
    """A scoped host event (``phi::RecordEvent``): a
    ``torch.profiler.record_function`` range, so it shows in a recording
    session's trace, and a row of :func:`global_statistics`."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self.begin_ns = None
        self.end_ns = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        self.begin_ns = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()

    def end(self):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self.begin_ns is not None:
            global_statistics().add(self.name, self.end_ns - self.begin_ns)


# CUDA runtime and driver calls whose CUPTI correlation id names the device
# activity they started
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cudaGraphLaunch",
             "cuMemcpy", "cuMemset")


def device_time_under(events, annotations=()) -> dict:
    """Device time of the kernels launched under each host annotation, from
    a ``torch.profiler`` session's raw events (``kineto_results.events()``).
    Each device activity (kernel, copy, set) is linked to the runtime call
    that launched it by their correlation id, and counted under every
    annotation whose host interval holds that call; an activity whose
    launch was not recorded is placed by its own start (the interval from
    the annotation's start to the next call of that name's start).
    Returns ``{"device_ms", "kernels", "annotations": {name: {"calls",
    "device_ms", "kernels", "linked"}}, "annotations_found"}``."""
    cpu = torch.autograd.DeviceType.CPU
    device, launch_ns = [], {}
    ranges = {a: [] for a in annotations}
    for e in events:
        if e.device_type() != cpu:
            # a host range's device-side shadow (gpu_user_annotation) is no
            # device work of its own
            if not e.is_user_annotation():
                device.append(e)
            continue
        name = e.name()
        if name in ranges:
            ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(_LAUNCHES):
            launch_ns[e.correlation_id()] = e.start_ns()
    out = {"device_ms": sum(e.duration_ns() for e in device) / 1e6, "kernels": len(device),
           "annotations": {}}
    for name, spans_ in ranges.items():
        spans_.sort()
        row = {"calls": len(spans_), "device_ms": 0.0, "kernels": 0, "linked": 0}
        for e in device:
            t = launch_ns.get(e.correlation_id())
            if t is None:
                t = launch_ns.get(e.linked_correlation_id())
            if t is not None:
                inside = any(a <= t <= b for a, b in spans_)
                row["linked"] += inside
            else:
                s = e.start_ns()
                starts = [a for a, _ in spans_] + [float("inf")]
                inside = any(starts[i] <= s < starts[i + 1] for i in range(len(spans_)))
            if inside:
                row["device_ms"] += e.duration_ns() / 1e6
                row["kernels"] += 1
        out["annotations"][name] = row
    out["annotations_found"] = [n for n, r in out["annotations"].items() if r["calls"]]
    return out


class Profiler:
    """paddle.profiler.Profiler over ``torch.profiler``."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            scheduler = make_scheduler(closed=lo, ready=0, record=hi - lo, skip_first=0)
        targets = list(targets) if targets is not None else [ProfilerTarget.CPU,
                                                              ProfilerTarget.GPU]
        self._activities = []
        if ProfilerTarget.CPU in targets:
            self._activities.append(torch.profiler.ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets and torch.cuda.is_available():
            self._activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._torch_kw = dict(record_shapes=record_shapes, profile_memory=profile_memory,
                              with_flops=with_flops)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._step = 0
        self._prof = None         # the session recording now, or the last one
        self._recording = False
        self._step_times = []
        self._last_step_t = None

    @property
    def torch_profiler(self):
        """The ``torch.profiler.profile`` of the current or last session."""
        return self._prof

    def events(self):
        """The last session's ``torch.profiler`` events (FunctionEvents)."""
        return self._prof.events() if self._prof is not None else []

    def start(self):
        self._last_step_t = time.perf_counter()
        global_statistics().clear()
        if self._timer_only:
            return
        state = self._scheduler(self._step) if self._scheduler else ProfilerState.RECORD
        if state in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._begin_trace()

    def _begin_trace(self):
        if not self._recording:
            self._prof = torch.profiler.profile(activities=self._activities, **self._torch_kw)
            self._prof.start()
            self._recording = True
            spans.annotate(True)

    def _end_trace(self):
        if self._recording:
            spans.annotate(False)
            self._prof.stop()
            self._recording = False

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._step += 1
        if self._timer_only or self._scheduler is None:
            return
        state = self._scheduler(self._step)
        if state == ProfilerState.RECORD and not self._recording:
            self._begin_trace()
        elif state == ProfilerState.CLOSED and self._recording:
            self._end_trace()
            if self._on_trace_ready:
                self._on_trace_ready(self)

    def stop(self):
        was = self._recording
        self._end_trace()
        if self._on_trace_ready and was:
            self._on_trace_ready(self)

    def export(self, path=None, format="json"):
        """Write the last session as a Chrome trace JSON at ``path`` (a new
        file in the temporary directory when None); returns the path."""
        if format != "json":
            raise ValueError(f"the port's Profiler exports format='json' only, not {format!r}")
        if self._prof is None:
            raise RuntimeError("no profiling session was recorded")
        if path is None:
            fd, path = tempfile.mkstemp(prefix="pt_prof_", suffix=".json")
            os.close(fd)
        self._prof.export_chrome_trace(path)
        return path

    def device_trace_summary(self, annotations=()):
        """:func:`device_time_under` of the last session (None when none was
        recorded)."""
        if self._prof is None or self._recording:
            return None
        return device_time_under(self._prof.profiler.kineto_results.events(), annotations)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False, time_unit="ms"):
        """Step timing, the host ``RecordEvent`` table, the device's top
        kernels, and the telemetry, histogram, goodput and numerics
        sections; returns the step times."""
        if self._step_times:
            import numpy as np

            ts = np.asarray(self._step_times) * 1000
            print(f"steps: {len(ts)}  mean {ts.mean():.2f}ms  p50 {np.percentile(ts, 50):.2f}ms  "
                  f"p99 {np.percentile(ts, 99):.2f}ms")
        if op_detail:
            print(global_statistics().table(sorted_by or SortedKeys.CPUTotal,
                                            time_unit=time_unit))
        if self._prof is not None and not self._recording:
            per_kernel: dict = {}
            for ev in self._prof.events():
                if (ev.device_type != torch.autograd.DeviceType.CPU
                        and not ev.is_user_annotation):
                    per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                           + ev.time_range.elapsed_us())
            if per_kernel:
                print(f"device trace: kernels={len(per_kernel)} "
                      f"device_ms={sum(per_kernel.values()) / 1e3:.3f}")
                for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]:
                    print(f"  {us / 1e3:.3f} ms {name[:90]}")
        tel = telemetry.snapshot()
        nonzero = {k: v for k, v in sorted(tel.items()) if v}
        if nonzero:
            print("telemetry:")
            for k, v in nonzero.items():
                print(f"  {k} = {v}")
        hists = telemetry.histogram_summaries()
        if hists:
            print("telemetry histograms:")
            for k, s in hists.items():
                print(f"  {k}: n={s['count']} mean={s['mean']} "
                      f"p50={s['p50']} p90={s['p90']} p99={s['p99']}")
        g = goodput.summary()
        if g["fraction"] is not None:
            print(f"goodput: fraction={g['fraction']} "
                  f"productive={g['productive_us'] / 1e6:.3f}s "
                  f"lost={g['lost_us'] / 1e6:.3f}s")
            for reason, us in sorted(g["lost_by_reason"].items()):
                print(f"  lost[{reason}] = {us / 1e6:.3f}s")
        num_prefixes = ("train.numerics", "train.nonfinite", "train.divergen", "amp.overflow")
        num = {k: v for k, v in tel.items() if k.startswith(num_prefixes) and v}
        for gname in ("train.loss", "train.grad_norm", "train.divergent_rank"):
            gv = telemetry._registry.get(("g", gname, ()))
            if gv is not None:
                num[gname] = gv.value
        if num:
            print("numerics:")
            for k, v in sorted(num.items()):
                print(f"  {k} = {v}")
        return self._step_times

    def export_timeline(self, path=None, rank=None, clock_offset_us=0.0):
        """Write the process's span ring as a Chrome trace_event JSON
        (:func:`timeline.export_trace`); independent of any session."""
        return timeline.export_trace(path=path, rank=rank, clock_offset_us=clock_offset_us)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def benchmark():
    class _Benchmark:
        def begin(self):
            self._t = time.perf_counter()

        def end(self):
            return time.perf_counter() - self._t
    return _Benchmark()
