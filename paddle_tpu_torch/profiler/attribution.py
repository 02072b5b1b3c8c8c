"""Runtime cost attribution: live MFU and roofline gauges (counterpart of
``paddle_tpu/profiler/attribution.py``).

The reference lowers each compiled program once more and walks its HLO for
FLOPs and bytes. The port runs eagerly, so it counts a program's cost
during its first real call, never by running it again (a training step run
twice would update the weights twice): :func:`counting` wraps that call in
a ``TorchDispatchMode`` (:class:`CostCounter`) that counts every aten op
and takes the hand-written kernels' own reports. The kernels launch
through ctypes, where no dispatch mode sees them, so each wrapper reports
its FLOPs and bytes to the active counter (:func:`note_kernel`) with the
formulas ``chip_smoke.py`` bounds them by. The counter's own time (its
handler, not the ops it runs) is the observer time, which ``TrainStep``
subtracts from the step's wall, as the reference subtracts its lowering.

Per op: a matrix product or convolution its FLOPs from the shapes
(``torch.utils.flop_counter``'s formulas: 2·M·N·K, the convolutions'); a
pointwise op one FLOP an output element, a reduction one an input
element; every op that is not a view or an allocation the bytes of its
tensor inputs and outputs (each read and written once), a gather the rows
it returns and a scatter the rows it updates. The reference's
cost model charges a fusion's body no bytes; eager torch writes every
intermediate, so the port's byte counts are larger for the same function,
and its elementwise FLOPs follow torch's ops, not XLA's fusions.

Every dispatch then divides its measured wall time into two default-on
gauges:

- ``jit.program_mfu{program}``: FLOPs / (wall · the spec's peak), clamped
  to (0, 1];
- ``jit.program_roofline_frac{program}``: the roofline's time (the larger
  of FLOPs over the peak, f32 FLOPs at the f32 rate, and bytes over the
  memory rate) / wall;

and for serving's decode ``serve.decode_roofline_tok_s`` /
``serve.decode_roofline_frac``. On the card the wall is the device time of
the program between a CUDA event pair on its stream (the host returns from
an eager step long before the device is done); on the CPU the host's.

``PADDLE_ATTRIBUTION=0`` turns the tier off, the counting pass included.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import torch

from . import telemetry

__all__ = ["enabled", "DeviceSpec", "DEVICE_SPECS", "spec_for", "ProgramCost",
           "ProgramCosts", "CostCounter", "counting", "note_kernel", "program_costs",
           "reset"]


def enabled() -> bool:
    return (os.environ.get("PADDLE_ATTRIBUTION", "1") != "0"
            and telemetry.enabled())


def _clamp01(v: float) -> float:
    """Clamp a ratio into (0, 1]: measurement jitter can push a tiny
    program past its nominal roofline."""
    return min(1.0, v) if v > 0 else 0.0


@dataclass(frozen=True)
class DeviceSpec:
    """Peak rates of one device class: ``peak_flops`` the dense bf16 /
    fp16 tensor-core rate (the MFU denominator), ``peak_flops_f32`` the
    rate of f32 products, ``hbm_bps`` and ``ici_bps`` bytes a second,
    ``hbm_bytes`` the device memory."""

    name: str
    peak_flops: float
    hbm_bps: float
    ici_bps: float
    hbm_bytes: float = 0.0
    peak_flops_f32: float = 0.0


#: The H100 SXM (80 GB HBM3): 989 TFLOP/s dense bf16/fp16, a third of it
#: for f32 products, 3.35 TB/s, NVLink 450 GB/s a direction. The CPU host
#: entry is a round nominal fallback so that rooflines stay finite off the
#: card.
DEVICE_SPECS = {
    "h100-sxm": DeviceSpec("h100-sxm", 989e12, 3.35e12, 450e9, 80e9, 989e12 / 3),
    "cpu-host": DeviceSpec("cpu-host", 1e12, 5e10, 1e10, 16 * 2**30, 1e12),
}


def spec_for(device=None) -> DeviceSpec:
    """DeviceSpec of ``device`` (a torch device, a spec name or a
    DeviceSpec; None: the card if there is one, else the host)."""
    if isinstance(device, DeviceSpec):
        return device
    if isinstance(device, str) and device in DEVICE_SPECS:
        return DEVICE_SPECS[device]
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        return DEVICE_SPECS["h100-sxm"]
    return DEVICE_SPECS["cpu-host"]


@dataclass
class ProgramCost:
    """Counted cost of one program and its roofline."""

    module_name: str
    spec: DeviceSpec
    flops: float = 0.0
    flops_f32: float = 0.0       # of ``flops``, the products on f32 operands
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    kernel_flops: float = 0.0    # of ``flops``, the hand kernels' reports
    ops: int = 0

    @property
    def compute_s(self) -> float:
        peak32 = self.spec.peak_flops_f32 or self.spec.peak_flops
        return ((self.flops - self.flops_f32) / self.spec.peak_flops
                + self.flops_f32 / peak32)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.spec.hbm_bps

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.spec.ici_bps

    @property
    def projected_s(self) -> float:
        """The roofline's time: the binding lane, the others overlapped."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def verdict(self) -> str:
        lanes = (("compute", self.compute_s), ("bandwidth", self.memory_s),
                 ("collective", self.collective_s))
        return max(lanes, key=lambda kv: kv[1])[0]

    def summary(self) -> dict:
        return {"module": self.module_name, "spec": self.spec.name, "flops": self.flops,
                "flops_f32": self.flops_f32, "hbm_bytes": self.hbm_bytes,
                "kernel_flops": self.kernel_flops, "ops": self.ops,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "projected_s": self.projected_s, "verdict": self.verdict}


# -- the counting pass ------------------------------------------------------

_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm", "linalg_vector_norm",
    "var", "std", "var_mean", "std_mean", "logsumexp", "any", "all", "argmax", "argmin",
    "_log_softmax", "_softmax", "_log_softmax_backward_data", "_softmax_backward_data",
    "nll_loss_forward", "nll_loss_backward", "cumsum", "embedding_dense_backward",
    "index_add", "index_put", "scatter_add", "_foreach_norm"))
_FREE = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "lift_fresh", "_to_copy_meta", "resize_", "set_", "record_stream", "_local_scalar_dense",
    "is_same_size", "_has_compatible_shallow_copy_type", "size", "stride", "numel", "dim"))

# a gather reads only the rows it returns; a scatter reads and writes only
# the rows it updates: their bytes come from the result or the values and
# the indices, not from the whole table (a KV pool, an embedding)
_GATHERS = frozenset(("index", "index_select", "gather", "embedding", "take"))
_SCATTERS = frozenset(("index_put", "index_add", "index_copy", "scatter", "scatter_add",
                       "masked_scatter"))

_ACTIVE: list = []       # the counters of the counting passes now open
_lock = threading.Lock()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops run under it, plus what
    the hand kernels report (:func:`note_kernel`); ``observer_us`` is the
    time spent in its own handler."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_f32 = 0.0
        self.hbm_bytes = 0.0
        self.kernel_flops = 0.0
        self.ops = 0
        self.observer_us = 0.0

    def add(self, flops: float, nbytes: float, f32: bool = False, kernel: bool = False):
        with _lock:
            self.flops += flops
            self.hbm_bytes += nbytes
            if f32:
                self.flops_f32 += flops
            if kernel:
                self.kernel_flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        t0 = time.perf_counter()
        kwargs = kwargs or {}
        t1 = time.perf_counter()
        out = func(*args, **kwargs)
        t2 = time.perf_counter()
        packet = func.overloadpacket
        name = packet.__name__.rstrip("_")
        flops = 0.0
        nbytes = 0.0
        f32 = False
        if not (func.is_view or name in _FREE):
            ins = list(_tensors((args, kwargs)))
            outs = list(_tensors(out))
            if name in _GATHERS:
                nbytes = 2 * sum(map(_nbytes, outs)) + sum(
                    _nbytes(t) for t in ins if not t.is_floating_point())
            elif name in _SCATTERS:
                nbytes = sum(_nbytes(t) * (1 if not t.is_floating_point() else 2)
                             for t in ins[1:])
            else:
                nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            fn = self._flop_registry.get(packet)
            if fn is not None:
                flops = float(fn(*args, **kwargs, out_val=out))
                f32 = any(t.dtype == torch.float32 for t in ins)
            elif name in _REDUCTIONS:
                flops = float(sum(t.numel() for t in ins[:1]))
            elif torch.Tag.pointwise in func.tags:
                flops = float(sum(t.numel() for t in outs[:1]))
        self.add(flops, nbytes, f32)
        self.ops += 1
        self.observer_us += ((t1 - t0) + (time.perf_counter() - t2)) * 1e6
        return out


class counting:
    """Context manager: a :class:`CostCounter` over its body (the program's
    first real call); ``counter`` after exit holds the counts."""

    def __init__(self):
        self.counter = CostCounter()

    def __enter__(self):
        with _lock:
            _ACTIVE.append(self.counter)
        self.counter.__enter__()
        return self.counter

    def __exit__(self, *exc):
        self.counter.__exit__(*exc)
        with _lock:
            _ACTIVE.remove(self.counter)
        return False


def note_kernel(flops: float, nbytes: float, f32: bool = False) -> None:
    """A hand-written kernel's report of one launch: its FLOPs and the bytes
    it must move, added to every open counting pass (none: a no-op)."""
    if _ACTIVE and not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        for c in list(_ACTIVE):
            c.add(flops, nbytes, f32, kernel=True)


def counting_active() -> bool:
    return bool(_ACTIVE)


# -- the gauges ---------------------------------------------------------------

class ProgramCosts:
    """Per-owner cache of counted program costs and the gauge writer. One
    instance per TrainStep / ServingEngine (programs keyed by name within
    an owner); the module-level singleton serves loose callers."""

    def __init__(self, spec=None):
        self._spec = spec
        self._costs: dict = {}
        self._lock = threading.Lock()
        # the last ratios before the gauges' clamp to [0, 1]: a ratio above 1
        # means a count below the work done, which the gauge cannot show
        self.unclamped: dict = {}

    def put(self, program: str, cost) -> None:
        with self._lock:
            self._costs[program] = cost

    def get(self, program: str):
        return self._costs.get(program)

    def wants(self, program: str) -> bool:
        """Whether ``program``'s next call should be counted: the tier is
        on, it has no cost yet and no counting pass is already open."""
        return enabled() and program not in self._costs and not _ACTIVE

    def record(self, program: str, counter: CostCounter, device=None) -> "ProgramCost":
        """Keep ``counter``'s counts as ``program``'s cost on ``device``'s spec."""
        cost = ProgramCost(program, spec_for(self._spec if self._spec is not None else device),
                           flops=counter.flops, flops_f32=counter.flops_f32,
                           hbm_bytes=counter.hbm_bytes, kernel_flops=counter.kernel_flops,
                           ops=counter.ops)
        self.put(program, cost)
        return cost

    def note_dispatch(self, program: str, wall_us: float):
        """Attribute one measured dispatch: set the MFU and roofline-
        fraction gauges of ``program``. Returns the MFU (None when the tier
        is off or the program has no cost)."""
        if not enabled() or wall_us <= 0:
            return None
        cost = self._costs.get(program)
        if cost is None or cost.flops <= 0:
            return None
        wall_s = wall_us * 1e-6
        raw = {"mfu": cost.flops / (wall_s * cost.spec.peak_flops),
               "roofline_frac": cost.projected_s / wall_s}
        self.unclamped[program] = raw
        mfu = _clamp01(raw["mfu"])
        telemetry.gauge("jit.program_mfu", program=program).set(mfu)
        telemetry.gauge("jit.program_roofline_frac", program=program).set(
            _clamp01(raw["roofline_frac"]))
        return mfu

    def note_decode_tokens(self, program: str, wall_us: float, tokens: int) -> None:
        """Serving decode: tokens/s against the roofline's tokens/s
        (``tokens`` in the program's projected time)."""
        if not enabled() or wall_us <= 0 or tokens <= 0:
            return
        cost = self.get(program)
        if cost is None or cost.projected_s <= 0:
            return
        roofline_tok_s = tokens / cost.projected_s
        actual_tok_s = tokens / (wall_us * 1e-6)
        self.unclamped["decode_roofline_frac"] = actual_tok_s / roofline_tok_s
        telemetry.gauge("serve.decode_roofline_tok_s").set(roofline_tok_s)
        telemetry.gauge("serve.decode_roofline_frac").set(
            _clamp01(self.unclamped["decode_roofline_frac"]))


class DeviceTimer:
    """The device time of a program: a CUDA event pair around its launches
    on the current stream, read once the end has passed; on the CPU the
    host's wall between ``start`` and ``stop``."""

    __slots__ = ("_events", "_t0", "_t1")

    def __init__(self, device):
        cuda = torch.device(device).type == "cuda"
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)) if cuda else None)
        self._t0 = self._t1 = 0.0

    def start(self):
        if self._events is not None:
            self._events[0].record()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._events is not None:
            self._events[1].record()
        self._t1 = time.perf_counter()

    def ready(self) -> bool:
        return self._events is None or self._events[1].query()

    def elapsed_us(self) -> float:
        """The measured wall in microseconds (call once :meth:`ready`)."""
        if self._events is None:
            return (self._t1 - self._t0) * 1e6
        return self._events[0].elapsed_time(self._events[1]) * 1e3


_singleton: ProgramCosts | None = None
_singleton_lock = threading.Lock()


def program_costs() -> ProgramCosts:
    global _singleton
    if _singleton is None:
        with _singleton_lock:
            if _singleton is None:
                _singleton = ProgramCosts()
    return _singleton


def reset() -> None:
    """Drop every cached cost (tests; telemetry.reset() hooks this)."""
    global _singleton
    _singleton = None


telemetry.register_reset_hook(reset)
