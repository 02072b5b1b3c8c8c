"""Training and evaluation steps (counterpart of
``paddle_tpu/jit/training.py:92-979``, core semantics).

``TrainStep(model, optimizer, loss_fn)`` runs ``loss_fn(*batch)`` (which
calls the model), takes the gradient of the f32 loss with respect to every
trainable parameter by torch autograd, clips it with the optimizer's
clipper, and applies ``opt_cls.update(p, g.to(p.dtype), state, lr, t,
hyper)`` to each parameter in its own dtype, with state from
``opt_cls.init_state(p)``: no master weights, and one hyperparameter tuple
for every parameter, as the reference's compiled step has. The update is
one multi-tensor update in place (``optimizer/fused_step.py``
``apply_update``: on the card SGD, Momentum, Adam and AdamW are one kernel
launch for up to 128 tensors, the global-norm clip's scale applied inside
it), so the state is allocated once and updated in place. The step count
and the learning rate come from the optimizer. With ``accumulate_steps=k``
the gradients of k calls are summed in f32 and the k-th call applies their
mean (their sum with ``gradient_merge``'s ``avg=False``, which
``fleet.distributed_optimizer`` leaves on the optimizer with ``k_steps``,
the default of ``accumulate_steps``); the calls in between leave the
parameters, the step count and the learning rate alone.

Distributed: a ``DataParallel`` model's gradients are averaged over its
group (:meth:`~paddle_tpu_torch.distributed.DataParallel.reduce_gradients`)
before the clip; a sharded optimizer
(``distributed.fleet.sharding.GroupShardedOptimizer``: ZeRO stages,
``PartitionedTrainStep``) takes the gradients and runs its own sharded
update.

``recompute_policy`` ("none", "every_layer" or "selective", see
``distributed.recompute``) recomputes every repeated block of the model
in the backward: the loss runs inside ``remat_scope(model, policy)``. The
policy is resolved at every call, as the reference's: the keyword, else
``PADDLE_REMAT_POLICY``, else "none".

PyTorch runs eagerly, so there is nothing to compile: ``donate`` means the
parameters are updated in place, which they always are. A step runs as
the port's counterpart of the reference's traced program
(:func:`paddle_tpu_torch.tracing.traced`), and so does an ``EvalStep``
call, so the functionals that pick their form by tracing (``rms_norm``)
take the compiled steps'.

Observability, as the reference's (``profiler``): each call is one
``jit.dispatch`` span (``program`` "step", or "accum" and "merge" under
``accumulate_steps``) and one goodput ``step`` fold. Attribution counts
each program's FLOPs and bytes during its first call
(``profiler.attribution.counting``; the counter's own time is observer
time, taken out of the step's goodput wall) and sets
``jit.program_mfu{program}`` / ``jit.program_roofline_frac{program}``
from the program's device time (a CUDA event pair around it, read once
the device has passed it: at the numerics read, or at the next call).
The numerics sentinels (``numerics``: the keyword, else
``PADDLE_NUMERICS``, else "summary") are taken over the gradients the
update consumes (under a sharded optimizer, after its reduction: each
rank's slices, their statistics summed over the ranks) and the parameters
before it writes them, read in one copy a call, published, and watched
by the :class:`~paddle_tpu_torch.distributed.resilience.NumericsWatchdog`;
they are pure reads, so the step's outputs are the same bits with them
off.
``telemetry_export_every=N`` appends the registry's snapshot to
``telemetry_logdir`` (default ``./runs``) every N calls.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..distributed.recompute import remat_scope
from ..nn.clip import clip_descriptor
from ..ops import fused_optimizer
from ..optimizer import fused_step
from ..profiler import attribution as _attrib
from ..profiler import goodput as _goodput
from ..profiler import numerics as _numerics
from ..profiler import spans as _spans
from ..tracing import traced

__all__ = ["TrainStep", "EvalStep"]


# keyword -> the module of the port that brings it (the reference's module)
_LATER = {"offload_optimizer": "autopilot",
          "checkpoint_root": "distributed.resilience.verified"}


def _later(name):
    return NotImplementedError(f"TrainStep({name}=...) comes with the port's "
                               f"{_LATER[name]} module")


class TrainStep:
    """One optimizer step per call (or per ``accumulate_steps`` calls);
    returns the f32 loss, detached."""

    def __init__(self, model, optimizer, loss_fn, donate: bool = True, cast_fn=None,
                 accumulate_steps: int | None = None,
                 telemetry_export_every: int | None = None,
                 telemetry_logdir: str | None = None,
                 recompute_policy: str | None = None,
                 offload_optimizer: bool | None = None,
                 numerics: str | None = None,
                 checkpoint_root: str | None = None):
        for name, value in (("offload_optimizer", offload_optimizer),
                            ("checkpoint_root", checkpoint_root)):
            if value is not None:
                raise _later(name)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._cast_fn = cast_fn  # stored and never read, as in the reference
        self._ctor_policy = recompute_policy
        self._accum_k = int(accumulate_steps or getattr(optimizer, "_accumulate_steps", 1) or 1)
        self._accum_avg = bool(getattr(optimizer, "_accumulate_avg", True))
        self._micro = 0
        self._acc = None
        self._opt_state = None
        self._layout = (None, None)   # (signature, layout) of the update
        self._tel_every = int(telemetry_export_every or 0)
        self._tel_dir = telemetry_logdir or "./runs"
        self._tel_steps = 0
        self._calls = 0      # completed calls (the spans' step)
        self._prog_costs = _attrib.ProgramCosts()
        self._observer_us = 0.0
        self._pending = None  # (program, DeviceTimer) not yet attributed
        self._numerics_mode = _numerics.resolve_mode(numerics)
        self._num_watchdog = None

    def _params(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _policy(self) -> str:
        """The recompute policy of the next call: the keyword, else
        ``PADDLE_REMAT_POLICY``, else "none"."""
        return self._ctor_policy or os.environ.get("PADDLE_REMAT_POLICY") or "none"

    def _loss_and_grads(self, params, batch):
        with traced():
            with remat_scope(self.model, self._policy()):
                loss = self.loss_fn(*batch).float()
            grads = torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(params, grads)]
        return loss.detach(), grads

    def _program(self) -> str:
        """The program the next call runs: "step", or under accumulation
        "accum" (a micro-step) and "merge" (the k-th)."""
        if self._accum_k <= 1:
            return "step"
        return "merge" if (self._micro + 1) % self._accum_k == 0 else "accum"

    def _global_loss(self, loss):
        """The loss a call returns and publishes: this process's (a
        partitioned step's is the mean over its data ranks)."""
        return loss

    def _sentinels(self, loss, params, grads, reduced: bool = True):
        """The numerics sentinels of the gradients ``grads`` and the
        parameters before the update (None when off, or with nothing to
        train). Under a sharded optimizer they read each rank's part of
        the reduced gradients and of the parameters and fold their
        statistics over the ranks, so every rank holds the whole tensors'
        values; a micro-step's gradients (not ``reduced``) are reduced for
        them first."""
        if self._numerics_mode == "off" or not params:
            return None
        named = dict(params)
        parts_of = getattr(self.optimizer, "sentinel_parts", None)
        if parts_of is None:
            values, fold = [p.detach() for p in named.values()], None
        else:
            if not reduced:
                grads = self.optimizer.reduce_sharded(list(named.values()), grads)
            values, fold = parts_of(named)
        return _numerics.sentinel_tree(loss, dict(zip(named, grads)), dict(zip(named, values)),
                                       self._numerics_mode, reduce=fold)

    def __call__(self, *batch):
        t_wall0 = time.perf_counter()
        self._note_pending()
        params = self._params()
        program = self._program()
        device = params[0][1].device if params else torch.device("cpu")
        with _spans.span("jit.dispatch", step=self._calls, program=program):
            timer = _attrib.DeviceTimer(device)
            timer.start()
            count = _attrib.counting() if self._prog_costs.wants(program) else None
            with count if count is not None else contextlib.nullcontext():
                loss, sent = self._run(params, batch)
            timer.stop()
        if count is not None:
            self._observer_us += count.counter.observer_us
            self._prog_costs.record(program, count.counter, device)
        self._pending = (program, timer)
        self._handle_numerics(loss, sent)
        self._note_pending()
        self._maybe_export_telemetry()
        self._finish_step(t_wall0)
        return loss

    def _run(self, params, batch):
        """One call's work: ``(loss, sentinels)``."""
        opt = self.optimizer
        loss, grads = self._loss_and_grads(params, batch)
        loss = self._global_loss(loss)
        if self._accum_k > 1:
            self._micro += 1
            if self._acc is None:
                self._acc = [torch.zeros_like(p, dtype=torch.float32) for _, p in params]
            if self._micro % self._accum_k != 0:
                for a, g in zip(self._acc, grads):
                    a.add_(g.float())
                return loss, self._sentinels(loss, params, grads, reduced=False)
            denom = self._accum_k if self._accum_avg else 1
            grads = [(a + g.float()) / denom for a, g in zip(self._acc, grads)]
            self._acc = None
        sync = getattr(self.model, "reduce_gradients", None)
        if sync is not None:
            grads = sync([p for _, p in params], grads)
        sharded = getattr(opt, "apply_sharded", None)
        if sharded is not None:
            grads = opt.reduce_sharded([p for _, p in params], grads)
        # taken before the update writes the parameters, on the same stream
        sent = self._sentinels(loss, params, grads)
        opt._step_count += 1
        if sharded is not None:
            sharded([p for _, p in params], grads, reduced=True)
            return loss, sent
        lr = opt.get_lr()
        t = opt._step_count
        if self._opt_state is None:
            self._opt_state = [type(opt).init_state(p.detach()) for _, p in params]
        desc = clip_descriptor(opt._grad_clip)
        if desc is NotImplemented:
            raise TypeError(f"unknown gradient clipper {type(opt._grad_clip).__name__}")
        grads, scale = fused_step.clip(desc, grads, [True] * len(grads))
        hyper = opt._hyper()
        cls = type(opt)
        entries = [fused_optimizer.Entry(p.detach(), g, state, lr, hyper, scale)
                   for (_, p), g, state in zip(params, grads, self._opt_state)]
        sig = tuple(map(fused_optimizer.signature, entries))
        if self._layout[0] != sig:
            self._layout = (sig, fused_step.layout_of(cls, entries))
        with torch.no_grad():
            fused_step.apply_update(cls, entries, t, self._layout[1])
        return loss, sent

    def _note_pending(self):
        """Attribute the last program's device time once the device has
        passed its end event."""
        if self._pending is not None and self._pending[1].ready():
            program, timer = self._pending
            self._pending = None
            self._prog_costs.note_dispatch(program, timer.elapsed_us())

    def _handle_numerics(self, loss, sent) -> None:
        """Host half of the sentinels: read the tree (one copy, so one
        synchronisation), publish it and run the watchdog."""
        if sent is None:
            return
        host = _numerics.host_sentinels(sent)
        loss_val = float(loss)
        try:
            _numerics.publish(host, loss=loss_val)
            if self._num_watchdog is None:
                from ..distributed.resilience.watchdog import NumericsWatchdog

                # no train_step: the watchdog would use it only to roll back
                # (not in the port yet), and a step held by its own watchdog
                # is a cycle that keeps its optimizer state alive until a
                # garbage collection
                self._num_watchdog = NumericsWatchdog()
            self._num_watchdog.observe(self._calls, loss_val, host)
        except Exception as e:  # observability must never take down the step loop
            import warnings

            warnings.warn(f"TrainStep: the numerics fold failed: {e!r}", RuntimeWarning,
                          stacklevel=2)

    def _finish_step(self, t_wall0: float) -> None:
        """Goodput fold: one completed call is one step; its wall time less
        the observer's (the counting pass) books productive minus the
        losses noted in the window."""
        self._calls += 1
        wall_us = (time.perf_counter() - t_wall0) * 1e6
        wall_us = max(wall_us - self._observer_us, 0.0)
        self._observer_us = 0.0
        _goodput.step(wall_us, kind="train", scope=id(self))

    def _maybe_export_telemetry(self):
        """One registry snapshot appended to ``telemetry_logdir`` every
        ``telemetry_export_every`` calls (a micro-step is a call)."""
        if self._tel_every <= 0:
            return
        self._tel_steps += 1
        if self._tel_steps % self._tel_every == 0:
            from ..profiler import telemetry as _telemetry

            _telemetry.export_jsonl(self._tel_dir, step=self._tel_steps)


class EvalStep:
    """``fn(*batch)`` without gradients, as a traced call (the reference's
    ``EvalStep`` is a compiled program too); returns its tensors as a
    list."""

    def __init__(self, model, fn):
        self.model = model
        self.fn = fn

    @torch.no_grad()
    def __call__(self, *batch):
        with traced():
            out = self.fn(*batch)
        if torch.is_tensor(out):
            return [out]
        if isinstance(out, dict):
            return list(out.values())
        return list(out)
