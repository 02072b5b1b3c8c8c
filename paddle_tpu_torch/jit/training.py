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
mean; the calls in between leave the parameters, the step count and the
learning rate alone.

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
"""

from __future__ import annotations

import os

import torch

from ..distributed.recompute import remat_scope
from ..nn.clip import clip_descriptor
from ..ops import fused_optimizer
from ..optimizer import fused_step
from ..tracing import traced

__all__ = ["TrainStep", "EvalStep"]


# keyword -> the module of the port that brings it (the reference's module)
_LATER = {"telemetry_export_every": "profiler.telemetry",
          "telemetry_logdir": "profiler.telemetry",
          "numerics": "profiler.numerics",
          "offload_optimizer": "autopilot",
          "checkpoint_root": "distributed.checkpoint"}


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
        for name, value in (("telemetry_export_every", telemetry_export_every),
                            ("telemetry_logdir", telemetry_logdir),
                            ("offload_optimizer", offload_optimizer),
                            ("checkpoint_root", checkpoint_root)):
            if value is not None:
                raise _later(name)
        if numerics not in (None, "off"):
            raise _later("numerics")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._cast_fn = cast_fn  # stored and never read, as in the reference
        self._ctor_policy = recompute_policy
        self._accum_k = int(accumulate_steps or 1)
        self._micro = 0
        self._acc = None
        self._opt_state = None
        self._layout = (None, None)   # (signature, layout) of the update

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

    def __call__(self, *batch):
        params = self._params()
        opt = self.optimizer
        loss, grads = self._loss_and_grads(params, batch)
        if self._accum_k > 1:
            self._micro += 1
            if self._acc is None:
                self._acc = [torch.zeros_like(p, dtype=torch.float32) for _, p in params]
            if self._micro % self._accum_k != 0:
                for a, g in zip(self._acc, grads):
                    a.add_(g.float())
                return loss
            grads = [(a + g.float()) / self._accum_k for a, g in zip(self._acc, grads)]
            self._acc = None
        opt._step_count += 1
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
        return loss


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
