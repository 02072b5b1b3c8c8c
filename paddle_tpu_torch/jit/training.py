"""Training and evaluation steps (counterpart of
``paddle_tpu/jit/training.py:92-979``, core semantics).

``TrainStep(model, optimizer, loss_fn)`` runs ``loss_fn(*batch)`` (which
calls the model), takes the gradient of the f32 loss with respect to every
trainable parameter by torch autograd, clips it with the optimizer's
clipper, and applies ``opt_cls.update(p, g.to(p.dtype), state, lr, t,
hyper)`` to each parameter in its own dtype, with state from
``opt_cls.init_state(p)``: no master weights, and one hyperparameter tuple
for every parameter, as the reference's compiled step has. The step count
and the learning rate come from the optimizer. With ``accumulate_steps=k``
the gradients of k calls are summed in f32 and the k-th call applies their
mean; the calls in between leave the parameters, the step count and the
learning rate alone.

PyTorch runs eagerly, so there is nothing to compile: ``donate`` means the
parameters are updated in place, which they always are. A step runs as
the port's counterpart of the reference's traced program
(:func:`paddle_tpu_torch.tracing.traced`), and so does an ``EvalStep``
call, so the functionals that pick their form by tracing (``rms_norm``)
take the compiled steps'.
"""

from __future__ import annotations

import torch

from ..nn.clip import clip_grads
from ..tracing import traced

__all__ = ["TrainStep", "EvalStep"]


# keyword -> the later slice of the port (ROADMAP queue 1) that brings it
_LATER = {"cast_fn": "amp (item 10)",
          "telemetry_export_every": "observability (item 12)",
          "telemetry_logdir": "observability (item 12)",
          "numerics": "observability (item 12)",
          "recompute_policy": "distributed (item 11, recompute and autopilot)",
          "offload_optimizer": "distributed (item 11, autopilot)",
          "checkpoint_root": "distributed (item 11, checkpoint)"}


def _later(name):
    return NotImplementedError(f"TrainStep({name}=...) comes with the {_LATER[name]} slice "
                               "of the port")


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
        for name, value in (("cast_fn", cast_fn),
                            ("telemetry_export_every", telemetry_export_every),
                            ("telemetry_logdir", telemetry_logdir),
                            ("recompute_policy", recompute_policy),
                            ("offload_optimizer", offload_optimizer),
                            ("checkpoint_root", checkpoint_root)):
            if value is not None:
                raise _later(name)
        if numerics not in (None, "off"):
            raise _later("numerics")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._accum_k = int(accumulate_steps or 1)
        self._micro = 0
        self._acc = None
        self._opt_state = None

    def _params(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _loss_and_grads(self, params, batch):
        with traced():
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
        grads = clip_grads(opt._grad_clip, grads)
        hyper = opt._hyper()
        with torch.no_grad():
            for i, ((_, p), g) in enumerate(zip(params, grads)):
                new_p, self._opt_state[i] = type(opt).update(
                    p.detach(), g.to(p.dtype), self._opt_state[i], lr, t, hyper)
                p.copy_(new_p)
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
