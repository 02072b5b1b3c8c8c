"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py:48-224``).

Every optimizer is a functional core on torch tensors,

    init_state(param)                    -> {name: tensor}
    update(p, g, state, lr, t, hyper)    -> (new_p, new_state)

which :meth:`Optimizer.step` applies to every parameter group at once, as
one multi-tensor update in place (``fused_step.py``: the hand-written
kernel for SGD, Momentum, Adam and AdamW, the composed update for the
others), or, with ``PADDLE_OPT_FUSED=0``, per parameter (the reference's
per-parameter regime, each update composed of torch ops); and which
``jit.TrainStep`` applies to its own state through the same multi-tensor
update. ``lr`` is a Python float; ``update`` rounds it, and every other
scalar it uses, to the parameter's dtype before the arithmetic, as the
reference's typed arrays do. Parameters are ``torch.nn.Parameter``s. A
parameter's Paddle name is its ``paddle_name`` attribute (torch keeps
``Tensor.name`` for itself), "" when unset as in the reference; it and
``p.need_clip`` (default True) are read where the reference reads
``p.name`` and ``p.need_clip``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import fused_step as _fused
from .lr import LRScheduler

__all__ = ["Optimizer", "as_dtype", "param_name"]


def as_dtype(x: float, dtype) -> float:
    """The Python float ``x`` rounded to ``dtype`` (through f32), the value
    a scalar takes in the reference's arithmetic on a ``dtype`` array."""
    return torch.tensor(float(x), dtype=torch.float32).to(dtype).item()


def param_name(p) -> str:
    """The Paddle name of parameter ``p`` ("" when unset)."""
    return getattr(p, "paddle_name", "")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if weight_decay is None:
            self._l2_coeff = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._l2_coeff = float(weight_decay)
        else:  # an L2Decay-like object
            self._l2_coeff = float(getattr(weight_decay, "_coeff",
                                           getattr(weight_decay, "coeff", 0.0)))
        self._param_groups = []
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                for g in parameters:
                    self._add_param_group(g)
            else:
                self._add_param_group({"params": parameters})
        self._accumulators: dict[int, dict[str, Any]] = {}
        self._step_count = 0
        self._master_weights: dict[int, torch.Tensor] = {}

    def _add_param_group(self, group: dict):
        group = dict(group)
        group["params"] = list(group["params"])
        self._param_groups.append(group)

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("optimizer's learning rate is an LRScheduler; call "
                               "scheduler APIs")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a gradient: per group, clip
        the group's gradients, then update each parameter with the group's
        ``learning_rate`` and ``weight_decay`` where given; as one fused
        multi-tensor update unless ``PADDLE_OPT_FUSED=0`` or the clip is a
        callable of its own, else parameter by parameter."""
        self._step_count += 1
        if _fused.fused_enabled() and _fused.run_fused_step(self):
            return
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.grad is not None and p.requires_grad]
            if not params_grads:
                continue
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            lr = group.get("learning_rate", None)
            base_lr = self.get_lr() if lr is None else float(lr() if callable(lr) else lr)
            wd = group.get("weight_decay", None)
            for p, g in params_grads:
                self._apply_one(p, g, base_lr, wd)

    def _state_of(self, p) -> dict:
        """``p``'s state, made on first use (with its f32 master copy under
        ``multi_precision`` for a bf16 or fp16 parameter)."""
        pid = id(p)
        if pid not in self._accumulators:
            master = p.detach()
            if self._multi_precision and p.dtype in (torch.float16, torch.bfloat16):
                master = p.detach().float()
                self._master_weights[pid] = master
            self._accumulators[pid] = self.init_state(master)
        return self._accumulators[pid]

    @staticmethod
    def _lr_of(p, lr: float) -> float:
        """The group's rate times ``p.optimize_attr["learning_rate"]``."""
        return lr * getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)

    def _apply_one(self, p, g, lr: float, wd=None):
        wd = self._resolve_wd(p, wd)
        pid = id(p)
        state = self._state_of(p)
        param = self._master_weights.get(pid, p.detach())
        _fused.count_dispatch()
        new_p, self._accumulators[pid] = type(self).update(
            param, g.to(param.dtype), state, self._lr_of(p, lr), self._step_count,
            self._hyper(wd))
        if pid in self._master_weights:
            self._master_weights[pid] = new_p
        p.copy_(new_p)

    def _hyper(self, wd=None) -> tuple:
        """Static hyperparameters of the functional update."""
        return (self._l2_coeff if wd is None else float(wd),)

    def _resolve_wd(self, p, wd):
        """Per-parameter weight-decay override (AdamW's
        ``apply_decay_param_fun``)."""
        return wd

    @classmethod
    def init_state(cls, param) -> dict:
        return {}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def _key(self, i, p):
        return param_name(p) or f"param_{i}"

    def state_dict(self) -> dict:
        """``{"_step_count", "states": {key: {slot: tensor}},
        "master_weights": {key: tensor}}`` plus ``"LR_Scheduler"``, the
        reference's keys; a parameter's key is its ``name`` or
        ``param_{i}``. Tensors are copies."""
        sd = {"_step_count": self._step_count, "states": {}, "master_weights": {}}
        for i, p in enumerate(self._parameter_list):
            key = self._key(i, p)
            if id(p) in self._accumulators:
                sd["states"][key] = {k: v.clone() for k, v in self._accumulators[id(p)].items()}
            if id(p) in self._master_weights:
                sd["master_weights"][key] = self._master_weights[id(p)].clone()
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        """Load a :meth:`state_dict` (tensors or numpy arrays), each slot
        placed on its parameter's device."""
        def own(v, p):
            return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=p.device).clone()

        self._step_count = state_dict.get("_step_count", 0)
        states = state_dict.get("states", {})
        masters = state_dict.get("master_weights", {})
        for i, p in enumerate(self._parameter_list):
            key = self._key(i, p)
            if key in states:
                self._accumulators[id(p)] = {k: own(v, p) for k, v in states[key].items()}
            if key in masters:
                self._master_weights[id(p)] = own(masters[key], p)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        """``loss.backward()`` then :meth:`step`."""
        loss.backward()
        self.step()
        return None, None
