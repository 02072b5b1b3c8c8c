"""SGD, Adam and AdamW (counterpart of
``paddle_tpu/optimizer/algorithms.py:18-127``): the functional updates in
the parameter's dtype, each scalar rounded to that dtype first."""

from __future__ import annotations

import torch

from .optimizer import Optimizer, as_dtype, param_name

__all__ = ["SGD", "Adam", "AdamW"]


def _bias_corrections(b1, b2, t, dtype):
    """``1 - b^t`` in f32, then rounded to ``dtype``."""
    f32 = torch.float32
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=f32), torch.tensor(float(t), dtype=f32))
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=f32), torch.tensor(float(t), dtype=f32))
    return c1.to(dtype).item(), c2.to(dtype).item()


def _adam_moments(p, g, state, lr, t, b1, b2, eps):
    """(step, m, v) of Adam: ``lr * mhat / (sqrt(vhat) + eps)``."""
    dt = p.dtype
    m = state["m"] * as_dtype(b1, dt) + g * as_dtype(1 - b1, dt)
    v = state["v"] * as_dtype(b2, dt) + g.square() * as_dtype(1 - b2, dt)
    c1, c2 = _bias_corrections(b1, b2, t, dt)
    den = torch.sqrt(v / c2).add_(as_dtype(eps, dt))
    step = (m / c1).mul_(as_dtype(lr, dt)).div_(den)
    return step, m, v


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        (l2,) = hyper
        if l2:
            g = g + p * as_dtype(l2, p.dtype)
        return p - g * as_dtype(lr, p.dtype), state


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if lazy_mode:
            raise NotImplementedError("lazy_mode comes with the sparse slice of the port")
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd),
                self._beta1, self._beta2, self._epsilon)

    @classmethod
    def init_state(cls, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, b1, b2, eps = hyper
        if l2:
            g = g + p * as_dtype(l2, p.dtype)
        step, m, v = _adam_moments(p, g, state, lr, t, b1, b2, eps)
        return p - step, {"m": m, "v": v}


class AdamW(Optimizer):
    """Adam with decoupled weight decay: ``p * (1 - lr * wd)`` first, then
    the bias-corrected Adam step. ``apply_decay_param_fun(name)`` False,
    for the parameter's Paddle name (``param_name``), exempts it from the
    decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision, name)
        if lr_ratio is not None or lazy_mode:
            raise NotImplementedError("lr_ratio and lazy_mode come with a later slice of "
                                      "the port")
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)
        self._wd = (float(weight_decay) if isinstance(weight_decay, (int, float))
                    else float(getattr(weight_decay, "_coeff", 0.01)))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _hyper(self, wd=None):
        return (self._wd if wd is None else float(wd),
                self._beta1, self._beta2, self._epsilon)

    def _resolve_wd(self, p, wd):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(param_name(p))):
            return 0.0
        return wd

    @classmethod
    def init_state(cls, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        wd, b1, b2, eps = hyper
        dt = p.dtype
        lr_p = as_dtype(lr, dt)
        p = p * as_dtype(1 - as_dtype(lr_p * as_dtype(wd, dt), dt), dt)
        step, m, v = _adam_moments(p, g, state, lr, t, b1, b2, eps)
        return p.sub_(step), {"m": m, "v": v}
