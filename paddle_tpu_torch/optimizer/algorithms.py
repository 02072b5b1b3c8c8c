"""The optimizers (counterpart of ``paddle_tpu/optimizer/algorithms.py``):
the functional updates in the parameter's dtype, each scalar rounded to
that dtype first. SGD, Momentum, Adam and AdamW also run as one CUDA
kernel over many tensors (``ops/fused_optimizer.py``), which repeats these
updates' arithmetic op by op; the others run as written here."""

from __future__ import annotations

import torch

from .optimizer import Optimizer, as_dtype, param_name

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp", "Adadelta", "Adamax",
           "Lamb", "Lars"]


def _one_minus_pow(b, t):
    """``1 - b^t`` in f32, as a 0-dim f32 tensor on the CPU."""
    f32 = torch.float32
    return 1 - torch.pow(torch.tensor(b, dtype=f32), torch.tensor(float(t), dtype=f32))


def _bias_corrections(b1, b2, t, dtype):
    """``1 - b^t`` in f32, then rounded to ``dtype``."""
    return (_one_minus_pow(b1, t).to(dtype).item(), _one_minus_pow(b2, t).to(dtype).item())


def _l2(g, p, l2):
    """``g + l2 * p`` (L2 regularisation) when ``l2`` is set."""
    return g + p * as_dtype(l2, p.dtype) if l2 else g


def _f32_norm(x):
    return torch.linalg.vector_norm(x, dtype=torch.float32)


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
        g = _l2(g, p, l2)
        return p - g * as_dtype(lr, p.dtype), state


class Momentum(Optimizer):
    """``v = mu v + g``; the step is ``v``, or ``g + mu v`` with
    ``use_nesterov``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd), self._momentum, self._nesterov)

    @classmethod
    def init_state(cls, param):
        return {"velocity": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, mu, nesterov = hyper
        dt = p.dtype
        g = _l2(g, p, l2)
        v = state["velocity"] * as_dtype(mu, dt) + g
        step = g + v * as_dtype(mu, dt) if nesterov else v
        return p - step * as_dtype(lr, dt), {"velocity": v}


class Adam(Optimizer):
    """Bias-corrected Adam; ``lazy_mode`` is taken and ignored (every row
    updated), as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
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
        g = _l2(g, p, l2)
        step, m, v = _adam_moments(p, g, state, lr, t, b1, b2, eps)
        return p - step, {"m": m, "v": v}


class AdamW(Optimizer):
    """Adam with decoupled weight decay: ``p * (1 - lr * wd)`` first, then
    the bias-corrected Adam step. ``apply_decay_param_fun(name)`` False,
    for the parameter's Paddle name (``param_name``), exempts it from the
    decay. ``lr_ratio`` and ``lazy_mode`` are taken and ignored, as in the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision, name)
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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd), self._epsilon, self._init_acc)

    @classmethod
    def init_state(cls, param):
        return {"moment": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, eps, _ = hyper
        dt = p.dtype
        g = _l2(g, p, l2)
        acc = state["moment"] + g.square()
        return p - g * as_dtype(lr, dt) / (torch.sqrt(acc) + as_dtype(eps, dt)), {"moment": acc}


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2`` (``centered``: minus the square of
    the running mean of g), ``v = mu v + lr g / sqrt(ms + eps)``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd), self._rho, self._epsilon,
                self._momentum, self._centered)

    @classmethod
    def init_state(cls, param):
        return {"mean_square": torch.zeros_like(param), "mean_grad": torch.zeros_like(param),
                "velocity": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, rho, eps, mu, centered = hyper
        dt = p.dtype
        g = _l2(g, p, l2)
        rho_, rest = as_dtype(rho, dt), as_dtype(1 - rho, dt)
        ms = state["mean_square"] * rho_ + g.square() * rest
        mg = state["mean_grad"] * rho_ + g * rest if centered else state["mean_grad"]
        denom = ms - mg.square() if centered else ms
        v = (state["velocity"] * as_dtype(mu, dt)
             + g * as_dtype(lr, dt) / torch.sqrt(denom + as_dtype(eps, dt)))
        return p - v, {"mean_square": ms, "mean_grad": mg, "velocity": v}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = float(rho), float(epsilon)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd), self._rho, self._epsilon)

    @classmethod
    def init_state(cls, param):
        return {"avg_sq_grad": torch.zeros_like(param),
                "avg_sq_update": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, rho, eps = hyper
        dt = p.dtype
        g = _l2(g, p, l2)
        rho_, rest, eps_ = as_dtype(rho, dt), as_dtype(1 - rho, dt), as_dtype(eps, dt)
        asg = state["avg_sq_grad"] * rho_ + g.square() * rest
        upd = torch.sqrt(state["avg_sq_update"] + eps_) / torch.sqrt(asg + eps_) * g
        asu = state["avg_sq_update"] * rho_ + upd.square() * rest
        return p - upd * as_dtype(lr, dt), {"avg_sq_grad": asg, "avg_sq_update": asu}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)

    def _hyper(self, wd=None):
        return (self._l2_coeff if wd is None else float(wd), self._beta1, self._beta2,
                self._epsilon)

    @classmethod
    def init_state(cls, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        l2, b1, b2, eps = hyper
        dt = p.dtype
        g = _l2(g, p, l2)
        m = state["m"] * as_dtype(b1, dt) + g * as_dtype(1 - b1, dt)
        u = torch.maximum(state["u"] * as_dtype(b2, dt), g.abs())
        # lr / (1 - b1^t) in f32, then rounded to the dtype
        lr_t = (torch.tensor(lr, dtype=torch.float32) / _one_minus_pow(b1, t)).to(dt).item()
        return p - m * lr_t / (u + as_dtype(eps, dt)), {"m": m, "u": u}


class Lamb(Optimizer):
    """Adam's step plus decoupled decay, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0);
    ``exclude_from_weight_decay_fn(p)`` True exempts ``p`` from the decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = float(beta1), float(beta2), float(epsilon)
        self._wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hyper(self, wd=None):
        return (self._wd if wd is None else float(wd), self._beta1, self._beta2, self._epsilon)

    def _resolve_wd(self, p, wd):
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return wd

    @classmethod
    def init_state(cls, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        wd, b1, b2, eps = hyper
        dt = p.dtype
        m = state["m"] * as_dtype(b1, dt) + g * as_dtype(1 - b1, dt)
        v = state["v"] * as_dtype(b2, dt) + g.square() * as_dtype(1 - b2, dt)
        c1, c2 = _bias_corrections(b1, b2, t, dt)
        r = (m / c1) / (torch.sqrt(v / c2) + as_dtype(eps, dt)) + p * as_dtype(wd, dt)
        w_norm, r_norm = _f32_norm(p), _f32_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0).to(dt)
        return p - trust * as_dtype(lr, dt) * r, {"m": m, "v": v}


class Lars(Momentum):
    """LARS: Momentum with the local rate ``coeff |p| / (|g| + wd |p| +
    1e-12)`` (1 where either norm is 0) and decay ``wd``; a parameter whose
    Paddle name contains one of ``exclude_from_weight_decay`` is not
    decayed."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 multi_precision=False, name=None, exclude_from_weight_decay=None):
        super().__init__(learning_rate, momentum, parameters, False, None, grad_clip,
                         multi_precision, name)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._exclude_names = list(exclude_from_weight_decay or [])

    def _resolve_wd(self, p, wd):
        if wd is None and any(s in param_name(p) for s in self._exclude_names):
            return 0.0
        return wd

    def _hyper(self, wd=None):
        return (self._lars_wd if wd is None else float(wd), self._momentum, self._lars_coeff)

    @classmethod
    def update(cls, p, g, state, lr, t, hyper):
        wd, mu, coeff = hyper
        dt = p.dtype
        w_norm, g_norm = _f32_norm(p), _f32_norm(g)
        local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                               coeff * w_norm / (g_norm + wd * w_norm + 1e-12), 1.0).to(dt)
        eff = local_lr * as_dtype(lr, dt)
        v = state["velocity"] * as_dtype(mu, dt) + eff * (g + p * as_dtype(wd, dt))
        return p - v, {"velocity": v}
