"""paddle.amp for the port: automatic mixed precision (counterpart of
``paddle_tpu/amp/__init__.py``).

- :class:`auto_cast` (alias ``amp_guard``) sets a thread-local policy,
  levels O1 and O2, with the reference's op lists (``WHITE_LIST``,
  ``BLACK_LIST``) and :func:`should_cast`'s precedence.
- The reference casts an op's floating inputs inside its op dispatcher
  (``autograd/engine.py`` ``_amp_wrap``). The port has no dispatcher: each
  functional whose reference counterpart names its op calls
  :func:`cast_inputs` with that name on its tensor inputs first. "low"
  casts f32 inputs to the amp dtype, "high" bf16 and fp16 inputs to f32;
  ``Tensor.to`` casts the gradient back to the input's dtype, as the
  reference's cast inside the op does. Not ``torch.autocast``: its op
  lists, output dtypes and cache of cast weights are not the reference's.
  The port's functionals then pick their route from the dtypes that
  arrive (the RMSNorm kernel in f32, flash in bf16 or fp16), where the
  reference picks it from the uncast ones; values agree, routes may not.
- :func:`decorate` casts every floating parameter and buffer of the models
  to the amp dtype at O2 (each ``Parameter`` object kept, its ``.data``
  swapped, so an optimizer built before still holds it) and sets
  ``_multi_precision`` on the optimizers: their f32 master weights are
  made at the first step (``Optimizer._state_of``), and the fused step's
  kernel writes the low-precision copy.
- :class:`GradScaler`: dynamic loss scaling with the reference's
  arithmetic. Its unscale is one pass over every gradient, multiplied by
  ``1/scale`` rounded to each gradient's dtype, with one found-inf verdict
  a gradient and one host read a step; ``PADDLE_OPT_FUSED=0`` keeps the
  reference's per-gradient loop (one host read a gradient).

Counts the reference keeps in its telemetry registry are plain integers
here (:func:`stats`).
"""

from __future__ import annotations

import copy
import threading

import torch

from ..dtype import convert_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "GradScaler", "amp_guard", "amp_state", "auto_cast",
           "cast_inputs", "debugging", "decorate", "should_cast", "stats"]

_stats = {"unscale_dispatches": 0}


def stats() -> dict:
    """Counts since import: ``unscale_dispatches`` (a fused unscale is one;
    the per-gradient loop one a gradient). The reference also counts hits
    of its cache of compiled unscales; the port compiles nothing, so it
    has no such cache to count."""
    return copy.deepcopy(_stats)


# ≙ amp_lists.py white/black lists: ops that should run in low precision
# (matmul-class) vs must stay fp32 (softmax/norm/reduction-class).
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "einsum", "bmm", "mm",
    "flash_attention", "sdpa",
}
BLACK_LIST = {
    "exp", "log", "softmax", "log_softmax", "cross_entropy", "mse_loss",
    "layer_norm", "batch_norm", "rms_norm", "group_norm", "instance_norm",
    "sum", "mean", "logsumexp", "softmax_with_cross_entropy", "nll_loss",
    "cumsum", "norm",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


class auto_cast:
    """``paddle.amp.auto_cast``: within the block, ops cast their inputs by
    :func:`should_cast`; the previous state comes back on exit."""

    def __init__(self, enable=True, custom_white_list=None, custom_black_list=None,
                 level="O1", dtype="bfloat16", use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = convert_dtype(dtype)
        self.white = set(custom_white_list or ())
        self.black = set(custom_black_list or ())

    def __enter__(self):
        self._prev = (_state.enabled, _state.dtype, _state.level,
                      _state.custom_white, _state.custom_black)
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.custom_white = self.white
        _state.custom_black = self.black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._prev
        return False


amp_guard = auto_cast


def should_cast(op_name: str) -> str | None:
    """"low", "high" or None for an op under the active policy: a custom
    black or ``BLACK_LIST`` op runs high; at O2 every other op runs low; at
    O1 a custom white or ``WHITE_LIST`` op runs low."""
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return "high"
    if _state.level == "O2":
        return "low"
    if op_name in _state.custom_white or op_name in WHITE_LIST:
        return "low"
    return None


def cast_inputs(op_name: str, *xs) -> tuple:
    """``xs`` cast as the op ``op_name`` casts its inputs under the active
    policy: "low" f32 tensors to the amp dtype, "high" bf16 and fp16
    tensors to f32; anything else (None, integer tensors, other dtypes)
    as given."""
    if not _state.enabled:
        return xs
    policy = should_cast(op_name)
    if policy == "low":
        low = _state.dtype
        return tuple(x.to(low) if torch.is_tensor(x) and x.dtype == torch.float32 else x
                     for x in xs)
    if policy == "high":
        return tuple(x.float() if torch.is_tensor(x) and x.dtype in (torch.bfloat16,
                                                                     torch.float16) else x
                     for x in xs)
    return xs


@torch.no_grad()
def _cast_module(model, dtype) -> None:
    """Every floating parameter and buffer of ``model`` to ``dtype`` in
    place of its ``.data``, so each tensor object stays the same."""
    for t in list(model.parameters()) + [b for b in model.buffers() if b is not None]:
        if t.dtype.is_floating_point:
            t.data = t.data.to(dtype)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """``paddle.amp.decorate``: at O2 the models' floating parameters and
    buffers become ``dtype``; every optimizer keeps f32 master weights
    (``_multi_precision``), at any level. Returns what it was given: a
    model or a list, then the optimizer(s) when given."""
    d = convert_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            _cast_module(m, d)
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for o in opt_list:
            o._multi_precision = True
        if single_model and single_opt:
            return model_list[0], opt_list[0]
        return (model_list if not single_model else model_list[0],
                opt_list if not single_opt else opt_list[0])
    return model_list[0] if single_model else model_list


def _finite(g):
    """A 0-dim bool tensor: every element of ``g`` finite (min and max are
    NaN where any element is, infinite where any is; no temporary the size
    of ``g``)."""
    if g.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=g.device)
    lo, hi = torch.aminmax(g)
    return torch.isfinite(lo) & torch.isfinite(hi)


def _inv_as(inv: float, dtype, device):
    """``inv`` as a 0-dim tensor of ``dtype``, rounded through f32 as the
    reference's ``inv.astype(g.dtype)`` rounds it."""
    return torch.tensor(inv, dtype=torch.float32).to(dtype).to(device)


def _fused_unscale(grads, inv: float):
    """Every gradient multiplied in place by ``inv`` rounded to its dtype
    (one multi-tensor multiply a dtype), and the per-gradient finite
    verdicts (min and max of each, stacked once), read to the host at
    once: one host read for the whole set. Returns the verdicts, a list
    of bools."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, gs in by_dtype.items():
        # the rounded inv times a value of its dtype is exact in f32, so
        # the one rounding of the product is the reference's
        torch._foreach_mul_(gs, _inv_as(inv, dtype, "cpu").item())
    ends = [torch.aminmax(g) if g.numel() else (g.new_zeros(()),) * 2 for g in grads]
    ok = torch.isfinite(torch.stack([t.float() for pair in ends for t in pair]))
    return ok.view(-1, 2).all(1).tolist()


class GradScaler:
    """``paddle.amp.GradScaler``: dynamic loss scaling; a step whose
    unscaled gradients hold a NaN or Inf is skipped and the scale backs
    off."""

    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # ids of optimizers already unscaled this step

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale (a multiply
        by ``1/scale`` rounded to the gradient's dtype) once a step, and
        note whether any came out NaN or Inf."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        from ..optimizer.fused_step import fused_enabled

        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list if p.grad is not None]
        if fused_enabled() and grads:
            fin = _fused_unscale(grads, inv)
            _stats["unscale_dispatches"] += 1
            if not all(fin):
                self._found_inf = True
        else:
            for g in grads:
                g.mul_(_inv_as(inv, g.dtype, g.device))
                _stats["unscale_dispatches"] += 1
                if not bool(_finite(g)):
                    self._found_inf = True
        self._unscaled.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled.discard(id(optimizer))

    def update(self):
        self._unscaled.clear()
        if not self._enable or not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale_ratio(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


class debugging:
    """≙ ``paddle.amp.debugging``: tensor checks."""

    @staticmethod
    def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
        """``(n_nan, n_inf)`` of ``tensor``; raises ``FloatingPointError``
        when either is nonzero."""
        a = torch.as_tensor(tensor).detach()
        n_nan = int(torch.isnan(a).sum()) if a.is_floating_point() else 0
        n_inf = int(torch.isinf(a).sum()) if a.is_floating_point() else 0
        if n_nan or n_inf:
            raise FloatingPointError(
                f"check_numerics: {n_nan} NaN, {n_inf} Inf in {var_name or 'tensor'} "
                f"({op_type})")
        return n_nan, n_inf

    @staticmethod
    def enable_tensor_checker(config=None):
        raise NotImplementedError(
            "the tensor checker (a NaN/Inf check after every op) comes with the port's op "
            "surface: its op dispatcher and registry (paddle_tpu/autograd/engine.py, "
            "ops/registry.py)")

    @staticmethod
    def disable_tensor_checker():
        raise NotImplementedError(
            "the tensor checker (a NaN/Inf check after every op) comes with the port's op "
            "surface: its op dispatcher and registry (paddle_tpu/autograd/engine.py, "
            "ops/registry.py)")
