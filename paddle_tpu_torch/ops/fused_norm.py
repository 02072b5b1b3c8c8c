"""Fused RMSNorm and SwiGLU: the Hopper kernels' wrappers, their plain
versions and the autograd ops.

Counterpart of ``paddle_tpu/ops/pallas/fused_norm.py``:

- :79 ``rms_norm_2d`` (forward ``_rms_fwd_kernel`` :45, backward dx
  ``_rms_bwd_dx_kernel`` :55; dW is a plain row sum there and here),
  kernels in ``csrc/rms_norm.cu``;
- :152 ``swiglu_2d`` (``_swiglu_fwd_kernel`` :135, ``_swiglu_bwd_kernel``
  :141), kernels in ``csrc/swiglu.cu``. Like the reference's, it is for
  explicit use: the Llama MLP and ``nn.functional.swiglu`` stay composed.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which repeats the kernel's arithmetic:
f32 inside, one rounding of each output to the storage type.

RMSNorm has two modes. The fused one (the reference's Pallas kernel, which
its eager calls reach) applies the weight in f32 before the one rounding.
``round_first`` is the reference's composed form (``norm.py:80-94``, what
its traced calls and its compiled ``TrainStep`` run): the normalised row is
rounded to the storage type, then multiplied by the weight in that type;
the backward is that form's gradient (``dO * w`` rounded before the
reduction, dW from the rounded row).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm_2d", "rms_norm_fwd", "rms_norm_fwd_ref", "rms_norm_bwd_dx",
           "rms_norm_bwd_dx_ref", "rms_norm_dw", "swiglu_2d", "swiglu_fwd", "swiglu_fwd_ref",
           "swiglu_bwd", "swiglu_bwd_ref", "DTYPES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MODES = {False: "fused", True: "round_first"}   # RMSNorm's two roundings, by round_first


def _first(v, dtype, round_first: bool):
    """v rounded to ``dtype`` and back to f32 where the mode rounds first."""
    return v.to(dtype).float() if round_first else v


def rms_norm_fwd_ref(x, w, eps: float, round_first: bool = False):
    """Plain forward: x [N, H], w [H] -> (out [N, H] in x's dtype, inv f32
    [N]) with ``inv = rsqrt(mean(x^2) + eps)`` and ``out = x * inv * w``
    in f32 (``round_first``: ``x * inv`` rounded to x's dtype first)."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1) + eps)
    return (_first(x32 * inv[:, None], x.dtype, round_first) * w.float()).to(x.dtype), inv


def rms_norm_bwd_dx_ref(x, w, inv, dout, round_first: bool = False):
    """Plain backward dx: ``inv * g - x * inv^3 * sum(g * x) / H`` in f32
    with ``g = dO * w`` (``round_first``: rounded to x's dtype), cast to
    x's dtype."""
    x32 = x.float()
    dow = _first(dout.float() * w.float(), x.dtype, round_first)
    proj = (dow * x32).sum(dim=-1, keepdim=True)
    r = inv[:, None]
    return (r * dow - x32 * r ** 3 * (proj / x.shape[-1])).to(x.dtype)


def rms_norm_dw(x, inv, dout, dtype, round_first: bool = False):
    """dW = sum over rows of dO * x * inv in f32 (``round_first``: ``x *
    inv`` rounded to x's dtype), cast to ``dtype`` (plain on every device,
    as the reference leaves it to its compiler)."""
    return (dout.float() * _first(x.float() * inv[:, None], x.dtype, round_first)
            ).sum(dim=0).to(dtype)


def _fn(name, argtypes, lib="rms_norm"):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, w, *others):
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x [N, H] and w [H], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    for t in (w, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {t.device} and {x.device}")
    for t in (x, w, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w is {w.dtype}, x is {x.dtype}")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: at most 2^31 - 1 rows")


def rms_norm_fwd(x, w, eps: float, round_first: bool = False):
    """``(out, inv)`` of RMSNorm over the rows of x [N, H], in the fused
    mode or (``round_first``) the composed form's."""
    if x.device.type == "cpu":
        return rms_norm_fwd_ref(x, w, eps, round_first)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    _check("rms_norm_fwd", x, w)
    n, h = x.shape
    out = torch.empty_like(x)
    inv = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, inv
    fn = _fn("rms_norm_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), inv.data_ptr(), n, h,
            float(eps), DTYPES[x.dtype], int(round_first), _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"rms_norm_fwd kernel launch failed: CUDA error {rc}")
    rms_norm_fwd.launches += 1
    rms_norm_fwd.by_mode[MODES[round_first]] += 1
    rms_norm_fwd.by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return out, inv


def rms_norm_bwd_dx(x, w, inv, dout, round_first: bool = False):
    """dx of RMSNorm from the forward's ``inv``, in the forward's mode."""
    if x.device.type == "cpu":
        return rms_norm_bwd_dx_ref(x, w, inv, dout, round_first)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    _check("rms_norm_bwd_dx", x, w, inv, dout)
    if dout.shape != x.shape or dout.dtype != x.dtype:
        raise ValueError("rms_norm_bwd_dx: dout must match x")
    if inv.dtype != torch.float32 or inv.shape != (x.shape[0],):
        raise ValueError("rms_norm_bwd_dx: inv must be float32 [N]")
    n, h = x.shape
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    fn = _fn("rms_norm_bwd_dx", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), inv.data_ptr(), dout.data_ptr(), dx.data_ptr(),
            n, h, DTYPES[x.dtype], int(round_first), _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd_dx kernel launch failed: CUDA error {rc}")
    rms_norm_bwd_dx.launches += 1
    rms_norm_bwd_dx.by_mode[MODES[round_first]] += 1
    rms_norm_bwd_dx.by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return dx


#: kernel launches since the last reset (the CPU path never counts), in
#: all, by mode and by dtype
rms_norm_fwd.launches = 0
rms_norm_bwd_dx.launches = 0
rms_norm_fwd.by_mode = dict.fromkeys(MODES.values(), 0)
rms_norm_bwd_dx.by_mode = dict.fromkeys(MODES.values(), 0)
rms_norm_fwd.by_dtype = dict.fromkeys((str(d).removeprefix("torch.") for d in DTYPES), 0)
rms_norm_bwd_dx.by_dtype = dict.fromkeys((str(d).removeprefix("torch.") for d in DTYPES), 0)


class _RMSNorm2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, round_first):
        out, inv = rms_norm_fwd(x, w, eps, round_first)
        ctx.save_for_backward(x, w, inv)
        ctx.round_first = round_first
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, inv = ctx.saved_tensors
        rf = ctx.round_first
        dout = dout.contiguous()
        dx = rms_norm_bwd_dx(x, w, inv, dout, rf) if ctx.needs_input_grad[0] else None
        dw = rms_norm_dw(x, inv, dout, w.dtype, rf) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def rms_norm_2d(x, w, eps: float, round_first: bool = False):
    """Differentiable RMSNorm through the kernels: x [N, H], w [H] ->
    [N, H], in the fused mode or (``round_first``) the composed form's."""
    return _RMSNorm2D.apply(x, w, float(eps), bool(round_first))


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------


def swiglu_fwd_ref(a, b):
    """Plain forward: ``silu(a) * b`` in f32, cast to a's dtype."""
    a32 = a.float()
    return (a32 * torch.sigmoid(a32) * b.float()).to(a.dtype)


def swiglu_bwd_ref(a, b, dout):
    """Plain backward in f32: ``da = dO * b * (sig + silu (1 - sig))``,
    ``db = dO * silu``, each cast to the inputs' dtype."""
    a32, b32, d32 = a.float(), b.float(), dout.float()
    sig = torch.sigmoid(a32)
    silu = a32 * sig
    return ((d32 * b32 * (sig + silu * (1.0 - sig))).to(a.dtype),
            (d32 * silu).to(b.dtype))


def _check_swiglu(name, *ts):
    a = ts[0]
    if a.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got {a.dtype}")
    for t in ts:
        if t.dtype != a.dtype or t.shape != a.shape or t.device != a.device:
            raise ValueError(f"{name}: inputs differ in dtype, shape or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def swiglu_fwd(a, b):
    """``silu(a) * b`` over same-shaped a and b."""
    if a.device.type == "cpu":
        return swiglu_fwd_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"swiglu runs on cuda or cpu, not {a.device}")
    _check_swiglu("swiglu_fwd", a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _fn("swiglu_fwd", [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                     ctypes.c_void_p], lib="swiglu")
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), DTYPES[a.dtype],
            _build.launch_stream(a.device))
    if rc != 0:
        raise RuntimeError(f"swiglu_fwd kernel launch failed: CUDA error {rc}")
    swiglu_fwd.launches += 1
    return out


def swiglu_bwd(a, b, dout):
    """``(da, db)`` of ``silu(a) * b``."""
    if a.device.type == "cpu":
        return swiglu_bwd_ref(a, b, dout)
    if a.device.type != "cuda":
        raise ValueError(f"swiglu runs on cuda or cpu, not {a.device}")
    _check_swiglu("swiglu_bwd", a, b, dout)
    da, db = torch.empty_like(a), torch.empty_like(b)
    if a.numel() == 0:
        return da, db
    fn = _fn("swiglu_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                                     ctypes.c_void_p], lib="swiglu")
    rc = fn(a.data_ptr(), b.data_ptr(), dout.data_ptr(), da.data_ptr(), db.data_ptr(),
            a.numel(), DTYPES[a.dtype], _build.launch_stream(a.device))
    if rc != 0:
        raise RuntimeError(f"swiglu_bwd kernel launch failed: CUDA error {rc}")
    swiglu_bwd.launches += 1
    return da, db


#: kernel launches since the last reset (the CPU path never counts)
swiglu_fwd.launches = 0
swiglu_bwd.launches = 0


class _SwiGLU2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return swiglu_fwd(a, b)

    @staticmethod
    def backward(ctx, dout):
        a, b = ctx.saved_tensors
        return swiglu_bwd(a, b, dout.contiguous())


def swiglu_2d(a, b):
    """Differentiable fused ``silu(a) * b``; a, b [N, H] of one dtype."""
    return _SwiGLU2D.apply(a, b)
