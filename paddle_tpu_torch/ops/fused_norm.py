"""Fused RMSNorm: the Hopper kernels' wrappers, their plain versions and
the autograd op.

Counterpart of ``paddle_tpu/ops/pallas/fused_norm.py:79`` ``rms_norm_2d``
(forward ``_rms_fwd_kernel`` :45, backward dx ``_rms_bwd_dx_kernel`` :55;
dW is a plain row sum there and here). On a CUDA tensor each wrapper
launches its kernel of ``csrc/rms_norm.cu`` or raises; on a CPU tensor it
runs the plain version, which repeats the kernel's arithmetic: statistics
and the product with the weight in f32, one rounding to the storage type.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm_2d", "rms_norm_fwd", "rms_norm_fwd_ref", "rms_norm_bwd_dx",
           "rms_norm_bwd_dx_ref", "rms_norm_dw", "DTYPES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_fwd_ref(x, w, eps: float):
    """Plain forward: x [N, H], w [H] -> (out [N, H] in x's dtype, inv f32
    [N]) with ``inv = rsqrt(mean(x^2) + eps)`` and ``out = x * inv * w``
    in f32."""
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1) + eps)
    return (x32 * inv[:, None] * w.float()).to(x.dtype), inv


def rms_norm_bwd_dx_ref(x, w, inv, dout):
    """Plain backward dx: ``inv * dO * w - x * inv^3 * sum(dO * w * x) / H``
    in f32, cast to x's dtype."""
    x32 = x.float()
    dow = dout.float() * w.float()
    proj = (dow * x32).sum(dim=-1, keepdim=True)
    r = inv[:, None]
    return (r * dow - x32 * r ** 3 * (proj / x.shape[-1])).to(x.dtype)


def rms_norm_dw(x, inv, dout, dtype):
    """dW = sum over rows of dO * x * inv in f32, cast to ``dtype`` (plain
    on every device, as the reference leaves it to its compiler)."""
    return (dout.float() * (x.float() * inv[:, None])).sum(dim=0).to(dtype)


def _fn(name, argtypes):
    fn = getattr(_build.load("rms_norm"), name)
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


def rms_norm_fwd(x, w, eps: float):
    """``(out, inv)`` of RMSNorm over the rows of x [N, H]."""
    if x.device.type == "cpu":
        return rms_norm_fwd_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    _check("rms_norm_fwd", x, w)
    n, h = x.shape
    out = torch.empty_like(x)
    inv = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out, inv
    fn = _fn("rms_norm_fwd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), inv.data_ptr(), n, h,
            float(eps), DTYPES[x.dtype], _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"rms_norm_fwd kernel launch failed: CUDA error {rc}")
    rms_norm_fwd.launches += 1
    return out, inv


def rms_norm_bwd_dx(x, w, inv, dout):
    """dx of RMSNorm from the forward's ``inv``."""
    if x.device.type == "cpu":
        return rms_norm_bwd_dx_ref(x, w, inv, dout)
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
    fn = _fn("rms_norm_bwd_dx", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), inv.data_ptr(), dout.data_ptr(), dx.data_ptr(),
            n, h, DTYPES[x.dtype], _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd_dx kernel launch failed: CUDA error {rc}")
    rms_norm_bwd_dx.launches += 1
    return dx


#: kernel launches since the last reset (the CPU path never counts)
rms_norm_fwd.launches = 0
rms_norm_bwd_dx.launches = 0


class _RMSNorm2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        out, inv = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, inv)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, inv = ctx.saved_tensors
        dout = dout.contiguous()
        dx = rms_norm_bwd_dx(x, w, inv, dout) if ctx.needs_input_grad[0] else None
        dw = rms_norm_dw(x, inv, dout, w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def rms_norm_2d(x, w, eps: float):
    """Differentiable fused RMSNorm: x [N, H], w [H] -> [N, H]."""
    return _RMSNorm2D.apply(x, w, float(eps))
