"""Int8 weight-only matmul: the Hopper kernels' wrappers, their plain
versions and the autograd ops.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py:116-201``:

- ``int8_matmul`` (:117, reached through ``matmul_gate``, :255) with
  ``int8_matmul_ref`` standing for the composed ``int8_matmul_xla``
  (:234). M <= 64 runs the weight stream of ``csrc/quant_matmul.cu``; a
  larger M goes to :func:`int8_matmul_large_m`, the tensor-core kernel, as
  the reference's ``_fwd_blocks`` (:98-113) switches to compute-shaped
  blocks past M = 64;
- ``int8_matmul_dx`` (``_dx_pallas``, :143) with ``int8_matmul_dx_ref``;
- the differentiable ops: :func:`int8_matmul_frozen` (``_fwd_vjp`` /
  ``_bwd_vjp``, :139-176: dx only, the weights and scales are frozen) and
  :func:`int8_matmul_train_scales` (:179-201: dx and the scales'
  gradient).

On a CUDA tensor each wrapper launches its kernel or raises: it takes bf16
activations of any M, with K and N multiples of 16, and never declines to
a composed path. On a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_ref", "int8_matmul_large_m", "int8_matmul_dx",
           "int8_matmul_dx_ref", "int8_matmul_frozen", "int8_matmul_train_scales",
           "split_plan", "LARGE_M"]

_COLS = 128          # output columns per block (csrc/quant_matmul.cu kCols)
_X_TILE = 32 * 1024  # bytes of the f32 x tile a block keeps in shared memory
_MIN_KC = 256
LARGE_M = 64         # M above this runs the tensor-core forward


def int8_matmul_ref(x, w_int8, scales):
    """Plain version: ``x [M, K] @ w_int8 [K, N]`` with f32 accumulation,
    times the per-output-channel ``scales [N]`` in f32, cast to x's
    dtype."""
    out = torch.matmul(x.float(), w_int8.float())
    return (out * scales.float()[None, :]).to(x.dtype)


def int8_matmul_dx_ref(dout, w_int8, scales):
    """Plain dX: ``bf16(dout * bf16(scales)) @ w_int8.T`` summed in f32 and
    cast to dout's dtype. The scale is cast to dout's dtype and the product
    rounds there before the sum, as ``_bwd_dx_kernel`` does."""
    scaled = (dout * scales.to(dout.dtype)).float()
    return torch.matmul(scaled, w_int8.float().T).to(dout.dtype)


def split_plan(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """``(mt, kc, ksplit)``: rows of x per block, K rows per block, and the
    number of K slices, chosen so that about two blocks per SM are in
    flight."""
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    blocks = -(-N // _COLS) * -(-M // mt)
    want = max(1, -(-2 * sms // blocks))
    kc = max(_MIN_KC, -(-K // want))
    kc = min(_X_TILE // (4 * mt), -(-kc // 16) * 16)
    return mt, kc, -(-K // kc)


_sms: dict = {}


def _fn(name, argtypes):
    fn = getattr(_build.load("quant_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_int8, scales, name="int8_matmul", along=0):
    """Refuse what the kernels do not take. ``x``'s columns run along
    ``w_int8``'s dimension ``along``: 0 (K) for the forward, 1 (N) for dX."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} on the card takes bf16 activations, got {x.dtype}")
    if w_int8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: weights must be int8 and scales float32")
    if x.dim() != 2 or w_int8.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"{name}: x [M, K or N], w [K, N], scales [N]")
    K, N = w_int8.shape
    if x.shape[1] != w_int8.shape[along] or scales.shape[0] != N:
        raise ValueError(f"{name}: x {tuple(x.shape)} with w {tuple(w_int8.shape)} "
                         f"and scales {tuple(scales.shape)}")
    if K % 16 or N % 16:
        raise ValueError(f"{name}: K={K} and N={N} must be multiples of 16")
    for arg, t in (("x", x), ("w_int8", w_int8), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _device_check(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def int8_matmul(x, w_int8, scales):
    """``x [M, K] @ dequant(w_int8 [K, N], scales [N]) -> [M, N]`` in x's
    dtype. Counts launches of the weight stream (M <= 64) in
    ``int8_matmul.launches``; a larger M is launched, and counted, by
    :func:`int8_matmul_large_m`."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_int8, scales)
    _device_check(x, "int8_matmul")
    _check(x, w_int8, scales)
    M, K = x.shape
    if M > LARGE_M:
        return int8_matmul_large_m(x, w_int8, scales)
    N = w_int8.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    mt, kc, ksplit = split_plan(M, K, N, _sms[dev])
    partial = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
               if ksplit > 1 else None)
    fn = _fn("int8_matmul", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w_int8.data_ptr(), scales.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            out.data_ptr(), M, K, N, mt, kc, ksplit, _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


def int8_matmul_large_m(x, w_int8, scales):
    """The tensor-core forward of :func:`int8_matmul` at any M
    (:func:`int8_matmul` sends it M > 64)."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_int8, scales)
    _device_check(x, "int8_matmul_large_m")
    _check(x, w_int8, scales, "int8_matmul_large_m")
    M, K = x.shape
    N = w_int8.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    fn = _fn("int8_matmul_mma", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), w_int8.data_ptr(), scales.data_ptr(), out.data_ptr(), M, K, N,
            _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_matmul_large_m kernel launch failed: CUDA error {rc}")
    int8_matmul_large_m.launches += 1
    return out


def int8_matmul_dx(dout, w_int8, scales):
    """dX of ``x @ dequant(w_int8, scales)``: ``dout [M, N]`` against
    ``w_int8 [K, N]`` and ``scales [N]`` -> ``[M, K]`` in dout's dtype."""
    if dout.device.type == "cpu":
        return int8_matmul_dx_ref(dout, w_int8, scales)
    _device_check(dout, "int8_matmul_dx")
    _check(dout, w_int8, scales, "int8_matmul_dx", along=1)
    M = dout.shape[0]
    K, N = w_int8.shape
    dx = torch.empty((M, K), dtype=dout.dtype, device=dout.device)
    if M == 0:
        return dx
    fn = _fn("int8_matmul_dx", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(dout.data_ptr(), w_int8.data_ptr(), scales.data_ptr(), dx.data_ptr(), M, K, N,
            _build.launch_stream(dout.device))
    if rc != 0:
        raise RuntimeError(f"int8_matmul_dx kernel launch failed: CUDA error {rc}")
    int8_matmul_dx.launches += 1
    return dx


#: kernel launches since the last reset (the CPU path never counts)
int8_matmul.launches = 0
int8_matmul_large_m.launches = 0
int8_matmul_dx.launches = 0


# The ops call the wrappers through this module's globals, so that a test
# harness can route them to the plain versions by replacing the names.

class _Int8MatmulFrozen(torch.autograd.Function):
    """Frozen weights and scales: the backward is dx alone. Only the int8
    weights and the scales are saved (x's dtype and shape are dout's)."""

    @staticmethod
    def forward(ctx, x, w_int8, scales):
        ctx.save_for_backward(w_int8, scales)
        return int8_matmul(x, w_int8, scales)

    @staticmethod
    def backward(ctx, dout):
        w_int8, scales = ctx.saved_tensors
        dx = int8_matmul_dx(dout.contiguous(), w_int8, scales) if ctx.needs_input_grad[0] else None
        return dx, None, None


class _Int8MatmulTrainScales(torch.autograd.Function):
    """dx through the kernel and the scales' gradient
    ``sum_m dout * (x @ w_int8)`` in f32, composed as in the reference."""

    @staticmethod
    def forward(ctx, x, w_int8, scales):
        ctx.save_for_backward(x, w_int8, scales)
        return int8_matmul(x, w_int8, scales)

    @staticmethod
    def backward(ctx, dout):
        x, w_int8, scales = ctx.saved_tensors
        dout = dout.contiguous()
        dx = int8_matmul_dx(dout, w_int8, scales) if ctx.needs_input_grad[0] else None
        d_scales = None
        if ctx.needs_input_grad[2]:
            raw = torch.matmul(x.float(), w_int8.float())
            d_scales = (dout.float() * raw).sum(dim=0).to(scales.dtype)
        return dx, None, d_scales


def int8_matmul_frozen(x, w_int8, scales):
    """Differentiable ``x @ dequant(w_int8, scales)`` with frozen weights and
    scales: gradients reach x only."""
    return _Int8MatmulFrozen.apply(x, w_int8, scales)


def int8_matmul_train_scales(x, w_int8, scales):
    """Differentiable ``x @ dequant(w_int8, scales)`` whose backward also
    gives the per-channel scales' gradient (learned-scale training)."""
    return _Int8MatmulTrainScales.apply(x, w_int8, scales)
