"""Int8 weight-only matmul: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py:116`` ``int8_matmul``
(reached through ``matmul_gate``, :255) with ``int8_matmul_ref`` standing
for the composed ``int8_matmul_xla`` (:234). On a CUDA tensor the wrapper
launches the kernel of ``csrc/quant_matmul.cu`` or raises: it takes bf16
activations of any M, with K and N multiples of 16, and never declines to
a composed path. On a CPU tensor it runs :func:`int8_matmul_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_ref", "split_plan"]

_COLS = 128          # output columns per block (csrc/quant_matmul.cu kCols)
_X_TILE = 32 * 1024  # bytes of the f32 x tile a block keeps in shared memory
_MIN_KC = 256


def int8_matmul_ref(x, w_int8, scales):
    """Plain version: ``x [M, K] @ w_int8 [K, N]`` with f32 accumulation,
    times the per-output-channel ``scales [N]`` in f32, cast to x's
    dtype."""
    out = torch.matmul(x.float(), w_int8.float())
    return (out * scales.float()[None, :]).to(x.dtype)


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


def _lib():
    fn = _build.load("quant_matmul").int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_int8, scales):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul on the card takes bf16 activations, got {x.dtype}")
    if w_int8.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("int8_matmul: weights must be int8 and scales float32")
    if x.dim() != 2 or w_int8.dim() != 2 or scales.dim() != 1:
        raise ValueError("int8_matmul: x [M, K], w [K, N], scales [N]")
    K, N = w_int8.shape
    if x.shape[1] != K or scales.shape[0] != N:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} @ w {tuple(w_int8.shape)} "
                         f"with scales {tuple(scales.shape)}")
    if K % 16 or N % 16:
        raise ValueError(f"int8_matmul: K={K} and N={N} must be multiples of 16")
    for name, t in (("x", x), ("w_int8", w_int8), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} must be 16-byte aligned")


def int8_matmul(x, w_int8, scales):
    """``x [M, K] @ dequant(w_int8 [K, N], scales [N]) -> [M, N]`` in x's
    dtype."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_int8, scales)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    _check(x, w_int8, scales)
    M, K = x.shape
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
    rc = _lib()(x.data_ptr(), w_int8.data_ptr(), scales.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                out.data_ptr(), M, K, N, mt, kc, ksplit, _build.launch_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


#: kernel launches since the last reset (the CPU path never counts)
int8_matmul.launches = 0
