"""Dtype surface (counterpart of ``paddle_tpu/dtype.py``): Paddle's dtype
names as ``torch.dtype``s, and the string aliases the reference takes.

The reference narrows 64-bit requests to 32 bits (its 64-bit types are off);
``convert_dtype`` does the same here, so a dtype named on both sides is
the same width. ``get_default_dtype``/``set_default_dtype`` keep the
default as a name ("float32" unless set), as the reference's flag does.
"""

from __future__ import annotations

import torch

__all__ = ["bfloat16", "float16", "float32", "float64", "int8", "int16", "int32", "int64",
           "uint8", "uint16", "uint32", "uint64", "bool_", "complex64", "complex128",
           "float8_e4m3fn", "float8_e5m2", "convert_dtype", "dtype_name",
           "is_floating_point_dtype", "is_integer_dtype", "is_inexact_dtype",
           "get_default_dtype", "set_default_dtype"]

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_STR_ALIASES = {
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16, "half": float16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}

# the reference's width policy: 64-bit requests narrow to 32 bits
_X64_NARROW = {int64: int32, uint64: uint32, float64: float32, complex128: complex64}

# numpy's names for the dtypes numpy has, so np.float32 and "float32" agree
_NP_NAMES = {"float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
             "uint16", "uint32", "uint64", "bool", "complex64", "complex128"}

_INTEGERS = (int8, int16, int32, int64, uint8, uint16, uint32, uint64)

_default = "float32"


def _lookup(dtype):
    """A ``torch.dtype`` from a name, a ``torch.dtype`` or a numpy dtype,
    without narrowing."""
    if isinstance(dtype, str):
        if dtype not in _STR_ALIASES:
            raise ValueError(f"unknown dtype {dtype!r}")
        return _STR_ALIASES[dtype]
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    name = np.dtype(dtype).name
    if name not in _NP_NAMES and name not in _STR_ALIASES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _STR_ALIASES.get(name) or getattr(torch, name)


def convert_dtype(dtype):
    """A ``torch.dtype`` from a name (the reference's aliases), a
    ``torch.dtype`` or a numpy dtype, 64-bit requests narrowed to 32 bits;
    None stays None. An unknown name raises ``ValueError``."""
    if dtype is None:
        return None
    d = _lookup(dtype)
    return _X64_NARROW.get(d, d)


def dtype_name(dtype) -> str:
    """The reference's (numpy's) name of a dtype: "float32", "bfloat16",
    "bool", ..."""
    d = _lookup(dtype)
    return "bool" if d == torch.bool else str(d).removeprefix("torch.")


def is_floating_point_dtype(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    return convert_dtype(dtype) in _INTEGERS


def is_inexact_dtype(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def get_default_dtype():
    """The default dtype ("float32" unless :func:`set_default_dtype`)."""
    return convert_dtype(_default)


def set_default_dtype(dtype):
    global _default
    _default = dtype_name(convert_dtype(dtype))
