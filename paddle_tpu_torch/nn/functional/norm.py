"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import torch

from ...amp import cast_inputs
from ...ops import fused_norm
from ...tracing import is_traced

__all__ = ["layer_norm", "rms_norm", "rms_norm_composed"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes with the
    reference's rounding (``norm.py:19-47``): mean and population variance
    in f32, ``(x - mean) * rsqrt(var + epsilon)`` in f32, cast to x's
    dtype, then ``* weight`` and ``+ bias`` in that dtype (each absent when
    None). Composed on purpose: ``torch.nn.functional.layer_norm`` applies
    the weight and bias before its one rounding, which in bf16 is another
    result. Under ``amp.auto_cast`` the inputs are first cast as the op
    ``layer_norm`` (a black-list op: to f32)."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    n = 1 if isinstance(normalized_shape, int) else len(tuple(normalized_shape))
    dims = tuple(range(x.dim() - n, x.dim()))
    x32 = x.float()
    centered = x32 - x32.mean(dim=dims, keepdim=True)
    var = centered.square().mean(dim=dims, keepdim=True)
    out = (centered * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


#: what the reference's rule sends to its kernel (``norm.py:67-78``)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis. With a weight of x's dtype and shape
    ``[H]``, and x in f32 or bf16 (the reference's rule), it is the op of
    :mod:`paddle_tpu_torch.ops.fused_norm`: the kernel for CUDA tensors, its
    plain version for CPU tensors. An eager call takes its fused mode (the
    weight applied in f32 before the one rounding), as the reference's
    eager call takes its fused kernel; a traced call (inside
    ``jit.TrainStep`` or ``jit.EvalStep``:
    :func:`paddle_tpu_torch.tracing.is_traced`) takes
    the kernel's ``round_first`` mode, the reference's composed form that
    its traced calls run. Every other call, fp16 included, is the composed
    form (``norm.py:83-94``): normalise in f32, cast, then multiply by the
    weight in x's dtype. Under ``amp.auto_cast`` the inputs are first cast
    as the op ``rms_norm`` (a black-list op: to f32)."""
    x, weight = cast_inputs("rms_norm", x, weight)
    h = x.shape[-1]
    if (weight is not None and weight.dtype == x.dtype and x.dtype in KERNEL_DTYPES
            and tuple(weight.shape) == (h,)):
        out = fused_norm.rms_norm_2d(x.reshape(-1, h).contiguous(), weight.contiguous(),
                                     epsilon, round_first=is_traced())
        return out.reshape(x.shape)
    return rms_norm_composed(x, weight, epsilon)


def rms_norm_composed(x, weight=None, epsilon=1e-6):
    """The reference's composed RMSNorm: normalise in f32, cast to x's
    dtype, then multiply by the weight (if any) in that dtype."""
    x32 = x.float()
    out = (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out
