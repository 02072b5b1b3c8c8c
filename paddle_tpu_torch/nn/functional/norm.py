"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``layer_norm``, ``rms_norm`` and
``batch_norm``."""

from __future__ import annotations

import torch

from ...amp import cast_inputs
from ...ops import fused_norm
from ...optimizer.optimizer import as_dtype
from ...tracing import is_traced

__all__ = ["batch_norm", "layer_norm", "rms_norm", "rms_norm_composed"]


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


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every axis but the channel (axis 1; the last for a
    channel-last ``data_format`` of a 3-D or wider input) with the
    reference's rounding as its compiled steps run it (``norm.py:97-162``):

    - training (unless ``use_global_stats``): the batch mean and
      population variance in f32, ``(x - mean) * rsqrt(var + epsilon)``
      in f32, cast to x's dtype, then ``* weight`` and ``+ bias`` in that
      dtype; the running statistics, updated in place without a gradient,
      become ``momentum * running + (1 - momentum) * batch`` (Paddle's
      convention) with the *biased* batch variance, ``momentum`` rounded
      to the buffer's dtype, the sum in f32 rounded once to the buffer's
      dtype (the compiled program keeps the product in f32);
    - otherwise: ``(x - running_mean) * rsqrt(running_var + epsilon)``
      with f32 x: ``running_var + epsilon`` in the buffers' dtype (bf16
      buffers add ``epsilon`` rounded to bf16), its rsqrt in f32, then
      cast and affine as in training.

    Composed on purpose: ``torch.nn.functional.batch_norm`` applies the
    weight and bias before its one rounding and folds the unbiased
    variance into the running statistic. Under ``amp.auto_cast`` the
    inputs of the normalisation (the buffers too, in eval) are first cast
    as the op ``batch_norm`` (a black-list op: to f32); the running
    statistics keep their dtype."""
    channel_axis = 1 if not data_format.endswith("C") or x.dim() <= 2 else x.dim() - 1
    if data_format in ("NHWC", "NLC", "NDHWC"):
        channel_axis = x.dim() - 1
    dims = tuple(i for i in range(x.dim()) if i != channel_axis)
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    if training and not use_global_stats:
        x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
        x32 = x.float()
        mean = x32.mean(dim=dims)
        centered = x32 - mean.reshape(shape)
        var = centered.square().mean(dim=dims)
        out = (centered * torch.rsqrt(var.reshape(shape) + epsilon)).to(x.dtype)
        with torch.no_grad():
            for buf, batch in ((running_mean, mean), (running_var, var)):
                if buf is not None:
                    buf.copy_(buf.float() * as_dtype(momentum, buf.dtype)
                              + (1 - momentum) * batch)
    else:
        x, running_mean, running_var, weight, bias = cast_inputs(
            "batch_norm", x, running_mean, running_var, weight, bias)
        inv = torch.rsqrt((running_var + as_dtype(epsilon, running_var.dtype)).float())
        out = ((x.float() - running_mean.reshape(shape)) * inv.reshape(shape)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out
