"""paddle.nn.quant for the port: weight-only quantized linear (counterpart
of ``paddle_tpu/nn/quant.py``).

- :func:`weight_quantize` gives per-output-channel symmetric scales and
  quantized weights bit-identical to the reference's numpy quantizer:
  int8 ``[K, N]``, int4 packed two nibbles a byte ``[K/2, N]`` (even rows
  in the low nibble), fp8 ``float8_e4m3fn``. Every scale is
  ``max(amax, 1e-8) / qmax``: an all-zero column gets a tiny scale and
  zero weights (the serving quantizer ``quantize_decode_weights`` gives
  such a column the scale 1; the two rules stay apart, as in the
  reference).
- :func:`weight_only_linear` runs int8 through the Hopper kernels of
  ``ops.quant_matmul`` (forward and dX; the weights and, by default, the
  scales are frozen) where the reference's gate sends a call to its
  kernel (f32 or bf16 x, shapes the kernels take:
  ``quant_matmul.kernel_takes``), and every other int8 call composed, as
  the reference's ``_wol_xla``: the weights cast to x's dtype, the matmul
  summed in f32, times the scales in f32, cast once. int4 and fp8 run
  composed, dequantized inside the matmul operand, as the reference's
  ``_wol_xla_generic`` does.
- :class:`QuantizedLinear` swaps a ``Linear``: its quantized weight,
  ``weight_scale`` and bias are buffers, so ``state_dict()`` has the
  reference's keys and an optimizer sees no parameter in it.
"""

from __future__ import annotations

import torch

from ..amp import cast_inputs
from ..ops import quant_matmul as QM
from .layer.layers import Layer

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear", "QuantizedLinear"]

_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
_ALGOS = {"weight_only_int8": "int8", "weight_only_int4": "int4", "weight_only_fp8": "fp8"}


def _as_tensor(t):
    return t if torch.is_tensor(t) else torch.as_tensor(t)


def _scales(w, qmax: float):
    return w.abs().amax(dim=0).clamp_min(1e-8) / qmax


def weight_quantize(weight, algo: str = "weight_only_int8"):
    """``[K, N]`` float weight -> (quantized weight, f32 scales ``[N]``),
    on the weight's device. Algos: ``weight_only_int8`` (int8 ``[K, N]``),
    ``weight_only_int4`` (two nibbles packed a byte, ``[K/2, N]``; K must
    be even), ``weight_only_fp8`` (``float8_e4m3fn`` ``[K, N]``). Rounding
    is half to even, as numpy's."""
    w = _as_tensor(weight).detach().float()
    if algo == "weight_only_int8":
        scales = _scales(w, 127.0)
        q = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
    elif algo == "weight_only_int4":
        if w.shape[0] % 2:
            raise ValueError("weight_only_int4 needs an even K (rows pack in pairs)")
        scales = _scales(w, 7.0)
        q4 = torch.clamp(torch.round(w / scales[None, :]), -7, 7).to(torch.int16)
        packed = (q4[0::2] & 0x0F) | ((q4[1::2] & 0x0F) << 4)   # even rows low
        q = packed.to(torch.uint8).view(torch.int8)
    elif algo == "weight_only_fp8":
        scales = _scales(w, _FP8_MAX)
        q = (w / scales[None, :]).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unsupported quant algo {algo!r}")
    return q.contiguous(), scales.contiguous()


def _unpack_int4(p):
    """Packed int8 ``[K/2, N]`` -> int8 ``[K, N]``, each nibble
    sign-extended."""
    p16 = p.to(torch.int16)
    lo = ((p16 & 0x0F) ^ 0x08) - 0x08
    hi = p16 >> 4
    k2, n = p.shape
    return torch.stack([lo, hi], dim=1).reshape(k2 * 2, n).to(torch.int8)


def weight_dequantize(quant_weight, scales, algo: str = "weight_only_int8"):
    """The f32 weight ``q * scales`` of a :func:`weight_quantize` result."""
    if algo not in _ALGOS:
        raise ValueError(f"unsupported quant algo {algo!r}")
    q, s = cast_inputs("weight_dequantize", _as_tensor(quant_weight), _as_tensor(scales))
    if algo == "weight_only_int4":
        q = _unpack_int4(q)
    return q.to(torch.float32) * s[None, :]


def weight_only_linear(x, weight, bias=None, weight_scale=None, weight_dtype: str = "int8",
                       group_size: int = -1, train_scales: bool = False):
    """``y = x @ dequant(weight, weight_scale) [+ bias]`` over x's last
    axis. ``weight_dtype``: ``"int8"`` (the Hopper kernels on the card),
    ``"int4"`` (packed nibbles) or ``"fp8"``. The scales are frozen unless
    ``train_scales``, which also gives their gradient."""
    if weight_dtype not in ("int8", "int4", "fp8"):
        raise ValueError("weight_dtype must be int8, int4, or fp8")
    if group_size != -1:
        raise ValueError("group-wise scales are not supported; use per-channel (group_size=-1)")
    if weight_scale is None:
        raise ValueError("weight_scale is required (from weight_quantize)")
    x, w, s = cast_inputs("weight_only_linear", _as_tensor(x), _as_tensor(weight),
                          _as_tensor(weight_scale))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if weight_dtype == "int8" and QM.kernel_takes(x2, *w.shape):
        op = QM.int8_matmul_train_scales if train_scales else QM.int8_matmul_frozen
        out = op(x2, w, s.float())   # the kernels take f32 scales (amp's O2 casts them)
    elif weight_dtype == "int8":
        sc = s if train_scales else s.detach()
        out = (x2.float() @ w.float() * sc.float()[None, :]).to(x2.dtype)
    else:
        wq = _unpack_int4(w) if weight_dtype == "int4" else w
        sc = s if train_scales else s.detach()
        out = x2 @ (wq.to(x.dtype) * sc[None, :].to(x.dtype))
    out = out.reshape(*lead, out.shape[-1])
    if bias is not None:
        out = out + _as_tensor(bias)
    return out


class QuantizedLinear(Layer):
    """A frozen quantized linear built from a float ``Linear`` (``weight
    [in, out]``). ``algo``: ``weight_only_int8``, ``weight_only_int4`` or
    ``weight_only_fp8``. The quantized ``weight``, the f32 ``weight_scale``
    and the ``bias`` (None for a bias-free linear) are buffers."""

    def __init__(self, linear, algo: str = "weight_only_int8"):
        super().__init__()
        qw, sc = weight_quantize(linear.weight, algo=algo)
        self._wdtype = _ALGOS[algo]
        self.register_buffer("weight", qw)
        self.register_buffer("weight_scale", sc)
        self.register_buffer("bias", None if linear.bias is None
                             else linear.bias.detach().clone())

    def forward(self, x):
        return weight_only_linear(x, self.weight, self.bias, self.weight_scale,
                                  weight_dtype=self._wdtype)
