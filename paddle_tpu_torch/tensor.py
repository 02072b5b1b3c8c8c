"""``to_tensor``, ``Tensor`` and ``Parameter`` (counterpart of
``paddle_tpu/tensor.py``).

There is no wrapper tensor: ``Tensor`` is ``torch.Tensor``, and the port
patches nothing onto it, since that would change torch for every other
library in the process. Paddle's tensor methods that torch lacks
(``stop_gradient``, ``astype``, ``numpy()`` of a card tensor, ...) are
therefore not on the port's tensors: use ``requires_grad``,
``paddle_tpu_torch.cast(x, dtype)``, ``paddle_tpu_torch.tolist(x)`` and the
top-level functions (``paddle_tpu_torch.reshape(x, ...)`` for
``x.reshape(...)`` with Paddle's conventions).

``Parameter`` is a ``torch.nn.Parameter`` that carries the reference's
attributes: ``trainable`` (``requires_grad``), ``stop_gradient`` (its
negation), ``optimize_attr`` (``{"learning_rate": ...}``, which the
optimizers read), ``regularizer``, ``is_bias``, ``need_clip`` and the
Paddle name as ``paddle_name`` (torch keeps ``Tensor.name``)."""

from __future__ import annotations

import numpy as np
import torch

from . import dtype as _dt
from .device import place_device

__all__ = ["Tensor", "Parameter", "to_tensor", "from_numpy", "mark_parameter"]

Tensor = torch.Tensor


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of numpy array ``a`` (bf16 of ``ml_dtypes`` too), a copy."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _narrowed(arr: np.ndarray) -> np.ndarray:
    """The reference's dtype of host data: float64 to the default dtype,
    other 64-bit types to 32 bits."""
    if arr.dtype == np.float64:
        return arr.astype(_dt.dtype_name(_dt.get_default_dtype()))
    name = arr.dtype.name
    if name in ("int64", "uint64", "complex128"):
        return arr.astype({"int64": np.int32, "uint64": np.uint32,
                           "complex128": np.complex64}[name])
    return arr


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True) -> torch.Tensor:
    """``paddle.to_tensor``: a new tensor on ``place`` (None: the default
    device of :mod:`paddle_tpu_torch.device`, the card unless set) with
    ``requires_grad = not stop_gradient``. Host data follows the
    reference's dtype rule: float64 goes to the default dtype and 64-bit
    integers narrow to 32 bits, unless ``dtype`` is given (which is
    narrowed as :func:`paddle_tpu_torch.dtype.convert_dtype` narrows it). A
    tensor keeps its dtype unless ``dtype`` is given."""
    dev = place_device(place)
    want = _dt.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=want or data.dtype, copy=True)
    else:
        arr = data if isinstance(data, np.ndarray) else np.asarray(data)
        if want is None:
            arr = _narrowed(arr)
        out = from_numpy(arr).to(device=dev, dtype=want)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out


def mark_parameter(p: torch.nn.Parameter, *, name=None, learning_rate=1.0, regularizer=None,
                   trainable=True, need_clip=True, is_bias=False) -> torch.nn.Parameter:
    """Set the reference's attributes on parameter ``p`` (returned)."""
    p.paddle_name = name or ""
    p.optimize_attr = {"learning_rate": learning_rate}
    p.regularizer = regularizer
    p.need_clip = need_clip
    p.is_bias = is_bias
    p.requires_grad_(bool(trainable))
    return p


class Parameter(torch.nn.Parameter):
    """A trainable tensor with the reference's parameter attributes (see the
    module's note); ``copy.deepcopy`` keeps them."""

    def __new__(cls, data=None, requires_grad=True):
        return super().__new__(cls, data, requires_grad)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        out.__dict__.update({k: v for k, v in self.__dict__.items()})
        memo[id(self)] = out
        return out

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(self.detach())
