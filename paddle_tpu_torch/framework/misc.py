"""The top level's utilities (counterpart of
``paddle_tpu/framework/misc.py``): ``finfo`` / ``iinfo``, the places,
``create_parameter``, ``tolist``, ``batch`` and the small rest."""

from __future__ import annotations

import torch

from .. import dtype as _dt

__all__ = ["finfo", "iinfo", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "LazyGuard", "batch",
           "tolist", "set_printoptions", "check_shape", "disable_signal_handler",
           "create_parameter"]


class _DTypeInfo:
    """The reference's record: ``bits``, ``min``, ``max``, ``dtype`` (a
    name), and for a float ``eps``, ``tiny``, ``smallest_normal`` and
    ``resolution``."""

    def __init__(self, info, name: str, dtype=None):
        self.bits = info.bits
        floating = isinstance(info, torch.finfo)
        self.min = float(info.min) if floating else int(info.min)
        self.max = float(info.max) if floating else int(info.max)
        if floating:
            self.eps = float(info.eps)
            self.tiny = float(info.tiny)
            self.smallest_normal = float(info.tiny)
            # numpy's resolution is the decimal step rounded to the dtype
            self.resolution = torch.tensor(info.resolution, dtype=dtype).item()
        self.dtype = name

    def __repr__(self):
        return f"paddle.{self.dtype} info(min={self.min}, max={self.max})"


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        dtype = dtype.removeprefix("paddle.")
    return _dt._lookup(dtype)


def iinfo(dtype):
    d = _torch_dtype(dtype)
    return _DTypeInfo(torch.iinfo(d), _dt.dtype_name(d))


def finfo(dtype):
    d = _torch_dtype(dtype)
    return _DTypeInfo(torch.finfo(d), _dt.dtype_name(d), d)


class CPUPlace:
    """The host, as a ``place``."""

    _kind = "cpu"

    def __repr__(self):
        return "Place(cpu)"

    def __eq__(self, o):
        return isinstance(o, CPUPlace)

    def __hash__(self):
        return hash("cpu")


class CUDAPlace:
    """Card ``device_id``, as a ``place``."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)
        self._kind = f"gpu:{self.device_id}"

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"

    def __eq__(self, o):
        return isinstance(o, CUDAPlace) and o.device_id == self.device_id

    def __hash__(self):
        return hash(("gpu", self.device_id))


class CUDAPinnedPlace:
    """Page-locked host memory, as a ``place``: tensors made there are CPU
    tensors."""

    _kind = "cpu"

    def __repr__(self):
        return "Place(gpu_pinned)"

    def __eq__(self, o):
        return isinstance(o, CUDAPinnedPlace)

    def __hash__(self):
        return hash("pinned")


class LazyGuard:
    """Paddle's lazy initialisation guard: parameters here are made at
    once, so inside it construction is as outside."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """A reader of lists of ``batch_size`` samples from a reader of samples
    (the last, shorter list kept unless ``drop_last``)."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def tolist(x):
    return x.tolist() if isinstance(x, torch.Tensor) else list(x)


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None,
                     linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold, edgeitems=edgeitems,
                           sci_mode=sci_mode, linewidth=linewidth)


def check_shape(shape):
    """Every entry an int (or None / -1 for a dynamic dimension)."""
    for s in shape or []:
        if s is not None and not isinstance(s, int):
            raise TypeError(f"shape entries must be int/None, got {type(s)}")
        if s is not None and s < -1:
            raise ValueError(f"invalid dim {s}")


def disable_signal_handler():
    """Paddle removes its fault handlers; the port installs none."""


def create_parameter(shape, dtype="float32", name=None, attr=None, is_bias=False,
                     default_initializer=None, *, device=None, generator=None):
    """A free-standing trainable ``Parameter`` (``Layer.create_parameter``'s
    rules; ``name`` when ``attr`` gives none)."""
    from ..nn.layer.layers import Layer
    from ..nn.param_attr import ParamAttr

    if attr is None and name is not None:
        attr = ParamAttr(name=name)
    return Layer(dtype=dtype).create_parameter(
        list(shape), attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer, device=device, generator=generator)
