"""``nn.Layer`` and the containers (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's methods on top:
``create_parameter``, ``add_parameter``, ``add_sublayer``,
``register_buffer(persistable=)``, ``sublayers``, ``named_sublayers``,
``set_state_dict`` / ``load_dict``, ``astype``, ``full_name``,
``clear_gradients`` and ``register_forward_post_hook``. Where Paddle and
torch share a name, the method takes both signatures, since torch's own
machinery calls it too:

- ``parameters(include_sublayers=True)`` (or ``recurse=``) returns a list;
  ``named_parameters(prefix, include_sublayers)`` also takes ``recurse=``
  and ``remove_duplicate=``; ``buffers`` / ``named_buffers`` alike;
- ``state_dict()`` gives the reference's order (every parameter, then every
  persistable buffer, each once, in the order of the layer tree) of
  detached tensors (``keep_vars=True``: the tensors themselves); called with
  torch's ``prefix=`` (as torch's recursion does) it is torch's;
- ``train(mode=True)`` and ``eval()`` are torch's: each returns the layer;
- ``to(device=None, dtype=None, blocking=None)`` takes Paddle's device
  names (``"gpu:0"``, ``CUDAPlace``) and dtype names beside torch's
  arguments.

Attribute assignment is torch's: a ``Parameter`` goes to the parameters, a
layer to the sublayers, a tensor assigned to a buffer's name stays a
buffer. The state-dict keys of the containers (``layers.0.weight``) are
the reference's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ... import dtype as _dt
from ...tensor import Parameter, from_numpy, mark_parameter

__all__ = ["Layer", "LayerList", "LayerDict", "ParameterList", "Sequential", "Identity",
           "reference_state_dict", "set_state_dict"]


def _device_arg(a):
    """torch's reading of a device given as Paddle names it."""
    from ...device import place_device

    if isinstance(a, str) and (a.startswith("gpu") or a == "cpu"):
        return place_device(a)
    if hasattr(a, "_kind"):
        return place_device(a)
    return a


def _dtype_arg(a):
    return _dt.convert_dtype(a) if isinstance(a, str) and a in _dt._STR_ALIASES else a


def _detached(p):
    """``p.detach()``, carrying the shard layout of a parameter that the
    distributed tier keeps as a slice (``dist_shard``)."""
    d = p.detach()
    info = getattr(p, "dist_shard", None)
    if info is not None:
        d.dist_shard = info
    return d


def reference_state_dict(model) -> dict:
    """``model``'s state by the reference's names, the tensors themselves:
    a ``Layer``'s ``state_dict(keep_vars=True)``; for another
    ``torch.nn.Module`` (``hapi.Model`` takes one), torch's with a tensor
    listed once more under another name (a tied weight) left out after its
    first."""
    if isinstance(model, Layer):
        return model.state_dict(keep_vars=True)
    out, seen = {}, set()
    for key, t in model.state_dict(keep_vars=True).items():
        if id(t) not in seen:
            seen.add(id(t))
            out[key] = t
    return out


@torch.no_grad()
def set_state_dict(model, state: dict) -> tuple[list, list]:
    """``Layer.set_state_dict`` for any ``torch.nn.Module``."""
    own = reference_state_dict(model)
    missing = []
    for name, target in own.items():
        if name not in state:
            missing.append(name)
            continue
        value = state[name]
        if not torch.is_tensor(value):
            value = from_numpy(np.asarray(value))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{tuple(value.shape)} vs model {tuple(target.shape)}")
        target.copy_(value.to(device=target.device, dtype=target.dtype))
    return missing, [k for k in state if k not in own]


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = _dt.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None, generator=None):
        """A new ``Parameter`` of ``shape`` on ``device`` (None: the default
        device) in ``dtype`` (None: the layer's, "float32" unless given):
        its initializer is ``attr``'s, else the global one
        (``initializer.set_global_initializer``), else
        ``default_initializer``, else Xavier-uniform (a bias: zeros), drawn
        from ``generator`` (None: the port's generator of the device).
        ``attr=False`` gives None. ``attr`` sets the name (``paddle_name``),
        the learning-rate factor, the regularizer, ``trainable`` and
        ``need_clip``."""
        from .. import initializer as I
        from ..param_attr import ParamAttr

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer or I.global_initializer(is_bias) or default_initializer
                or (I.Constant(0.0) if is_bias else I.XavierUniform()))
        dtype = _dt.convert_dtype(dtype) if dtype is not None else self._dtype
        data = init(list(shape), dtype, device=device, generator=generator)
        return mark_parameter(Parameter(data), name=attr.name,
                              learning_rate=attr.learning_rate, regularizer=attr.regularizer,
                              trainable=attr.trainable, need_clip=attr.need_clip,
                              is_bias=is_bias)

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True, *, persistent=None):
        """A buffer; ``persistable=False`` (torch: ``persistent=False``)
        leaves it out of the state dict."""
        super().register_buffer(name, tensor,
                                persistent=persistable if persistent is None else persistent)
        return tensor

    @property
    def _sub_layers(self):
        return self._modules

    # -- iteration ---------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True, remove_duplicate=True, *,
                         recurse=None):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None) -> list:
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers,
                                                    recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, remove_duplicate=True, *,
                      recurse=None):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None) -> list:
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers,
                                                 recurse=recurse)]

    def sublayers(self, include_self: bool = False) -> list:
        return [m for m in self.modules() if include_self or m is not self]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        for name, m in self.named_modules(memo=layers_set, prefix=prefix):
            if include_self or m is not self:
                yield name, m

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, structured_name_prefix="",
                   use_hook=True, *, prefix=None, keep_vars=False):
        if prefix is not None:      # torch's recursion into a sublayer
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        dest = collections.OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p if keep_vars else _detached(p)
        for name, b in self.named_buffers(include_sublayers=include_sublayers):
            owner, _, short = name.rpartition(".")
            if short in self.get_submodule(owner)._non_persistent_buffers_set:
                continue
            dest[structured_name_prefix + name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``{name: tensor or array}`` into this layer's state by
        structured name, each value cast to its target's dtype and moved to
        its device; a shape that differs raises ``ValueError``. Returns
        ``(missing, unexpected)``: the layer's names absent from
        ``state_dict`` and the names of ``state_dict`` the layer lacks,
        both left alone."""
        return set_state_dict(self, state_dict)

    load_dict = set_state_dict

    # -- dtype and device --------------------------------------------------
    def to(self, *args, blocking=None, **kwargs):
        args = [_dtype_arg(_device_arg(a)) for a in args]
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if "device" in kwargs:
            kwargs["device"] = _device_arg(kwargs["device"])
        if "dtype" in kwargs:
            kwargs["dtype"] = _dt.convert_dtype(kwargs["dtype"])
        if blocking is False:
            kwargs["non_blocking"] = True
        if args or kwargs:
            super().to(*args, **kwargs)
        dtype = kwargs.get("dtype", next((a for a in args if isinstance(a, torch.dtype)), None))
        if dtype is not None and dtype.is_floating_point:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return self

    def astype(self, dtype):
        return self.to(dtype=_dt.convert_dtype(dtype))

    def float(self):
        return self.to(dtype=torch.float32)

    def half(self):
        return self.to(dtype=torch.float16)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    # -- hooks and the rest ------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward (a value it
        returns replaces the output); the handle's ``remove()`` drops it."""
        return self.register_forward_hook(hook)

    def full_name(self) -> str:
        return self._name_scope

    def clear_gradients(self, set_to_zero: bool = False):
        for p in self.parameters():
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


class LayerList(Layer, nn.ModuleList):
    """``paddle.nn.LayerList``: sublayers named ``"0"``, ``"1"``, ... in
    order (``append``, ``insert``, ``extend``, indexing and slicing as
    ``torch.nn.ModuleList``)."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class LayerDict(Layer, nn.ModuleDict):
    """``paddle.nn.LayerDict``: sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.update(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """``paddle.nn.ParameterList``: parameters named ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            self.extend(parameters)


class Sequential(Layer, nn.Sequential):
    """``paddle.nn.Sequential``: sublayers given in order (named ``"0"``,
    ``"1"``, ...), as ``(name, layer)`` pairs, or as one ``OrderedDict``;
    ``forward`` runs them in turn."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            layers = tuple(layers[0].items())
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class Identity(Layer):
    """Returns its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
