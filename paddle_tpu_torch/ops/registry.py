"""The table-driven op registry (counterpart of ``paddle_tpu/ops/registry.py``).

``ops.yaml`` beside this file lists the op surface: for each op its kind,
its torch implementation (a dotted path under ``torch``, or ``expr``: the
source of a lambda over torch), the dtype classes it takes, whether it
has an ``<op>_`` in-place variant, its aliases and, for the structured
kind, its attributes. At import the registry builds each op's callable,
which converts Python and numpy operands (:func:`._helpers.as_tensor`,
scalars typed as the reference types a weak scalar), checks the dtype
classes, maps Paddle's ``axis`` / ``keepdim`` onto torch's ``dim`` /
``keepdim`` (an int, a list or tuple, negatives, or None for every axis),
calls the implementation and narrows 64-bit integer results to 32 bits,
the reference's index policy. Autograd is torch's.

Rows whose ``impl`` is ``py:<module>.<name>`` are hand-written functions
(``ops/creation.py``, ``manipulation.py``, ``linalg.py``, ``search.py``,
``math.py``) and the port's ``nn.functional``: the table gives their
metadata and the registry binds them when their module is imported
(:func:`attach_module_ops`); ``nn.functional``'s bind late
(``paddle_tpu_torch/_ops_attach.py``). Irregular ops register themselves
with :func:`register_custom`.

The file is read by a small parser of the YAML subset it is written in
(comments, and one flow mapping of scalars and lists a row), since torch's
own dependencies do not include a YAML library.

``method_op_names`` keeps the reference's name, but the port patches no
method onto ``torch.Tensor``: it only lists the ops the reference makes
methods.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ._helpers import Scalar, as_tensor, narrow, scalar_like

__all__ = ["OpInfo", "OP_REGISTRY", "get_op_info", "registered_ops", "table_driven_ops",
           "inplace_op_names", "method_op_names", "register_custom", "attach_module_ops",
           "install_ops", "load_table", "make_inplace"]

_YAML_PATH = os.path.join(os.path.dirname(__file__), "ops.yaml")

_INTEGERS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8, torch.uint16,
             torch.uint32, torch.uint64)

_DTYPE_CLASSES = {
    "floating": lambda dt: dt.is_floating_point,
    "integer": lambda dt: dt in _INTEGERS,
    "bool": lambda dt: dt == torch.bool,
    "complex": lambda dt: dt.is_complex,
    "any": lambda dt: True,
}


# -- the table's YAML subset --------------------------------------------------
def _split_top(s: str, sep: str = ",") -> list:
    """Split ``s`` on ``sep`` outside quotes and brackets."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    parts.append(cur)
    return [p.strip() for p in parts if p.strip()]


def _scalar(v: str):
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        return v[1:-1]
    if v.startswith("[") and v.endswith("]"):
        return [_scalar(p) for p in _split_top(v[1:-1])]
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        return v


def load_table(path: str = _YAML_PATH) -> list:
    """The rows of ``ops.yaml``: one ``- {key: value, ...}`` a line, values
    plain or quoted scalars, ``true``/``false``, ints or ``[...]`` lists."""
    rows = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not (line.startswith("- {") and line.endswith("}")):
                raise ValueError(f"{path}:{n}: a row is one '- {{...}}' line")
            row = {}
            for item in _split_top(line[3:-1]):
                key, _, value = item.partition(":")
                row[key.strip()] = _scalar(value.strip())
            rows.append(row)
    return rows


# -- the registry -------------------------------------------------------------
@dataclass
class OpInfo:
    name: str
    kind: str
    impl: str
    dtypes: tuple = ("any",)
    inplace: bool = False
    method: bool = True
    backward: str = "auto"
    aliases: tuple = ()
    module: str = "math"
    sig: str = ""          # attributes after the tensor arguments, "a=1, b=None"
    tensors: int = 1       # leading tensor arguments (structured kind; -1: a sequence)
    fn: object = field(default=None, repr=False)

    @property
    def args(self):
        if self.kind in ("structured", "wrapped", "custom"):
            ts = tuple(f"x{i}" if i else "x" for i in range(self.tensors))
            return ts + tuple(p.split("=")[0].strip() for p in _split_top(self.sig))
        return {"unary": ("x",), "binary": ("x", "y"), "compare": ("x", "y"),
                "reduce": ("x", "axis", "keepdim")}[self.kind]


OP_REGISTRY: dict[str, OpInfo] = {}


def get_op_info(name: str) -> OpInfo:
    return OP_REGISTRY[name]


def registered_ops() -> list:
    return sorted(OP_REGISTRY)


def _resolve_impl(row):
    if "expr" in row:
        return eval(row["expr"], {"torch": torch, "np": np, "math": math})  # noqa: S307 (our own table)
    obj = torch
    for part in row["impl"].split(".")[1:]:
        obj = getattr(obj, part)
    return obj


def _check_dtype(info: OpInfo, t: torch.Tensor):
    if info.dtypes == ("any",):
        return
    if not any(_DTYPE_CLASSES[c](t.dtype) for c in info.dtypes):
        raise TypeError(f"paddle.{info.name} expects dtype in {list(info.dtypes)}, "
                        f"got {str(t.dtype).removeprefix('torch.')}")


def _finish(info: OpInfo, out):
    out = narrow(out)
    if info.backward == "none":
        if isinstance(out, (tuple, list)):
            return type(out)(o.detach() for o in out)
        return out.detach()
    return out


def _build_unary(info, fn):
    def op(x, name=None):
        x = as_tensor(x)
        _check_dtype(info, x)
        return _finish(info, fn(x))
    return op


def _operands(info, x, y):
    """Two tensors from (tensor or scalar, tensor or scalar), a scalar typed
    as the reference types a weak one against the other operand (a boolean
    tensor beside a number takes the number's type)."""
    if isinstance(y, Scalar) and not isinstance(x, Scalar):
        x = as_tensor(x)
        _check_dtype(info, x)
        s = scalar_like(y, x)
        return (x if x.dtype == s.dtype else x.to(s.dtype)), s
    if isinstance(x, Scalar):
        y = as_tensor(y)
        _check_dtype(info, y)
        s = scalar_like(x, y)
        return s, (y if y.dtype == s.dtype else y.to(s.dtype))
    x, y = as_tensor(x), as_tensor(y, like=x if isinstance(x, torch.Tensor) else None)
    _check_dtype(info, x)
    _check_dtype(info, y)
    return x, y


def _build_binary(info, fn):
    def op(x, y, name=None):
        return _finish(info, fn(*_operands(info, x, y)))
    return op


def _build_reduce(info, fn):
    def op(x, axis=None, keepdim=False, name=None):
        x = as_tensor(x)
        _check_dtype(info, x)
        if x.dim() == 0:
            return _finish(info, fn(x.reshape(1), (0,), False))
        if axis is None:
            dims = tuple(range(x.dim()))
        elif isinstance(axis, (list, tuple)):
            dims = tuple(int(a) % x.dim() for a in axis) or tuple(range(x.dim()))
        else:
            dims = (int(axis) % x.dim(),)
        return _finish(info, fn(x, dims, bool(keepdim)))
    return op


def _build_structured(info, fn):
    """``tensors`` leading tensor arguments (a sequence of them for -1),
    then the attributes of ``sig``, by position or by keyword."""
    defaults = eval(f"dict({info.sig})") if info.sig else {}  # noqa: S307 (our own table)
    names = list(defaults)
    nt = info.tensors

    def op(*args, name=None, **kwargs):
        if nt == -1:
            ts = [as_tensor(a) for a in args[0]]
            extra = args[1:]
        else:
            if len(args) < nt:
                raise TypeError(f"paddle.{info.name} expects {nt} tensor argument(s)")
            ts = [as_tensor(a) for a in args[:nt]]
            for t in ts:
                _check_dtype(info, t)
            extra = args[nt:]
        if len(extra) > len(names):
            raise TypeError(f"paddle.{info.name} got too many arguments")
        attrs = dict(defaults)
        attrs.update(zip(names, extra))
        for k, v in kwargs.items():
            if k not in defaults:
                raise TypeError(f"paddle.{info.name} got unexpected keyword {k!r}")
            attrs[k] = v
        return _finish(info, fn(*ts, **attrs))
    return op


_BUILDERS = {"unary": _build_unary, "binary": _build_binary, "compare": _build_binary,
             "reduce": _build_reduce, "structured": _build_structured}

_LOGIC_OPS = {"equal", "not_equal", "greater_than", "greater_equal", "less_than", "less_equal",
              "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
              "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
              "bitwise_right_shift"}

_WRAPPED_ENTRIES: list = []      # (info, module name, attribute), bound later


def _register(info: OpInfo):
    OP_REGISTRY[info.name] = info
    for alias in info.aliases:
        OP_REGISTRY[alias] = info


def _load():
    for row in load_table():
        impl = row.get("impl", row.get("expr", ""))
        info = OpInfo(
            name=row["op"], kind=row["kind"], impl=impl,
            dtypes=tuple(row.get("dtypes", ["any"])),
            inplace=bool(row.get("inplace", False)), method=bool(row.get("method", True)),
            backward=row.get("backward", "auto"), aliases=tuple(row.get("alias", [])),
            module=row.get("module", "logic" if row["op"] in _LOGIC_OPS else "math"),
            sig=row.get("sig", ""), tensors=int(row.get("tensors", 1)))
        if impl.startswith("py:"):
            mod_name, attr = impl[3:].rsplit(".", 1)
            _WRAPPED_ENTRIES.append((info, mod_name, attr))
            continue
        fn = _BUILDERS[info.kind](info, _resolve_impl(row))
        fn.__name__ = fn.__qualname__ = info.name
        fn.__doc__ = (f"paddle.{info.name}: table-driven op (ops.yaml), kind={info.kind}, "
                      f"impl={info.impl}, dtypes={list(info.dtypes)}")
        info.fn = fn
        _register(info)


def attach_module_ops(modules: dict):
    """Bind the table's ``py:`` rows of the given modules (``{name:
    module}``) to their functions, each behind the row's dtype check, and
    put the checked callable back into its module."""
    for info, mod_name, attr in _WRAPPED_ENTRIES:
        mod = modules.get(mod_name)
        if mod is None:
            continue
        raw = getattr(mod, attr, None)
        if raw is None:
            raise AttributeError(f"ops.yaml wraps {mod_name}.{attr} but it does not exist")
        fn = raw
        if info.dtypes != ("any",):
            @functools.wraps(raw)
            def fn(*a, _raw=raw, _info=info, **k):
                if a and isinstance(a[0], torch.Tensor):
                    _check_dtype(_info, a[0])
                return _raw(*a, **k)
            setattr(mod, attr, fn)
        info.fn = fn
        _register(info)


def table_driven_ops() -> list:
    """Ops whose callable the registry builds from the table."""
    wrapped = {i.name for i, _m, _a in _WRAPPED_ENTRIES}
    return sorted(n for n, i in OP_REGISTRY.items() if i.kind != "custom" and n not in wrapped)


def install_ops(namespace: dict, module: str):
    """Put the table's ops of ``module`` into its globals."""
    for name, info in OP_REGISTRY.items():
        if info.module == module and info.fn is not None:
            namespace[name] = info.fn


def register_custom(name: str, *, dtypes=("any",), inplace=False, method=True, backward="auto",
                    module="math"):
    """Register a hand-written op with the registry (its callable is the
    decorated function)."""
    def deco(fn):
        OP_REGISTRY[name] = OpInfo(name=name, kind="custom",
                                   impl=f"python:{fn.__module__}.{fn.__qualname__}",
                                   dtypes=tuple(dtypes), inplace=inplace, method=method,
                                   backward=backward, module=module, fn=fn)
        return fn
    return deco


def inplace_op_names() -> list:
    return [i.name for i in OP_REGISTRY.values() if i.inplace]


def method_op_names() -> list:
    """The ops the reference patches onto its Tensor as methods; the port
    patches none of them (torch's tensor stays torch's)."""
    return [i.name for i in OP_REGISTRY.values() if i.method]


def make_inplace(fn, name: str):
    """``name`` (``<op>_``): ``fn`` applied to its first argument, written
    back into it. A result of the same shape and dtype is copied in
    (``Tensor.copy_``, which autograd records); one that differs replaces
    the tensor's data, which a tensor that requires grad refuses."""
    def inplace(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if out.shape == x.shape and out.dtype == x.dtype:
            x.copy_(out)
        elif x.requires_grad:
            raise RuntimeError(f"{name} changes the shape or dtype of a tensor that requires "
                               f"grad; call {name[:-1]} instead")
        else:
            x.data = out.detach()
        return x

    inplace.__name__ = inplace.__qualname__ = name
    inplace.__doc__ = f"paddle.{name}: ``{name[:-1]}`` written back into its first argument."
    return inplace


_load()
