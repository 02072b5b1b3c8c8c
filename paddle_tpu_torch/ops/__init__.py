"""Ops of the port.

Two kinds of module live here:

- the hand-written Hopper kernels: each of ``flash_attention``,
  ``fused_norm``, ``fused_optimizer``, ``paged_attention``,
  ``quant_matmul``, ``ring_attention`` and ``ring_flash`` wraps one CUDA
  kernel of ``csrc/`` beside its plain PyTorch version. The wrapper
  launches the kernel for CUDA tensors (or raises) and runs the plain
  version for CPU tensors;
- the Paddle op surface (counterpart of ``paddle_tpu/ops``): the
  table-driven registry (``registry.py`` over ``ops.yaml``) and the
  hand-written ``creation``, ``manipulation``, ``math``, ``logic``,
  ``search``, ``linalg`` and ``einsum_indexing``, functions over
  ``torch.Tensor``. This package exports them, with an ``<op>_`` in-place
  companion for each op the reference gives one.
"""

from . import creation, einsum_indexing, linalg, logic, manipulation, math, search
from .registry import (OP_REGISTRY, attach_module_ops, get_op_info, inplace_op_names,
                       install_ops, make_inplace, method_op_names, register_custom,
                       registered_ops, table_driven_ops)

_MODULES = {"manipulation": manipulation, "linalg": linalg, "creation": creation,
            "search": search, "math": math, "logic": logic}

attach_module_ops(_MODULES)
for _name, _mod in _MODULES.items():
    _table = {}
    install_ops(_table, _name)
    for _op, _fn in _table.items():
        if not hasattr(_mod, _op):
            setattr(_mod, _op, _fn)
            _mod.__all__.append(_op)

from .creation import *  # noqa: E402,F403
from .linalg import *  # noqa: E402,F403
from .logic import *  # noqa: E402,F403
from .manipulation import *  # noqa: E402,F403
from .math import *  # noqa: E402,F403
from .search import *  # noqa: E402,F403

# the reference's in-place companions, each ``<op>`` written back into its
# first argument (hand-written ``*_`` functions win): the table's
# (``inplace: true``, what ``inplace_op_names()`` reports, as the
# reference's does) and the rest of Paddle's top-level ``*_`` names, the
# reference's own list (paddle_tpu/ops/__init__.py ``_INPLACE_EXTRAS``);
# flagging these in ops.yaml would make ``inplace_op_names()`` differ from
# the reference's
_INPLACE_EXTRAS = {
    "clip", "scale", "abs", "lerp", "cos", "tan", "sin", "sinh", "acos", "atan", "tanh", "erf",
    "expm1", "log", "log2", "log10", "sqrt", "square", "neg", "trunc", "frac", "digamma",
    "lgamma", "gammaln", "gammainc", "gammaincc", "multigammaln", "polygamma", "i0", "sinc",
    "nan_to_num", "renorm", "logit", "ldexp", "copysign", "hypot", "cumsum", "cumprod", "tril",
    "triu", "pow", "divide", "multiply", "remainder", "floor_mod", "mod", "floor_divide", "gcd",
    "lcm", "equal", "less_than", "less_equal", "greater_than", "greater_equal", "cast",
    "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift", "flatten", "squeeze",
    "unsqueeze", "transpose", "t", "addmm", "masked_fill", "masked_scatter"}

_INPLACE = []
for _base in sorted(set(inplace_op_names()) | _INPLACE_EXTRAS):
    _fn = OP_REGISTRY[_base].fn if _base in OP_REGISTRY else globals().get(_base)
    if _fn is not None and _base + "_" not in globals():
        globals()[_base + "_"] = make_inplace(_fn, _base + "_")
        _INPLACE.append(_base + "_")

__all__ = sorted({n for m in _MODULES.values() for n in m.__all__} | set(_INPLACE)
                 | {"getitem", "setitem", "OP_REGISTRY", "get_op_info", "registered_ops",
                    "table_driven_ops", "inplace_op_names", "method_op_names",
                    "register_custom"})
getitem, setitem = einsum_indexing.getitem, einsum_indexing.setitem
