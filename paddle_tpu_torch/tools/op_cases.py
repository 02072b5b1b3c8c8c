"""Example calls of every op of the registry, at small shapes.

Each ``Case`` names an op, its arguments (arrays described by a spec and
made from a seed with numpy, Python values as they are) and how its
result is held: values within the tolerance of its dtype class
(``TOLERANCE``; integer and boolean results exactly), and for a drawing
op (``draw``) its shape, its dtype and a check of its values. The CPU
tests run each case through the port and the reference on the same
inputs; ``chip_smoke.py`` (phase 23b) runs each through the port on the
card and on the CPU (:func:`run`, :func:`compare`).

Run alone on a card: ``python -m paddle_tpu_torch.tools.op_cases``
(prints each class's worst error and exits non-zero on a failure).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Case", "CASES", "TOLERANCE", "make_inputs", "to_port", "run", "flat_outputs",
           "compare", "dtype_class", "card_vs_cpu"]

#: (rtol, atol) by the dtype class of a result; integer and bool are exact
TOLERANCE = {"float": (1e-4, 1e-5), "complex": (1e-4, 1e-5), "int": (0, 0), "bool": (0, 0)}


# -- argument specs -----------------------------------------------------------
@dataclass
class Spec:
    shape: tuple
    kind: str = "f"             # f float, i int, b bool, c complex, v fixed values
    lo: float | None = None
    hi: float | None = None
    dtype: str = "float32"
    values: object = None

    def make(self, rng: np.random.RandomState) -> np.ndarray:
        if self.kind == "v":
            return np.asarray(self.values, dtype=self.dtype)
        if self.kind == "i":
            return rng.randint(self.lo, self.hi, self.shape).astype(self.dtype)
        if self.kind == "b":
            return rng.rand(*self.shape) > 0.5
        if self.kind == "c":
            return (rng.randn(*self.shape) + 1j * rng.randn(*self.shape)).astype(np.complex64)
        if self.lo is None:
            return rng.randn(*self.shape).astype(self.dtype)
        return rng.uniform(self.lo, self.hi, self.shape).astype(self.dtype)


def f(*shape, lo=None, hi=None):
    return Spec(shape, "f", lo, hi)


def pos(*shape):
    return Spec(shape, "f", 0.5, 2.0)


def unit(*shape):
    return Spec(shape, "f", -0.9, 0.9)


def prob(*shape):
    return Spec(shape, "f", 0.05, 0.95)


def i(*shape, lo=0, hi=10):
    return Spec(shape, "i", lo, hi, "int32")


def b(*shape):
    return Spec(shape, "b", dtype="bool")


def c(*shape):
    return Spec(shape, "c", dtype="complex64")


def v(values, dtype="float32"):
    return Spec(np.shape(values), "v", dtype=dtype, values=values)


class L(list):
    """A list argument of specs (``concat``'s tensors)."""


# -- cases ------------------------------------------------------------------
@dataclass
class Case:
    op: str
    args: tuple
    kw: dict = field(default_factory=dict)
    grad: bool = True           # hold the gradient too where the result is float
    tol: tuple | None = None    # (rtol, atol) in place of TOLERANCE's
    draw: object = None         # a drawing op: a check of its values (np -> bool)
    ref: str | None = None      # the reference's callable where its registry row differs
    first: bool = False         # hold only the first result (a tuple's)


def C(op, *args, **kw):
    opts = {k: kw.pop(k) for k in ("grad", "tol", "draw", "ref", "first") if k in kw}
    return Case(op, args, kw, **opts)


def _normal(a):
    a = np.asarray(a, np.float64)
    return abs(a.mean()) < 0.1 and abs(a.std() - 1) < 0.1


def _within(lo, hi):
    return lambda a: bool(np.all((np.asarray(a) >= lo) & (np.asarray(a) <= hi)))


def _binary(a):
    return bool(np.all((np.asarray(a) == 0) | (np.asarray(a) == 1)))


LOOSE = (1e-3, 1e-4)   # special functions whose card and reference forms differ more
# attention in f32: on the card the flash kernel's f32 route (three bf16
# piece products, f32 sums in another order) against the plain f32 version
ATTN_F32 = (2e-4, 5e-5)

_UNARY_F = ["exp", "expm1", "abs", "neg", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
            "asinh", "ceil", "floor", "round", "trunc", "frac", "reciprocal", "square", "sign",
            "erf", "sigmoid", "deg2rad", "rad2deg", "softplus_raw", "angle", "conj", "real",
            "imag", "i0", "i0e", "i1", "i1e", "signbit", "isnan", "isinf", "isfinite",
            "isneginf", "isposinf", "isreal", "exp2", "sinc", "positive", "negative", "sgn",
            "stanh", "squared_l2_norm", "mean_all", "logical_not"]
_UNARY_POS = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "lgamma", "gammaln", "digamma"]
_BINARY_F = ["add", "subtract", "multiply", "divide", "maximum", "minimum", "fmax", "fmin",
             "atan2", "logaddexp", "hypot", "copysign", "nextafter", "heaviside"]
_BINARY_I = ["add", "subtract", "multiply", "floor_divide", "mod", "remainder", "floor_mod",
             "maximum", "minimum", "gcd", "lcm"]
_COMPARE = ["equal", "not_equal", "greater_than", "greater_equal", "less_than", "less_equal"]
_LOGICAL = ["logical_and", "logical_or", "logical_xor"]
_BITWISE = ["bitwise_and", "bitwise_or", "bitwise_xor"]
_REDUCE = ["sum", "mean", "prod", "amax", "amin", "max", "min", "nansum", "nanmean",
           "logsumexp"]

CASES: list = []
CASES += [C(n, f(3, 4)) for n in _UNARY_F]
CASES += [C(n, pos(3, 4), tol=LOOSE if n in ("lgamma", "gammaln", "digamma") else None)
          for n in _UNARY_POS]
CASES += [C("asin", unit(3, 4)), C("acos", unit(3, 4)), C("atanh", unit(3, 4)),
          C("erfinv", unit(3, 4)), C("logit", prob(3, 4)), C("acosh", f(3, 4, lo=1.1, hi=3.0)),
          C("polygamma", pos(3, 4), n=1, tol=LOOSE), C("multigammaln", f(3, 4, lo=2, hi=4), p=2,
                                                       tol=LOOSE),
          C("exp", i(3, 4)), C("abs", i(3, 4, lo=-5, hi=5)), C("square", i(3, 4)),
          C("sign", i(3, 4, lo=-3, hi=3)), C("abs", c(3, 4)), C("conj", c(3, 4)),
          C("real", c(3, 4)), C("imag", c(3, 4)), C("angle", c(3, 4)),
          C("bitwise_not", i(3, 4, lo=-5, hi=5)), C("bitwise_not", b(3, 4)),
          C("logical_not", b(3, 4))]
# torch has no gradient of nextafter (the reference's is undefined too)
CASES += [C(n, f(3, 4), f(3, 4), grad=n != "nextafter") for n in _BINARY_F]
CASES += [C(n, f(2, 3, 4), f(4)) for n in ("add", "multiply")]
CASES += [C("pow", pos(3, 4), f(3, 4)), C("pow", pos(3, 4), 2.5), C("add", f(3, 4), 2.0),
          C("subtract", 3.0, f(3, 4)), C("divide", f(3, 4), pos(3, 4)), C("add", i(3, 4), 2.5),
          C("multiply", i(3, 4), 3), C("divide", i(3, 4), i(3, 4, lo=1, hi=5)),
          C("floor_divide", f(3, 4), pos(3, 4)), C("mod", f(3, 4), pos(3, 4)),
          C("mod", i(3, 4, lo=-9, hi=9), v([[2, -3, 4, -5]] * 3, "int32")),
          C("floor_divide", i(3, 4, lo=-9, hi=9), v([[2, -3, 4, -5]] * 3, "int32")),
          C("pow", i(3, 4), 2), C("ldexp", f(3, 4), i(3, 4, lo=-3, hi=3)),
          # torch has no gradient of the regularized incomplete gamma in ``x``
          C("gammainc", pos(3, 4), pos(3, 4), tol=LOOSE, grad=False),
          C("gammaincc", pos(3, 4), pos(3, 4), tol=LOOSE, grad=False),
          C("bitwise_left_shift", i(3, 4), i(3, 4, lo=0, hi=4)),
          C("bitwise_right_shift", i(3, 4, lo=-50, hi=50), i(3, 4, lo=0, hi=4))]
CASES += [C(n, i(3, 4, lo=-9, hi=9), i(3, 4, lo=1, hi=9)) for n in _BINARY_I]
CASES += [C(n, f(3, 4), f(3, 4)) for n in _COMPARE]
CASES += [C(n, i(3, 4, hi=3), i(3, 4, hi=3)) for n in _COMPARE]
CASES += [C(n, f(3, 4), 0.0) for n in _COMPARE[:2]]
CASES += [C(n, b(3, 4), b(3, 4)) for n in _LOGICAL + _BITWISE]
CASES += [C(n, i(3, 4, lo=-9, hi=9), i(3, 4, lo=-9, hi=9)) for n in _BITWISE]
CASES += [C(n, f(3, 4, 5), **kw) for n in _REDUCE
          for kw in ({}, {"axis": 1}, {"axis": [0, 2], "keepdim": True}, {"axis": -1})]
CASES += [C("sum", i(3, 4)), C("sum", b(3, 4), axis=0), C("mean", i(3, 4), axis=1),
          C("prod", i(3, 4, lo=1, hi=3)), C("max", i(3, 4), axis=0), C("amin", i(3, 4))]
# the math module's irregular ops
CASES += [
    C("assign", f(3, 4)), C("cast", f(3, 4), "float16"), C("cast", f(3, 4), "int32"),
    C("cast", i(3, 4), "float32"), C("cast", f(3, 4), "int64"), C("cast", f(3, 4), "bool"),
    C("scale", f(3, 4), scale=2.0, bias=1.0), C("scale", f(3, 4), 2.0, 1.0, False),
    C("clip", f(3, 4), -0.5, 0.5), C("clip", f(3, 4), min=0.0),
    C("lerp", f(3, 4), f(3, 4), 0.3), C("lerp", f(3, 4), f(3, 4), f(3, 4)),
    C("multiplex", L([f(3, 4), f(3, 4)]), v([[1], [0], [1]], "int32")),
    C("add_n", L([f(3, 4), f(3, 4), f(3, 4)]), ref="@add_n"), C("stanh", f(3, 4), 0.5, 2.0),
    C("nan_to_num", v([[1.0, np.nan, np.inf, -np.inf]])),
    C("nan_to_num", v([[1.0, np.nan, np.inf, -np.inf]]), 2.0, 9.0, -9.0),
    C("std", f(4, 5)), C("std", f(4, 5), axis=1, unbiased=False, keepdim=True),
    C("var", f(4, 5)), C("var", f(4, 5), axis=[0, 1]),
    C("median", f(4, 5)), C("median", f(4, 6), axis=1), C("median", f(4, 5), axis=0,
                                                          keepdim=True),
    C("quantile", f(4, 5), 0.3), C("quantile", f(4, 5), [0.25, 0.75], axis=1),
    C("cumsum", f(3, 4)), C("cumsum", f(3, 4), axis=1), C("cumsum", i(3, 4), axis=0),
    C("cumprod", f(3, 4), dim=1), C("cummax", f(3, 5), axis=1, first=False),
    C("cummin", f(3, 5), axis=0), C("cummax", v([3, 1, 3, 2, 5, 5, 1]), grad=False),
    C("trace", f(4, 4)), C("trace", f(3, 4, 4), 1, 1, 2), C("diff", f(3, 5)),
    C("diff", f(3, 5), n=2, axis=0), C("diff", f(3, 5), prepend=f(3, 1), append=f(3, 2)),
    C("kron", f(2, 3), f(3, 2)), C("inner", f(3, 4), f(2, 4)), C("outer", f(3), f(4)),
    C("reduce_as", f(2, 3, 4), f(3, 1)), C("logcumsumexp", f(3, 4)),
    C("logcumsumexp", f(3, 4), axis=1), C("nanmedian", v([[1.0, np.nan, 3.0, 2.0]] * 2)),
    C("nanmedian", f(3, 4), axis=1, keepdim=True),
    C("nanquantile", v([[1.0, np.nan, 3.0, 2.0, 7.0]] * 2), q=0.4, axis=1),
    C("renorm", f(3, 4), p=2.0, axis=0, max_norm=1.0), C("increment", f(3, 4), value=2.0),
    C("clip_by_norm", f(3, 4), max_norm=1.0), C("frexp", f(3, 4)),
    C("count_nonzero", i(3, 4, hi=3)), C("count_nonzero", i(3, 4, hi=3), axis=1,
                                         keepdim=True),
    C("combinations", f(4), r=2), C("combinations", f(3), r=2, with_replacement=True),
    C("polar", pos(3), f(3), grad=False), C("numel", f(3, 4)), C("shape", f(3, 4, 2)),
    C("rank", f(3, 4, 2)), C("histogram_bin_edges", f(20), bins=5),
    C("histogram_bin_edges", f(20), bins=4, min=-1, max=1),
    # logic
    C("equal_all", f(3, 4), f(3, 4)), C("equal_all", v([1, 2]), v([1, 2])),
    C("all", b(3, 4)), C("all", b(3, 4), axis=1), C("any", b(3, 4), axis=[0, 1], keepdim=True),
    C("any", b(3, 4)), C("isclose", f(3, 4), f(3, 4)),
    C("isclose", v([1.0, 2.0, np.nan]), v([1.0 + 1e-7, 2.1, np.nan]), equal_nan=True),
    C("allclose", f(3, 4), f(3, 4)), C("allclose", v([1.0, 2.0]), v([1.0, 2.0 + 1e-7])),
    C("isin", i(3, 4), v([1, 3, 5], "int32")), C("is_complex", c(2)),
    C("is_floating_point", f(2)), C("is_integer", i(2)), C("is_integer", f(2)),
]
# manipulation
CASES += [
    C("reshape", f(2, 3, 4), [6, 4]), C("reshape", f(2, 3, 4), [0, -1], ref="@reshape0"),
    C("reshape", f(2, 3, 4), [4, 0, 2], ref="@reshape0"), C("reshape_", f(2, 3, 4), [4, 6], grad=False),
    C("flatten", f(2, 3, 4)), C("flatten", f(2, 3, 4, 5), start_axis=1, stop_axis=2),
    C("squeeze", f(2, 1, 3, 1)), C("squeeze", f(2, 1, 3, 1), axis=1),
    C("squeeze", f(2, 1, 3, 1), axis=[1, 3]), C("squeeze", f(2, 1, 3, 1), axis=0),
    C("unsqueeze", f(2, 3), 0), C("unsqueeze", f(2, 3), [0, 3]), C("unsqueeze", f(2, 3), -1),
    C("transpose", f(2, 3, 4), [2, 0, 1]), C("moveaxis", f(2, 3, 4), 0, 2),
    C("swapaxes", f(2, 3, 4), 0, 2), C("concat", L([f(2, 3), f(4, 3)])),
    C("concat", L([f(2, 3), f(2, 5)]), axis=1), C("concat", L([f(2, 3), f(2, 3)]), axis=-1),
    C("stack", L([f(2, 3), f(2, 3)])), C("stack", L([f(2, 3), f(2, 3)]), axis=2),
    C("split", f(6, 4), 3), C("split", f(6, 4), [2, -1], axis=0),
    C("split", f(6, 4), [1, 3], axis=1), C("split", f(6, 4), 2, axis=-1),
    C("chunk", f(6, 4), 2), C("chunk", f(6, 4), 2, axis=1), C("unbind", f(3, 4)),
    C("unbind", f(3, 4), axis=1), C("tile", f(2, 3), [2, 1]), C("tile", f(2, 3), [2, 1, 2]),
    C("expand", f(1, 3), [4, 3]), C("expand", f(1, 3), [2, -1, 3]),
    C("expand", f(2, 1), [-1, 5]), C("broadcast_to", f(1, 3), [4, 3]),
    C("expand_as", f(1, 3), f(4, 3)), C("broadcast_tensors", L([f(1, 3), f(4, 1)])),
    C("flip", f(3, 4), 0), C("flip", f(3, 4), [0, 1]), C("roll", f(3, 4), 1),
    C("roll", f(3, 4), 1, axis=1), C("roll", f(3, 4), [1, 2], axis=[0, 1]),
    C("rot90", f(3, 4)), C("rot90", f(3, 4), k=2), C("rot90", f(2, 3, 4), k=-1, axes=[1, 2]),
    C("gather", f(5, 3), v([3, 0, 3], "int32")), C("gather", f(5, 3), v([2, 0], "int32"),
                                                     axis=1),
    C("gather", f(5, 3), v(1, "int32")), C("index_select", f(5, 3), v([4, 1], "int32")),
    C("index_select", f(5, 3), v([2, 2], "int32"), axis=1),
    C("gather_nd", f(3, 4, 2), v([[0, 1], [2, 3]], "int32")),
    C("gather_nd", f(3, 4, 2), v([[1], [0]], "int32")),
    C("scatter", f(5, 3), v([1, 3], "int32"), f(2, 3)),
    C("scatter", f(5, 3), v([1, 3, 1], "int32"), f(3, 3), grad=False, ref="@scatter_last"),
    C("scatter", f(5, 3), v([1, 3, 1], "int32"), f(3, 3), overwrite=False,
      ref="@scatter_zeroed"),
    C("scatter_", f(5, 3), v([0, 2], "int32"), f(2, 3), grad=False),
    C("scatter_nd_add", f(4, 3), v([[1], [2], [1]], "int32"), f(3, 3)),
    C("scatter_nd", v([[1], [2], [1]], "int32"), f(3, 3), [4, 3]),
    C("index_sample", f(3, 5), v([[0, 4], [1, 1], [3, 2]], "int32")),
    C("index_add", f(5, 3), v([0, 2, 0], "int32"), 0, f(3, 3)),
    C("index_add", f(3, 5), v([4, 1], "int32"), 1, f(3, 2)),
    C("index_put", f(4, 3), L([v([0, 2], "int32"), v([1, 2], "int32")]), f(2)),
    C("index_put", f(4, 3), L([v([0, 2, 0], "int32")]), f(3, 3), True),
    C("take_along_axis", f(3, 4), v([[0, 3], [1, 1], [2, 0]], "int32"), 1),
    C("take_along_axis", f(3, 4), v([[2, 0, 1, 1]], "int32"), 0),
    C("put_along_axis", f(3, 4), v([[0], [3], [1]], "int32"), f(3, 1), 1),
    C("put_along_axis", f(3, 4), v([[0], [3], [1]], "int32"), 2.0, 1, "add"),
    C("put_along_axis", f(3, 4), v([[0, 1], [3, 2], [1, 0]], "int32"), f(3, 2), 1, "mul",
      grad=False),
    C("put_along_axis", f(3, 4), v([[0], [3], [1]], "int32"), f(3, 1), 1, "amax", grad=False),
    C("repeat_interleave", f(3, 2), 2), C("repeat_interleave", f(3, 2), 2, axis=0),
    C("repeat_interleave", f(3, 2), v([1, 0, 2], "int32"), axis=0),
    C("pad", f(2, 3), [1, 2, 0, 1]), C("pad", f(1, 2, 4, 4), [1, 1, 2, 0]),
    C("pad", f(1, 2, 4, 4), [1, 1, 2, 0], mode="reflect"),
    C("pad", f(1, 2, 4, 4), [1, 1, 2, 0], mode="replicate"),
    C("pad", f(1, 2, 4, 4), [1, 1, 2, 0], mode="circular"),
    C("pad", f(1, 4, 4, 2), [1, 0, 1, 2], value=3.0, data_format="NHWC"),
    C("pad", f(1, 4, 4, 2), [1, 0, 1, 2], mode="reflect", data_format="NHWC"),
    C("masked_select", f(3, 4), b(3, 4)), C("masked_select", f(3, 4), b(4), ref="@masked_broadcast"),
    C("masked_fill", f(3, 4), b(3, 4), 7.0), C("masked_fill", f(3, 4), b(3, 1), -1.0),
    C("where", b(3, 4), f(3, 4), f(3, 4)), C("where", b(3, 4), f(3, 4), 0.0),
    C("where", v([[True, False], [False, True]], "bool")),
    C("nonzero", i(3, 4, hi=2)), C("nonzero", i(3, 4, hi=2), as_tuple=True),
    C("unique", i(12, hi=5)), C("unique", v([[1, 2], [1, 2], [3, 0]], "int32"), axis=0),
    C("unique", i(12, hi=5), return_index=True, return_inverse=True, return_counts=True),
    C("unique", v([[1, 2], [1, 2], [0, 0]], "int32"), return_inverse=True, axis=0),
    C("unique_consecutive", v([1, 1, 2, 2, 3, 1, 1, 2], "int32")),
    C("unique_consecutive", v([1, 1, 2, 2, 3, 1, 1, 2], "int32"), return_inverse=True,
      return_counts=True),
    C("unique_consecutive", v([[1, 1], [1, 1], [2, 0], [1, 1]], "int32"), axis=0),
    C("view", f(2, 3, 4), [6, 4]), C("view", f(2, 3), "float16"),
    C("view_as", f(2, 3, 4), f(4, 6)), C("atleast_1d", 3.0), C("atleast_1d", f(3)),
    C("atleast_2d", f(3)), C("atleast_3d", f(2, 3)), C("atleast_2d", f(3), f(2, 3)),
    C("slice", f(4, 5, 6), [0, 2], [1, 0], [3, 4]),
    C("slice", f(4, 5, 6), [1], [-3], [10]),
    C("strided_slice", f(4, 5, 6), [0, 2], [0, 1], [4, 6], [2, 2]),
    C("strided_slice", f(4, 5, 6), [1], [4], [0], [-2]),
    C("crop", f(4, 5), [2, 3], [1, 1]), C("crop", f(4, 5), [2, -1], [1, 2]),
    C("shard_index", v([[1], [6], [12], [19]], "int32"), 20, 2, 0),
    C("shard_index", v([[1], [6], [12], [19]], "int32"), 20, 2, 1, -2),
    C("slice_scatter", f(4, 6), f(2, 6), axes=[0], starts=[1], ends=[3]),
    C("slice_scatter", f(4, 6), f(4, 2), axes=[1], starts=[0], ends=[6], strides=[3]),
    C("broadcast_shape", [2, 1, 3], [4, 3]),
    C("fill_diagonal_", f(4, 4), 2.0, grad=False), C("fill_diagonal_", f(3, 4), 1.0, 1,
                                                     grad=False),
    C("fill_diagonal_", f(7, 3), 5.0, wrap=True, grad=False),
    C("fill_diagonal_", f(3, 3, 3), -1.0, grad=False),
    C("fill_diagonal_tensor", f(4, 5), f(4)), C("fill_diagonal_tensor", f(2, 4, 4), f(2, 3),
                                                1, 1, 2),
    C("fill_diagonal_tensor_", f(4, 5), f(4), grad=False),
    C("diagonal_scatter", f(4, 4), f(4)), C("diagonal_scatter", f(4, 5), f(4), 1),
    C("unfold", f(3, 8), 1, 3, 2, ref="ops.manipulation.unfold"),
    C("unfold", f(7), 0, 2, 1, ref="ops.manipulation.unfold"),
    C("diagonal", f(3, 4)), C("diagonal", f(2, 3, 4), 1, 1, 2),
    C("unstack", f(3, 4)), C("unstack", f(3, 4), axis=1), C("reverse", f(3, 4), axis=[0]),
    C("reverse", f(3, 4)), C("as_complex", f(3, 2), grad=False), C("as_real", c(3)),
    C("fliplr", f(3, 4)), C("flipud", f(3, 4)), C("select_scatter", f(3, 4), f(4), 0, 1),
    C("select_scatter", f(3, 4), f(3), axis=1, index=2),
    C("masked_scatter", f(3, 4), b(3, 4), f(12)),
    C("tensor_split", f(7, 2), 3), C("tensor_split", f(7, 2), [2, 5]),
    C("tensor_split", f(2, 7), 2, axis=1), C("hsplit", f(2, 6), 3), C("vsplit", f(6, 2), 2),
    C("dsplit", f(2, 2, 6), [1, 4]), C("hstack", L([f(2, 3), f(2, 1)])),
    C("vstack", L([f(2, 3), f(1, 3)])), C("row_stack", L([f(3), f(3)])),
    C("dstack", L([f(2, 3), f(2, 3)])), C("column_stack", L([f(3), f(3, 2)])),
    C("block_diag", L([f(2, 2), f(1, 3)])), C("split_with_num", f(6, 4), num=3),
    C("split_with_num", f(6, 4), num=2, axis=1), C("cartesian_prod", L([f(2), f(3)])),
    C("cartesian_prod", L([f(3)])), C("unflatten", f(2, 6), axis=1, shape=[2, 3]),
    C("take", f(3, 4), v([0, 5, 11, -1], "int32")),
    C("take", f(3, 4), v([0, 13, -14], "int32"), mode="wrap"),
    C("take", f(3, 4), v([0, 13, -14], "int32"), mode="clip"),
]
# search
CASES += [
    C("argmax", f(3, 4)), C("argmax", f(3, 4), axis=1), C("argmax", f(3, 4), axis=0,
                                                          keepdim=True),
    C("argmin", f(3, 4)), C("argmin", f(3, 4), axis=-1),
    C("argsort", v([[3, 1, 3, 2], [1, 1, 0, 1]], "int32")),
    C("argsort", v([[3, 1, 3, 2], [1, 1, 0, 1]], "int32"), descending=True),
    C("argsort", f(3, 4), axis=0), C("sort", f(3, 4)), C("sort", f(3, 4), axis=0,
                                                         descending=True),
    C("sort", v([[3, 1, 3, 2]], "int32"), descending=True),
    C("topk", f(3, 5), 2), C("topk", f(3, 5), 2, axis=0, largest=False),
    C("topk", v([[1, 3, 3, 2, 3]], "int32"), 2),
    C("kthvalue", f(3, 5), 2), C("kthvalue", v([[2, 1, 2, 1, 2]], "int32"), 3, keepdim=True),
    C("kthvalue", f(4, 3), 1, axis=0),
    C("mode", v([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], "int32")),
    C("mode", v([[1, 2], [1, 3], [2, 3]], "int32"), axis=0),
    C("searchsorted", v([1.0, 2.0, 3.0, 5.0]), f(6, lo=0, hi=6)),
    C("searchsorted", v([1.0, 2.0, 3.0, 5.0]), v([2.0, 3.0, 4.0]), right=True),
    C("searchsorted", v([[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]]), v([[3.0], [3.0]])),
    C("bucketize", v([2.0, 3.0, 4.0]), v([1.0, 2.0, 3.0, 5.0])),
    C("bucketize", f(5, lo=0, hi=6), v([1.0, 2.0, 3.0, 5.0]), right=True),
    C("index_fill", f(4, 3), v([0, 2], "int32"), 0, -1.0),
    C("index_fill", f(4, 3), v([1], "int32"), 1, 2.0),
    C("edit_distance", v([[1, 2, 3, 4], [1, 1, 2, 0]], "int32"),
      v([[1, 3, 4, 0], [1, 2, 2, 2]], "int32")),
    C("edit_distance", v([[1, 2, 3, 4], [1, 1, 2, 0]], "int32"),
      v([[1, 3, 4, 0], [1, 2, 2, 2]], "int32"), normalized=False,
      input_length=v([4, 3], "int32"), label_length=v([3, 4], "int32")),
]
# linalg
CASES += [
    C("matmul", f(3, 4), f(4, 5)), C("matmul", f(2, 3, 4), f(4, 5)),
    C("matmul", f(3, 4), f(5, 4), transpose_y=True), C("matmul", f(4, 3), f(4, 5), True),
    C("matmul", f(4), f(4, 2)), C("mm", f(3, 4), f(4, 2)), C("bmm", f(2, 3, 4), f(2, 4, 2)),
    C("mv", f(3, 4), f(4)), C("dot", f(4), f(4)), C("dot", f(3, 4), f(3, 4)), C("t", f(3, 4)),
    C("t", f(3)), C("cross", f(4, 3), f(4, 3)), C("cross", f(3, 4), f(3, 4), axis=0),
    C("dist", f(3, 4), f(3, 4)), C("dist", f(3, 4), f(3, 4), p=1),
    C("dist", f(3, 4), f(3, 4), p=float("inf")), C("norm", f(3, 4)),
    C("norm", f(3, 4), p=1, axis=1), C("norm", f(3, 4), p="fro", axis=[0, 1]),
    C("norm", f(3, 4), p=float("inf"), axis=0, keepdim=True), C("norm", f(3, 4), p=3.0, axis=1),
    C("einsum", "ij,jk->ik", f(3, 4), f(4, 2)), C("einsum", "bij->bji", f(2, 3, 4)),
    C("einsum", "i,i->", f(4), f(4)), C("matrix_transpose", f(2, 3, 4)),
    C("multi_dot", L([f(3, 4), f(4, 5), f(5, 2)])),
    C("bincount", i(20, hi=6)), C("bincount", i(20, hi=6), minlength=8),
    C("bincount", i(10, hi=4), weights=f(10), grad=False), C("histogram", f(30), bins=5),
    C("histogram", f(30), bins=4, min=-1.0, max=1.0), C("corrcoef", f(3, 6)),
    C("cov", f(3, 6)), C("cov", f(6, 3), rowvar=False, ddof=False),
    C("cdist", f(4, 3), f(5, 3)), C("cdist", f(4, 3), f(5, 3), p=1.0),
    C("cdist", f(2, 4, 3), f(2, 5, 3), compute_mode="donot_use_mm_for_euclid_dist"),
    C("vector_norm", f(3, 4)), C("vector_norm", f(3, 4), p=1.0, axis=1),
    C("vector_norm", f(3, 4), p=float("inf"), axis=[0, 1], keepdim=True),
    C("vector_norm", f(3, 4), p=0), C("vector_norm", f(3, 4), keepdim=True),
    C("matrix_norm", f(3, 4)), C("matrix_norm", f(3, 4), p=1),
    C("matrix_norm", f(3, 4), p=float("inf")), C("matrix_norm", f(2, 3, 4), p="nuc", tol=LOOSE),
    C("matrix_norm", f(3, 4), p=2, tol=LOOSE), C("pdist", f(4, 3), grad=False), C("pdist", f(4, 3), p=1.0, grad=False),
    C("addmm", f(3, 2), f(3, 4), f(4, 2)), C("addmm", f(3, 2), f(3, 4), f(4, 2), 0.5, 2.0),
    C("tensordot", f(3, 4, 5), f(4, 5, 2)), C("tensordot", f(3, 4), f(4, 5), axes=1),
    C("tensordot", f(3, 4, 5), f(5, 3), axes=[[0, 2], [1, 0]]), C("vdot", f(4), f(4)),
    C("vecdot", f(3, 4), f(3, 4)), C("vecdot", f(3, 4), f(3, 4), axis=0),
    C("frobenius_norm", f(3, 4)), C("frobenius_norm", f(3, 4), axis=[1], keepdim=True),
]
# creation
_NORMAL = {"draw": _normal}
CASES += [
    C("zeros", [2, 3]), C("zeros", [2, 3], "int32"), C("ones", [2, 3]),
    C("ones", [2, 3], "bool"), C("full", [2, 3], 1.5), C("full", [2, 3], 2),
    C("full", [2, 3], True), C("full", [2, 3], 2, "float32"), C("empty", [2, 3]),
    C("zeros_like", f(2, 3)), C("ones_like", i(2, 3)), C("ones_like", f(2, 3), "int32"),
    C("full_like", f(2, 3), 4.0), C("full_like", i(2, 3), 7), C("empty_like", f(2, 3)),
    C("arange", 5), C("arange", 1, 7, 2), C("arange", 0.0, 1.0, 0.25),
    C("arange", 2, 10, 3, "float32"), C("linspace", 0.0, 1.0, 5), C("linspace", -2, 2, 4),
    C("logspace", 0.0, 2.0, 3), C("logspace", 0.0, 3.0, 4, base=2.0), C("eye", 3),
    C("eye", 2, 4), C("eye", 3, dtype="int32"), C("diag", f(3)), C("diag", f(3), offset=1),
    C("diag", f(3, 4)), C("diag", f(3, 4), offset=-1), C("diag", f(3), padding_value=2.0),
    C("diagflat", f(2, 2)), C("diagflat", f(3), offset=-1), C("diag_embed", f(2, 3)),
    C("diag_embed", f(2, 3), offset=1), C("tril", f(4, 4)), C("tril", f(3, 4), 1),
    C("triu", f(4, 4)), C("triu", f(3, 4), -1), C("meshgrid", f(3), f(2)),
    C("meshgrid", L([f(3), f(2), f(4)])), C("clone", f(3, 4)), C("tril_indices", 4, 4),
    C("tril_indices", 4, 3, -1), C("triu_indices", 4), C("triu_indices", 3, 4, 1),
    C("complex", f(3), f(3), grad=False), C("vander", f(4)), C("vander", f(3), n=4, increasing=True),
    C("rand", [500], draw=_within(0.0, 1.0)), C("randn", [4000], **_NORMAL), C("standard_normal", [4000], **_NORMAL),
    C("normal", shape=[4000], **_NORMAL), C("normal", 2.0, 0.5, [4000],
                                            draw=lambda a: abs(a.mean() - 2) < 0.05),
    C("normal", v(np.zeros(4000)), v(np.ones(4000)), **_NORMAL),
    C("uniform", [4000], min=-2.0, max=3.0, draw=_within(-2.0, 3.0)),
    C("uniform", [100], seed=5, draw=_within(-1.0, 1.0)),
    C("randint", 0, 5, [400], draw=_within(0, 4)), C("randint", 10, draw=_within(0, 9)),
    C("randint_like", i(50), 3, 8, draw=_within(3, 7)), C("randperm", 20,
                                                          draw=lambda a: sorted(a.tolist())
                                                          == list(range(20))),
    C("bernoulli", v(np.full(4000, 0.3)), draw=lambda a: _binary(a) and abs(a.mean() - .3) < .05),
    C("multinomial", v([0.1, 0.2, 0.7]), 50, True, draw=_within(0, 2)),
    C("multinomial", v([[0.2, 0.3, 0.5, 0.0]] * 3), 3, draw=lambda a: all(
        sorted(r) == [0, 1, 2] for r in a.tolist())),
    C("poisson", v(np.full(4000, 3.0)), draw=lambda a: abs(a.mean() - 3) < 0.2),
    C("binomial", v(np.full(2000, 10), "int32"), v(np.full(2000, 0.3)),
      draw=lambda a: _within(0, 10)(a) and abs(a.mean() - 3) < 0.2),
    C("standard_gamma", v(np.full(4000, 2.0)), draw=lambda a: abs(a.mean() - 2) < 0.15),
    C("log_normal", 0.0, 0.5, [4000], draw=lambda a: abs(np.log(a).std() - .5) < .05),
    C("rand_like", f(500), draw=_within(0.0, 1.0)), C("randn_like", f(4000), **_NORMAL),
    C("exponential_", f(4000), 2.0, draw=lambda a: abs(a.mean() - 0.5) < 0.05),
    C("geometric_", f(4000), 0.5, draw=lambda a: a.min() >= 1 and abs(a.mean() - 2) < 0.15),
    C("normal_", f(4000), 1.0, 2.0, draw=lambda a: abs(a.mean() - 1) < 0.15),
    C("log_normal_", f(4000), 0.0, 0.5, draw=lambda a: a.min() > 0),
    C("cauchy_", f(4000), draw=lambda a: abs(np.median(a)) < 0.15),
    C("bernoulli_", f(4000), 0.25, draw=lambda a: _binary(a) and abs(a.mean() - .25) < .05),
    C("histogramdd", f(20, 2), bins=3, first=True),
    C("histogramdd", f(20, 2), bins=[2, 3], ranges=[[-2.0, 2.0], [-1.0, 1.0]], first=True),
    C("top_p_sampling", f(3, 6), v([0.5, 0.9, 0.99]),
      draw=lambda a: a.shape == (3, 1) and bool(np.all(a > 0)), first=True),
]
# nn.functional through the registry
_LOGITS = f(4, 5)
_LABELS = i(4, hi=5)
CASES += [
    C("celu", f(3, 4)), C("elu", f(3, 4), 0.5), C("gelu", f(3, 4)),
    C("gelu", f(3, 4), approximate=True), C("glu", f(3, 4)),
    C("gumbel_softmax", f(400, 5), draw=lambda a: np.allclose(a.sum(-1), 1, atol=1e-5)),
    C("hardshrink", f(3, 4)), C("hardtanh", f(3, 4)), C("leaky_relu", f(3, 4), 0.1),
    C("log_softmax", f(3, 4)), C("log_softmax", f(3, 4), axis=0),
    C("maxout", f(2, 4, 3, 3), 2), C("prelu", f(2, 3, 4), pos(3)),
    C("rrelu", f(3, 4), training=False), C("selu", f(3, 4)), C("softmax", f(3, 4)),
    C("softmax", f(3, 4), axis=0), C("softmax_", f(3, 4), grad=False),
    C("softplus", f(3, 4)), C("softshrink", f(3, 4)), C("swiglu", f(3, 8)),
    C("swiglu", f(3, 4), f(3, 4)), C("thresholded_relu", f(3, 4), 0.5),
    C("flash_attention", f(1, 8, 2, 16), f(1, 8, 2, 16), f(1, 8, 2, 16), first=True,
      tol=ATTN_F32),
    C("flash_attention", f(1, 8, 4, 16), f(1, 8, 2, 16), f(1, 8, 2, 16), causal=True,
      first=True, tol=ATTN_F32),
    C("scaled_dot_product_attention", f(2, 8, 2, 16), f(2, 8, 2, 16), f(2, 8, 2, 16),
      tol=ATTN_F32),
    C("scaled_dot_product_attention", f(1, 8, 4, 16), f(1, 8, 2, 16), f(1, 8, 2, 16),
      is_causal=True, tol=ATTN_F32),
    C("alpha_dropout", f(3, 4), training=False),
    C("dropout", f(4000), 0.25, draw=lambda a: abs((a == 0).mean() - 0.25) < 0.05),
    C("dropout", f(3, 4), 0.5, training=False), C("dropout2d", f(2, 3, 4, 4), training=False),
    C("dropout3d", f(2, 3, 2, 2, 2), training=False),
    C("embedding", i(2, 3), f(10, 4)), C("embedding", i(2, 3), f(10, 4), padding_idx=0),
    C("linear", f(3, 4), f(4, 5)), C("linear", f(3, 4), f(4, 5), f(5)),
    C("conv1d", f(2, 3, 8), f(4, 3, 3)), C("conv1d", f(2, 3, 8), f(4, 3, 3), f(4), stride=2,
                                           padding=1),
    C("conv2d", f(2, 3, 6, 6), f(4, 3, 3, 3)), C("conv2d", f(1, 4, 5, 5), f(4, 2, 3, 3),
                                                 padding=1, groups=2),
    C("conv3d", f(1, 2, 4, 4, 4), f(3, 2, 2, 2, 2)),
    C("conv1d_transpose", f(2, 4, 5), f(4, 3, 3)),
    C("conv2d_transpose", f(1, 4, 4, 4), f(4, 2, 3, 3), stride=2),
    C("conv3d_transpose", f(1, 2, 3, 3, 3), f(2, 2, 2, 2, 2)),
    C("adaptive_avg_pool1d", f(2, 3, 8), 3), C("adaptive_avg_pool2d", f(2, 3, 6, 6), 2),
    C("adaptive_max_pool1d", f(2, 3, 8), 4), C("adaptive_max_pool2d", f(2, 3, 6, 6), 3),
    C("avg_pool1d", f(2, 3, 8), 2), C("avg_pool2d", f(2, 3, 6, 6), 2, 2),
    C("avg_pool3d", f(1, 2, 4, 4, 4), 2), C("max_pool1d", f(2, 3, 8), 2),
    C("max_pool2d", f(2, 3, 6, 6), 3, 2, 1), C("max_pool3d", f(1, 2, 4, 4, 4), 2),
    C("batch_norm", f(4, 3, 5), f(3), pos(3), f(3), f(3)),
    C("layer_norm", f(2, 5, 8), 8, f(8), f(8)), C("rms_norm", f(4, 8), f(8)),
    C("rms_norm", f(4, 8)),
    C("binary_cross_entropy", prob(4, 3), Spec((4, 3), "i", 0, 2, "float32")),
    C("binary_cross_entropy_with_logits", f(4, 3), Spec((4, 3), "i", 0, 2, "float32")),
    C("cosine_embedding_loss", f(4, 6), f(4, 6), v([1, -1, 1, -1], "int32")),
    C("cross_entropy", _LOGITS, _LABELS), C("cross_entropy", _LOGITS, _LABELS,
                                            reduction="sum"),
    C("cross_entropy", _LOGITS, v([1, -100, 3, 0], "int32")),
    C("ctc_loss", v(np.log(np.full((6, 2, 4), 0.25))), v([[1, 2, 3], [1, 1, 0]], "int32"),
      v([6, 5], "int32"), v([3, 2], "int32"), grad=False),
    C("dice_loss", prob(2, 4, 3), i(2, 4, 1, hi=3)),
    C("gaussian_nll_loss", f(3, 4), f(3, 4), pos(3, 4)),
    C("hinge_embedding_loss", f(4, 5), v(np.where(np.arange(20).reshape(4, 5) % 2, 1.0, -1.0))),
    C("hinge_loss", f(4, 1), Spec((4, 1), "i", 0, 2, "float32")),
    C("hsigmoid_loss", f(4, 6), i(4, hi=5), 5, f(4, 6), f(4, 1)),
    C("huber_loss", f(3, 4), f(3, 4)), C("kl_div", f(3, 4), prob(3, 4)),
    C("l1_loss", f(3, 4), f(3, 4)), C("log_loss", prob(4, 1), Spec((4, 1), "i", 0, 2,
                                                                   "float32")),
    C("margin_cross_entropy", unit(4, 5), _LABELS, reduction="mean", first=True),
    C("margin_ranking_loss", f(5), f(5), v([1.0, -1.0, 1.0, -1.0, 1.0])),
    C("mse_loss", f(3, 4), f(3, 4)), C("multi_margin_loss", f(4, 5), _LABELS),
    C("nll_loss", f(4, 5), _LABELS), C("npair_loss", f(4, 6), f(4, 6),
                                       v([0.0, 1.0, 2.0, 0.0])),
    C("poisson_nll_loss", f(3, 4), pos(3, 4)),
    C("rnnt_loss", f(1, 3, 3, 4), i(1, 2, lo=1, hi=4), v([3], "int32"), v([2], "int32")),
    C("sigmoid_focal_loss", f(4, 3), Spec((4, 3), "i", 0, 2, "float32")),
    C("smooth_l1_loss", f(3, 4), f(3, 4)), C("soft_margin_loss", f(3, 4),
                                              v(np.where(np.arange(12).reshape(3, 4) % 3,
                                                         1.0, -1.0))),
    C("softmax_with_cross_entropy", _LOGITS, i(4, 1, hi=5)),
    C("square_error_cost", f(3, 4), f(3, 4)),
    C("triplet_margin_loss", f(4, 6), f(4, 6), f(4, 6)),
]
# the literal inputs of the reference's own op tests (tests/test_ops.py)
CASES += [
    C("unique", v([1, 2, 2, 3, 1], "int32"), return_counts=True),
    C("nonzero", v([0, 1, 0, 2], "int32")),
    C("less_than", v([1.0, 2.0, 3.0]), v([2.0, 2.0, 2.0])),
    C("greater_equal", v([1.0, 2.0, 3.0]), v([2.0, 2.0, 2.0])),
    C("logical_xor", v([True, False], "bool"), v([True, True], "bool")),
    C("cummax", v([1.0, 3.0, 2.0, 5.0])),
    C("diff", v([2.0, 4.0, 7.0]), prepend=v([0.0])),
    C("unique_consecutive", v([[1, 1], [1, 1], [2, 3], [2, 3], [1, 1]], "int32"), axis=0,
      return_counts=True),
    C("unique", v([[1, 1, 2], [3, 3, 4]], "int32"), return_inverse=True),
]
# the reference raises on as_strided (no strided views): numpy's is the reference
CASES += [C("as_strided", f(4, 4), [2, 2], [4, 1], 1, ref="@as_strided", grad=False)]


# -- running ----------------------------------------------------------------
def make_inputs(case: Case, seed: int):
    """The case's arguments with numpy arrays in place of specs (a list
    spec as a list of arrays)."""
    rng = np.random.RandomState(seed)

    def mk(a):
        if isinstance(a, L):
            return L(mk(x) for x in a)
        return a.make(rng) if isinstance(a, Spec) else a

    return tuple(mk(a) for a in case.args), {k: mk(a) for k, a in case.kw.items()}


def to_port(value, device, grad: bool):
    """A numpy argument as a port tensor on ``device`` (floats require grad
    when asked); a list of them as a list."""
    from ..tensor import from_numpy

    if isinstance(value, L):
        return [to_port(x, device, grad) for x in value]
    if not isinstance(value, np.ndarray):
        return value
    t = from_numpy(value).to(device)
    if grad and t.is_floating_point():
        t.requires_grad_(True)
    return t


def flat_outputs(out) -> list:
    """An op's result as a flat list (tensors, arrays and Python values)."""
    if isinstance(out, (tuple, list)) and not (out and isinstance(out[0], (int, float))):
        return [x for o in out for x in flat_outputs(o)]
    return [out]


def dtype_class(dtype_name: str) -> str:
    if dtype_name == "bool":
        return "bool"
    if dtype_name.startswith("complex"):
        return "complex"
    return "float" if dtype_name.startswith(("float", "bfloat")) else "int"


def run(case: Case, device, seed: int = 0, grad: bool = False, generator=None):
    """The port's result of ``case`` on ``device`` as numpy arrays, their
    dtype names and, with ``grad``, the gradients of the float inputs
    under a fixed cotangent (None where a result is not float)."""
    import torch

    from .. import dtype as _dt
    from ..ops.registry import OP_REGISTRY

    args, kw = make_inputs(case, seed)
    targs = [to_port(a, device, grad) for a in args]
    tkw = {k: to_port(a, device, grad) for k, a in kw.items()}
    out = OP_REGISTRY[case.op].fn(*targs, **tkw)
    outs = flat_outputs(out)
    if case.first:
        outs = outs[:1]
    leaves = [t for t in _leaves(targs) + _leaves(list(tkw.values()))
              if isinstance(t, torch.Tensor) and t.requires_grad]
    grads = None
    floats = [o for o in outs if isinstance(o, torch.Tensor) and o.requires_grad]
    if grad and leaves and floats:
        rng = np.random.RandomState(seed + 1)
        loss = sum((o * torch.from_numpy(np.asarray(rng.standard_normal(o.shape), np.float32))
                    .to(device=o.device, dtype=o.dtype)).sum() for o in floats)
        grads = [None if g is None else g.detach().cpu().float().numpy(force=True)
                 for g in torch.autograd.grad(loss, leaves, allow_unused=True)]
    vals, names = [], []
    for o in outs:
        if isinstance(o, torch.Tensor):
            names.append(_dt.dtype_name(o.dtype))
            o = o.detach().cpu()
            vals.append(o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy())
        else:
            names.append(type(o).__name__)
            vals.append(np.asarray(o))
    return vals, names, grads


def _leaves(values):
    out = []
    for x in values:
        out.extend(_leaves(x) if isinstance(x, list) else [x])
    return out


def _held(cond, what):
    if not cond:
        raise AssertionError(what)


def compare(got, want, names, tol=None) -> float:
    """The largest error of ``got`` against ``want`` (lists of arrays) in
    units of each result's tolerance; raises AssertionError past 1."""
    worst = 0.0
    _held(len(got) == len(want), f"{len(got)} results against {len(want)}")
    for g, w, name in zip(got, want, names):
        g, w = np.asarray(g), np.asarray(w)
        _held(g.shape == w.shape, f"shape {g.shape} against {w.shape}")
        rtol, atol = tol or TOLERANCE[dtype_class(name)]
        if rtol == 0 and atol == 0:
            _held(np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"), f"{g} != {w}")
            continue
        g64, w64 = g.astype(np.complex128), w.astype(np.complex128)
        same = np.isnan(g64) & np.isnan(w64) | (g64 == w64)
        err = np.where(same, 0.0, np.abs(g64 - w64) / (atol + rtol * np.abs(w64)))
        worst = max(worst, float(err.max()) if err.size else 0.0)
        _held(worst <= 1.0, f"{g} against {w}: {worst} of the tolerance")
    return worst


def card_vs_cpu(seed: int = 0, only=None) -> dict:
    """Every case (those at the indices ``only``) through the port on the
    card and on the CPU (chip_smoke phase 23b): ``{"run", "held", "worst":
    {class: error in units of the class's tolerance}, "worst_case": {class:
    "op#index"}, "failures"}``.
    A drawing op is held by shape, dtype and its check on the card, and by
    its replay from one generator state (bit for bit)."""
    import torch

    from ..framework.random import default_generator

    cuda = torch.device("cuda")
    worst = {k: 0.0 for k in TOLERANCE}
    worst_case = {k: None for k in TOLERANCE}
    failures, held = [], 0
    picked = [(n, CASES[n]) for n in only] if only is not None else list(enumerate(CASES))
    for n, case in picked:
        try:
            if case.draw is not None:
                gen = default_generator(cuda)
                state = gen.get_state()
                vals, names, _ = run(case, cuda, seed + n)
                cpu_vals, cpu_names, _ = run(case, "cpu", seed + n)
                gen.set_state(state)
                again, _, _ = run(case, cuda, seed + n)
                _held(names == cpu_names, f"dtypes {names} against {cpu_names}")
                _held([a.shape for a in vals] == [a.shape for a in cpu_vals], "shapes")
                _held(case.draw(vals[0]), "the draw's check failed")
                _held(all(np.array_equal(a, b, equal_nan=True) for a, b in zip(vals, again)),
                      "no replay from the generator's state")
            else:
                vals, names, _ = run(case, cuda, seed + n)
                cpu_vals, cpu_names, _ = run(case, "cpu", seed + n)
                _held(names == cpu_names, f"dtypes {names} against {cpu_names}")
                err = compare(vals, cpu_vals, names, case.tol)
                for cls in {dtype_class(name) for name in names}:
                    if err > worst[cls]:
                        worst[cls], worst_case[cls] = err, f"{case.op}#{n}"
            held += 1
        except Exception as exc:    # noqa: BLE001 (every case is reported)
            failures.append(f"{case.op}#{n}: {type(exc).__name__}: {str(exc)[:200]}")
    return {"run": len(picked), "held": held, "worst": worst, "worst_case": worst_case,
            "failures": failures, "ops": len({c.op for _, c in picked})}


def _main() -> int:
    res = card_vs_cpu()
    print({k: v for k, v in res.items() if k != "failures"})
    for line in res["failures"]:
        print("  FAILED", line)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(_main())
