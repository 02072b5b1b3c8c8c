"""PyTorch port: the elementwise, reduction, comparison and logical ops of
the registry (the ops of ``ops/math.py`` and ``ops/logic.py``, table-driven
and hand-written) against the reference on the CPU.

Every case of ``paddle_tpu_torch.tools.op_cases`` whose op lives in those
modules runs through both packages on the same numpy inputs
(``torch_op_parity.check_case``; each op's first case in tier 1, its
further cases in the slow tier with the first as their sibling: values to rtol 1e-4 / atol 1e-5 in f32,
integer and boolean results exactly, dtype names equal, the gradients of
every float input under a seeded cotangent against the reference's
``jax.vjp``). Then the conventions on their own: the reference's
promotion of Python scalars, integer division to float, the divisor's
sign in ``floor_divide`` and ``mod``, 32-bit integer results, the dtype
guards and the in-place variants.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_parity import case_params, check_case, port_globals  # noqa: F401


@pytest.mark.parametrize("case, seed", case_params(
    lambda c: OP_REGISTRY[c.op].module in ("math", "logic")))
def test_op_matches_reference(case, seed):
    check_case(case, seed)


@pytest.mark.parametrize("dtype, scalar", [
    ("bfloat16", 1.5), ("float16", 2), ("int32", 2.5), ("int32", 3), ("bool", 1),
    ("float32", 0.1), ("int8", 7)])
def test_python_scalars_promote_as_the_reference(dtype, scalar):
    a = np.arange(6).reshape(2, 3).astype("float32")
    ref = paddle.add(paddle.to_tensor(a).astype(dtype), scalar)
    got = port.add(port.cast(port.to_tensor(a), dtype), scalar)
    assert port.dtype.dtype_name(got.dtype) == np.dtype(ref._data.dtype).name
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref._data, np.float32))
    rev = port.subtract(scalar, port.cast(port.to_tensor(a), dtype))
    assert rev.dtype == got.dtype


def test_integer_division_and_the_divisors_sign():
    x = port.to_tensor([7, -7, 7, -7])
    y = port.to_tensor([2, 2, -2, -2])
    assert port.divide(x, y).dtype == torch.float32
    np.testing.assert_array_equal(port.divide(x, y).numpy(), [3.5, -3.5, -3.5, 3.5])
    np.testing.assert_array_equal(port.floor_divide(x, y).numpy(), [3, -4, -4, 3])
    np.testing.assert_array_equal(port.mod(x, y).numpy(), [1, 1, -1, -1])
    np.testing.assert_array_equal(port.remainder(x, y).numpy(), port.mod(x, y).numpy())
    assert port.floor_divide(x, y).dtype == torch.int32


def test_integer_results_are_32_bit():
    x = port.to_tensor([[1, 2], [3, 4]])
    assert x.dtype == torch.int32
    for out in (port.sum(x), port.prod(x, axis=0), port.cumsum(x), port.sum(x > 1),
                port.count_nonzero(x), port.trace(x), port.numel(x)):
        assert out.dtype == torch.int32, out.dtype
    assert port.mean(x).dtype == torch.float32


def test_dtype_guards_raise_as_the_reference():
    x = port.to_tensor([1, 2])
    for name in ("log", "rsqrt", "logsumexp", "nanmean", "erf"):
        with pytest.raises(TypeError, match=f"paddle.{name} expects dtype"):
            OP_REGISTRY[name].fn(x)
    with pytest.raises(TypeError, match="gcd expects dtype"):
        port.gcd(port.to_tensor([1.0]), port.to_tensor([2.0]))
    with pytest.raises(TypeError, match="bitwise_and expects dtype"):
        port.bitwise_and(port.to_tensor([1.0]), port.to_tensor([2.0]))


def test_inplace_variants_write_back_and_keep_autograd():
    x = port.to_tensor([1.0, 4.0, 9.0])
    out = port.sqrt_(x)
    assert out is x and torch.equal(x, torch.tensor([1.0, 2.0, 3.0]))
    w = port.to_tensor([1.0, 2.0], stop_gradient=False)
    h = port.multiply(w, 3.0)
    port.add_(h, 1.0)
    port.exp_(h)
    h.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), 3 * np.exp(3 * np.array([1.0, 2.0]) + 1),
                               rtol=1e-6)
    y = port.to_tensor([1.5, 2.5])
    port.cast_(y, "int32")
    assert y.dtype == torch.int32 and y.tolist() == [1, 2]
    with pytest.raises(RuntimeError, match="requires grad"):
        port.cast_(port.to_tensor([1.0], stop_gradient=False), "int32")
    names = set(port.ops.inplace_op_names())
    assert {"add", "subtract", "multiply", "divide", "exp", "sqrt", "tanh"} <= names


def test_reductions_take_paddles_axis_arguments():
    a = np.random.RandomState(0).randn(2, 3, 4).astype("float32")
    x = port.to_tensor(a)
    for axis in (None, 0, -1, [0, 2], (1,), [-1, -2]):
        for keepdim in (False, True):
            got = port.sum(x, axis=axis, keepdim=keepdim).numpy()
            want = np.sum(a, axis=None if axis is None else tuple(axis) if isinstance(
                axis, (list, tuple)) else axis, keepdims=keepdim)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert port.max(port.to_tensor(3.0)).shape == ()
