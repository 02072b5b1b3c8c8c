"""PyTorch port: the shape, layout, indexing and search ops of the registry
(``ops/manipulation.py``, ``ops/search.py``, ``ops/einsum_indexing.py``)
against the reference on the CPU.

Every case of ``paddle_tpu_torch.tools.op_cases`` whose op lives in those
modules runs through both packages on the same numpy inputs
(``torch_op_parity.check_case``; each op's first case in tier 1, its
further cases in the slow tier with the first as their sibling: values to rtol 1e-4 / atol 1e-5 in f32,
integer and boolean results exactly, dtype names equal, gradients against
the reference's ``jax.vjp``). Where the reference departs from Paddle's
documented rule the port follows the rule and the case says so
(``torch_op_parity.ADAPTERS``: ``reshape`` keeps a dimension given as 0,
``scatter``'s last duplicate wins and ``overwrite=False`` zeroes the
rows it writes, ``masked_select``'s mask broadcasts). Then Paddle's
conventions on their own, and the order of sorts' and ``unique``'s
results.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_parity import case_params, check_case, port_globals  # noqa: F401


@pytest.mark.parametrize("case, seed", case_params(
    lambda c: OP_REGISTRY[c.op].module in ("manipulation", "search")))
def test_op_matches_reference(case, seed):
    check_case(case, seed)


def test_paddles_argument_conventions():
    x = port.arange(24).reshape([2, 3, 4])
    assert port.reshape(x, [0, -1]).shape == (2, 12)
    assert port.reshape(x, [0, 0, 2, 2]).shape == (2, 3, 2, 2)
    parts = port.split(x, [1, -1, 1], axis=2)
    assert [p.shape[2] for p in parts] == [1, 2, 1]
    with pytest.raises(ValueError, match="not divisible"):
        port.split(x, 3, axis=2)
    rows = port.gather(port.arange(12).reshape([4, 3]), port.to_tensor([3, 0, 3]))
    assert rows.tolist() == [[9, 10, 11], [0, 1, 2], [9, 10, 11]]
    assert port.expand(port.ones([1, 3]), [2, -1, 3]).shape == (2, 1, 3)
    assert port.expand(port.ones([2, 1]), [-1, 5]).shape == (2, 5)
    assert port.flatten(x, start_axis=1, stop_axis=2).shape == (2, 12)
    assert port.squeeze(port.ones([1, 3, 1]), axis=[0, 1]).shape == (3, 1)


def test_scatter_follows_paddles_documented_example():
    x = port.to_tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
    index = port.to_tensor([2, 1, 0, 1])
    updates = port.to_tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [4.0, 4.0]])
    assert port.scatter(x, index, updates).tolist() == [[3, 3], [4, 4], [1, 1]]
    assert port.scatter(x, index, updates, overwrite=False).tolist() == [[3, 3], [6, 6],
                                                                         [1, 1]]
    port.scatter_(x, index, updates)
    assert x.tolist() == [[3, 3], [4, 4], [1, 1]]


def test_order_of_sorts_ties_and_unique():
    x = port.to_tensor([3, 1, 3, 2, 1])
    assert port.argsort(x).tolist() == [1, 4, 3, 0, 2]
    assert port.argsort(x, descending=True).tolist() == [2, 0, 3, 4, 1]
    vals, idx = port.topk(x, 2)
    assert vals.tolist() == [3, 3] and idx.tolist() == [0, 2]
    vals, idx = port.kthvalue(x, 2)
    assert int(vals) == 1 and int(idx) == 4
    vals, counts = port.mode(port.to_tensor([[1, 2, 2, 1, 3]]))
    assert vals.tolist() == [1] and counts.tolist() == [2]
    out, first, inverse, counts = port.unique(x, return_index=True, return_inverse=True,
                                              return_counts=True)
    assert out.tolist() == [1, 2, 3] and first.tolist() == [1, 3, 0]
    assert inverse.tolist() == [2, 0, 2, 1, 0] and counts.tolist() == [2, 1, 2]
    for t in (idx, first, inverse, counts, port.argmax(x), port.nonzero(x)):
        assert t.dtype == torch.int32


def test_getitem_and_setitem():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = port.to_tensor(a, stop_gradient=False)
    y = port.getitem(x, (port.to_tensor([0, 2]), slice(1, 3)))
    np.testing.assert_array_equal(y.detach().numpy(), a[[0, 2], 1:3])
    z = port.multiply(x, 1.0)
    port.setitem(z, (slice(None), [0]), 5)
    port.setitem(z, port.to_tensor([False, True, False]), port.to_tensor(-1.0))
    want = a.copy()
    want[:, 0] = 5
    want[1] = -1
    np.testing.assert_array_equal(z.detach().numpy(), want)
    z.sum().backward()
    grad = np.ones_like(a)
    grad[:, 0] = 0
    grad[1] = 0
    np.testing.assert_array_equal(x.grad.numpy(), grad)
