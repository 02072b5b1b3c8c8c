"""PyTorch port: ``metric`` against the reference, on the CPU.

Each metric takes the same numpy predictions and labels on both sides
over several ``update`` calls of different batch sizes; ``compute``,
each ``update``'s return, ``accumulate`` and ``name`` are compared.
Scores are untied (distinct draws from a continuous distribution): the
port takes the top k with ``torch.topk``, the reference with
``np.argsort``, and tied scores may order differently. The counts are
exact, and so are the accuracies (the same integer counts divided); the
AUC sums the same bucket counts in the same order, exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as rmetric
from paddle_tpu_torch import metric as pmetric

BATCHES = (7, 16, 1, 30)


def _batches(seed, classes, label_shape):
    rng = np.random.RandomState(seed)
    for n in BATCHES:
        pred = rng.randn(n, classes).astype(np.float32)
        yield pred, rng.randint(0, classes, (n,) + label_shape).astype(np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
@pytest.mark.parametrize("label_shape", [(), (1,)])
def test_accuracy_equals_the_references(topk, label_shape):
    got, want = pmetric.Accuracy(topk=topk), rmetric.Accuracy(topk=topk)
    assert got.name() == want.name()
    for pred, label in _batches(0, 10, label_shape):
        c_got = got.compute(torch.from_numpy(pred), torch.from_numpy(label))
        c_want = want.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want._data))
        assert got.update(c_got) == want.update(c_want)
    assert got.accumulate() == want.accumulate()
    got.reset()
    assert got.accumulate() == (0.0 if len(got.topk) == 1 else [0.0] * len(got.topk))


def test_accuracy_functional_equals_the_references():
    for pred, label in _batches(1, 6, (1,)):
        for k in (1, 2):
            got = pmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label), k=k)
            want = rmetric.accuracy(paddle.to_tensor(pred), paddle.to_tensor(label), k=k)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert float(got) == float(np.asarray(want._data))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall_equal_the_references(cls):
    got, want = getattr(pmetric, cls)(), getattr(rmetric, cls)()
    assert got.accumulate() == want.accumulate() == 0.0
    rng = np.random.RandomState(2)
    for n in BATCHES:
        preds = rng.rand(n, 1).astype(np.float32)
        labels = rng.randint(0, 2, (n, 1)).astype(np.int64)
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        assert got.accumulate() == want.accumulate()
    assert got.name() == want.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_equals_the_references(two_columns):
    got, want = pmetric.Auc(num_thresholds=255), rmetric.Auc(num_thresholds=255)
    rng = np.random.RandomState(3)
    for n in BATCHES:
        pos = rng.rand(n).astype(np.float32)
        preds = np.stack([1 - pos, pos], 1) if two_columns else pos
        labels = (rng.rand(n) < pos).astype(np.int64)
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(preds, labels)
        np.testing.assert_array_equal(got._stat_pos, want._stat_pos)
        np.testing.assert_array_equal(got._stat_neg, want._stat_neg)
        assert got.accumulate() == want.accumulate()
    assert 0.5 < got.accumulate() < 1
    assert got.name() == want.name() == "auc"
