"""``paddle.metric`` of the port (counterpart of ``paddle_tpu/metric``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
``accuracy``.

``Accuracy.compute`` takes the top k on the predictions' device
(``torch.topk``; the reference sorts on the host, and ties may order
differently), and ``update`` reads one sum a k back to the host. The
others count on the host in numpy, ``Auc`` by ``np.add.at`` over its
threshold buckets where the reference loops.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``; named ``name`` (default
    "acc") for one k, else ``{name}_top{k}`` each."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[..., maxk]`` f32: 1 where the i-th highest score is the
        label's class (a trailing label axis of 1 is dropped)."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        if label.dim() == pred.dim() and label.shape[-1] == 1:
            label = label.squeeze(-1)
        idx = torch.topk(pred, self.maxk, dim=-1).indices
        return (idx == label[..., None]).float()

    def update(self, correct):
        """Add a :meth:`compute` result; the accuracies so far (one number
        for one k)."""
        c = torch.as_tensor(correct)
        rows = int(np.prod(c.shape[:-1]))
        accs = []
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += rows
            accs.append(self.total[i] / max(self.count[i], 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision, a prediction positive above 0.5."""

    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pos = _host(preds).reshape(-1) > 0.5
        lab = _host(labels).reshape(-1)
        self.tp += int((pos & (lab == 1)).sum())
        self.fp += int((pos & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall, a prediction positive above 0.5."""

    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pos = _host(preds).reshape(-1) > 0.5
        lab = _host(labels).reshape(-1)
        self.tp += int((pos & (lab == 1)).sum())
        self.fn += int((~pos & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` buckets of the positive score
    (column 1 of a 2-D prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        lab = _host(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0, self.num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area, pos, neg = 0.0, 0.0, 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The top-``k`` accuracy of one batch, as an f32 scalar tensor on the
    input's device."""
    m = Accuracy(topk=(k,))
    m.update(m.compute(input, label))
    return torch.tensor(m.accumulate(), dtype=torch.float32,
                        device=torch.as_tensor(input).device)
