"""``paddle.Model`` of the port (counterpart of
``paddle_tpu/hapi/model.py``): ``prepare``, ``fit``, ``evaluate``,
``predict``, ``train_batch``, ``eval_batch``, ``save``, ``load``,
``parameters`` and ``summary`` over the port's ``TrainStep`` and
``EvalStep``.

It keeps the reference's semantics, quirks included: a dataset becomes a
``DataLoader`` of ``batch_size`` and ``shuffle`` alone (``fit``'s
``num_workers`` and ``drop_last`` are ignored: pass a ``DataLoader`` for
workers), on the device of the network's parameters; ``prepare`` ignores
``amp_configs``; ``fit`` ignores ``save_dir`` and ``callbacks``, reads each
step's loss on the host and stops after ``num_iters`` steps; ``evaluate``
builds an ``EvalStep`` a call and reads each batch's loss on the host;
``predict`` returns ``[list of per-batch arrays]``, or ``[stacked]``; the
optimizer state that ``save`` writes holds no moments, which
``TrainStep`` keeps itself.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import resolve_device
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader, Dataset
from ..jit.training import EvalStep, TrainStep
from ..models._weights import reference_state_dict, set_state_dict

__all__ = ["Model"]


def _as_list(x) -> list:
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        self._train_step = None
        return self

    def _device(self) -> torch.device:
        first = next(itertools.chain(self.network.parameters(), self.network.buffers()), None)
        return first.device if first is not None else resolve_device("cuda")

    def _make_loader(self, data, batch_size, shuffle):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              device=self._device())
        raise TypeError(f"unsupported data type {type(data)}")

    def _on_device(self, xs) -> list:
        dev = self._device()
        return [torch.as_tensor(x).to(dev) for x in xs]

    def _loss_fn(self, *batch):
        *xs, y = batch
        return self._loss(self.network(*xs), y)

    def _step(self):
        if self._train_step is None:
            self._train_step = TrainStep(self.network, self._optimizer, self._loss_fn)
        return self._train_step

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1, eval_freq=1,
            log_freq=10, save_dir=None, save_freq=1, verbose=2, drop_last=False, shuffle=True,
            num_workers=0, callbacks=None, accumulate_grad_batches=1, num_iters=None):
        """Train for ``epochs`` (or ``num_iters`` steps); ``{"loss": [each
        step's loss]}`` plus, with ``eval_data``, each evaluation's results
        every ``eval_freq`` epochs."""
        loader = self._make_loader(train_data, batch_size, shuffle)
        step = self._step()
        history = {"loss": []}
        it = 0
        for epoch in range(epochs):
            self.network.train()
            for batch in loader:
                loss = step(*_as_list(batch))
                it += 1
                if verbose and it % log_freq == 0:
                    print(f"epoch {epoch} step {it}: loss {float(loss.item()):.4f}")
                history["loss"].append(float(loss.item()))
                if num_iters is not None and it >= num_iters:
                    return history
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                for k, v in self.evaluate(eval_data, batch_size=batch_size, verbose=0).items():
                    history.setdefault(k, []).append(v)
        return history

    def _eval_outputs(self, *batch):
        *xs, y = batch
        out = self.network(*xs)
        return (self._loss(out, y) if self._loss is not None else out), out

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2, num_workers=0,
                 callbacks=None, num_iters=None):
        """The mean of the batches' losses and each metric's accumulated
        value, by the metrics' names, in eval mode."""
        loader = self._make_loader(eval_data, batch_size, shuffle=False)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        step = EvalStep(self.network, self._eval_outputs)
        for i, batch in enumerate(loader):
            batch = _as_list(batch)
            loss, pred = step(*batch)
            losses.append(float(loss))
            for m in self._metrics:
                m.update(m.compute(pred, batch[-1]))
            if num_iters is not None and i + 1 >= num_iters:
                break
        res = {"loss": float(np.mean(losses))}
        for m in self._metrics:
            name, acc = m.name(), m.accumulate()
            if isinstance(name, list):
                res.update(zip(name, acc))
            else:
                res[name] = acc
        return res

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False, verbose=1,
                callbacks=None):
        """The network's output on each batch's first field, in eval mode,
        as host arrays: ``[[per batch]]``, or ``[all rows]`` with
        ``stack_outputs``."""
        loader = self._make_loader(test_data, batch_size, shuffle=False)
        self.network.eval()
        step = EvalStep(self.network, lambda *b: self.network(*b[:1]))
        outputs = [step(*_as_list(batch))[0].cpu().numpy() for batch in loader]
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    def train_batch(self, inputs, labels=None, update=True):
        """One ``TrainStep`` on the given batch; ``[loss]``."""
        loss = self._step()(*self._on_device(_as_list(inputs) + _as_list(labels)))
        return [float(loss.item())]

    def eval_batch(self, inputs, labels=None):
        """The loss on the given batch in eval mode, without gradients;
        ``[loss]``."""
        self.network.eval()
        with torch.no_grad():
            out = self.network(*self._on_device(_as_list(inputs)))
            loss = self._loss(out, *self._on_device(_as_list(labels)))
        return [float(loss.item())]

    def save(self, path, training=True):
        """The network's state to ``path.pdparams`` and, with ``training``,
        the optimizer's to ``path.pdopt``, in the reference's format."""
        _save(reference_state_dict(self.network), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The network's state from ``path.pdparams`` (written by either
        package), by key; keys on one side only are left alone."""
        set_state_dict(self.network, _load(path + ".pdparams"))

    def parameters(self, *args, **kwargs):
        """The network's parameters, a list (``Layer.parameters``, or a
        plain ``torch.nn.Module``'s)."""
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtype)
