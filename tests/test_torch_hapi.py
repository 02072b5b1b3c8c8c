"""PyTorch port: ``paddle.Model`` (``hapi``), its callbacks, ``summary``
and ``utils.LogWriter`` against the reference, on the CPU.

- LeNet from the reference's initial weights (carried by key) through
  ``Model.prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy())``: ``fit``
  for 5 steps over a ``shuffle=False`` loader of the synthetic MNIST
  (normalised as Paddle's quick start does), then ``evaluate`` and
  ``predict`` (stacked and per batch), each against the reference's;
  ``fit`` over a dataset (the model's own loader) with ``eval_data``;
  ``train_batch`` and ``eval_batch``.
- ``summary``'s totals, a frozen parameter included; every callback's
  hooks run on both sides in the same order with the same logs (the
  reference's ``fit`` calls none of them, and neither does the port's);
  ``VisualDL``'s files equal the reference's but for the time stamps.
- ``Model.save`` / ``Model.load`` across the two packages, both ways.

Tolerances: the losses of 5 Adam steps within 1e-5 relative (f32 sums in
another order, each step's update divided by the root of the second
moment), the parameters after them within 2e-6 of their largest
(each Adam update is lr 1e-3 at most), logits within 2e-5 of their
largest; the accuracies exact (the same top k of scores that agree to
2e-5).
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as rmetric
from paddle_tpu import nn as rnn
from paddle_tpu import vision as rvision
from paddle_tpu.hapi import callbacks as rcb
from paddle_tpu.io import DataLoader as RLoader
from paddle_tpu.utils import LogWriter as RLogWriter
import paddle_tpu_torch as ptorch
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import vision as pvision
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.io import DataLoader as PLoader
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.models._weights import reference_state_dict
from paddle_tpu_torch.optimizer import Adam, lr as plr
from paddle_tpu_torch.utils import LogWriter as PLogWriter

NORM = dict(mean=[127.5], std=[127.5])


def _state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _pair(seed=1):
    """(reference Model, port Model), LeNet with the same weights, prepared."""
    paddle.seed(seed)
    rnet = rvision.LeNet()
    pnet = load_reference_state_dict(pvision.LeNet(device="cpu"), _state(rnet))
    ref = paddle.Model(rnet).prepare(paddle.optimizer.Adam(1e-3, parameters=rnet.parameters()),
                                     rnn.CrossEntropyLoss(), rmetric.Accuracy(topk=(1, 2)))
    port = ptorch.Model(pnet).prepare(Adam(1e-3, parameters=pnet.parameters()),
                                      pnn.CrossEntropyLoss(), pmetric.Accuracy(topk=(1, 2)))
    return ref, port


def _mnist(side, mode="train"):
    lib = rvision if side == "ref" else pvision
    return lib.datasets.MNIST(mode=mode, transform=lib.transforms.Normalize(**NORM))


def _close(got, want, frac, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * float(np.abs(want).max()), err_msg=what)


def test_fit_evaluate_predict_equal_the_references():
    ref, port = _pair()
    rh = ref.fit(RLoader(_mnist("ref"), batch_size=64), epochs=1, num_iters=5, verbose=0)
    ph = port.fit(PLoader(_mnist("port"), batch_size=64, device="cpu"), epochs=1,
                  num_iters=5, verbose=0)
    assert len(ph["loss"]) == 5 and list(ph) == list(rh) == ["loss"]
    np.testing.assert_allclose(ph["loss"], rh["loss"], rtol=1e-5)
    assert ph["loss"][-1] < ph["loss"][0]
    rstate = _state(ref.network)
    for k, v in reference_state_dict(port.network).items():
        _close(v.detach().numpy(), rstate[k], 2e-6, k)

    test_r, test_p = _mnist("ref", "test"), _mnist("port", "test")
    rres = ref.evaluate(test_r, batch_size=100, num_iters=3, verbose=0)
    pres = port.evaluate(test_p, batch_size=100, num_iters=3, verbose=0)
    assert list(pres) == list(rres) == ["loss", "acc_top1", "acc_top2"]
    np.testing.assert_allclose(pres["loss"], rres["loss"], rtol=1e-5)
    assert (pres["acc_top1"], pres["acc_top2"]) == (rres["acc_top1"], rres["acc_top2"])

    sub_r = [test_r[i] for i in range(150)]
    sub_p = torch.utils.data.Subset(test_p, range(150))
    rout = ref.predict(RLoader(_ListDataset(sub_r), batch_size=64), stack_outputs=True)
    pout = port.predict(sub_p, batch_size=64, stack_outputs=True)
    assert len(pout) == 1 and pout[0].shape == rout[0].shape == (150, 10)
    _close(pout[0], rout[0], 2e-5)
    batches = port.predict(sub_p, batch_size=64)[0]
    assert [b.shape[0] for b in batches] == [64, 64, 22]
    np.testing.assert_array_equal(np.concatenate(batches), pout[0])


class _ListDataset(paddle.io.Dataset):
    def __init__(self, items):
        self.items = items

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def test_fit_over_a_dataset_with_eval_data():
    ref, port = _pair(2)
    train_r, train_p = _mnist("ref"), _mnist("port")
    sub_r = _ListDataset([train_r[i] for i in range(96)])
    sub_p = torch.utils.data.Subset(train_p, range(96))
    rh = ref.fit(sub_r, eval_data=sub_r, batch_size=32, epochs=2, shuffle=False, verbose=0)
    ph = port.fit(sub_p, eval_data=sub_p, batch_size=32, epochs=2, shuffle=False, verbose=0,
                  callbacks=[_Raises()], num_workers=3, drop_last=True, save_dir="/nonexistent")
    assert list(ph) == list(rh) == ["loss", "acc_top1", "acc_top2"]
    # each evaluation's loss joins the steps' losses, as in the reference
    assert len(ph["loss"]) == 6 + 2 and len(ph["acc_top1"]) == 2
    np.testing.assert_allclose(ph["loss"], rh["loss"], rtol=1e-5)
    assert ph["acc_top1"] == rh["acc_top1"] and ph["acc_top2"] == rh["acc_top2"]


def test_train_batch_and_eval_batch():
    ref, port = _pair(3)
    ds = _mnist("port")
    x = np.stack([ds[i][0] for i in range(16)])
    y = np.asarray([ds[i][1] for i in range(16)])
    for _ in range(2):
        got = port.train_batch([x], [y])
        want = ref.train_batch([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = port.eval_batch(torch.from_numpy(x), torch.from_numpy(y))
    want = ref.eval_batch(paddle.to_tensor(x), paddle.to_tensor(y))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not port.network.training and len(list(port.parameters())) == 10


def test_summary_totals(capsys):
    paddle.seed(0)
    rnet = rvision.LeNet()
    pnet = pvision.LeNet(device="cpu")
    assert ptorch.summary(pnet) == paddle.summary(rnet)
    rnet.fc[0].weight.stop_gradient = True
    rnet.fc[0].weight.trainable = False
    pnet.fc[0].weight.requires_grad_(False)
    got = ptorch.Model(pnet).summary()
    assert got == paddle.Model(rnet).summary()
    assert got["total_params"] - got["trainable_params"] == 400 * 120
    out = capsys.readouterr().out
    assert "features.0.weight" in out and "Total params: 61,610" in out


class _Raises(pcb.Callback):
    def __getattribute__(self, name):
        if name.startswith("on_"):
            raise AssertionError(f"fit called {name}")
        return super().__getattribute__(name)


class _Scheduled:
    """A model stand-in: a step scheduler on its optimizer."""

    def __init__(self, lib):
        self._optimizer = lib.SGD(learning_rate=lib.lr.StepDecay(0.5, step_size=2, gamma=0.5),
                                  parameters=[])

    def save(self, path):
        self.saved = getattr(self, "saved", []) + [path]


def _drive(cb, logs):
    """Every hook of ``cb``, in a fit's order, with ``logs`` (its numbers
    moved from step to step)."""
    def moved(fn):
        return {k: fn(v) if isinstance(v, float) else v for k, v in logs.items()}

    cb.on_train_begin(logs)
    for epoch in range(3):
        cb.on_epoch_begin(epoch, logs)
        for step in range(2):
            cb.on_train_batch_begin(step, logs)
            cb.on_train_batch_end(step, moved(lambda v: v + step))
        cb.on_eval_begin(logs)
        cb.on_eval_end(moved(lambda v: v * (1 + epoch) ** (-1 if epoch < 2 else 1)))
        cb.on_epoch_end(epoch, logs)
    cb.on_train_end(logs)


def test_callbacks_hooks_equal_the_references(capsys, tmp_path):
    import paddle_tpu.optimizer as ropt
    import paddle_tpu_torch.optimizer as popt

    logs = {"loss": 1.5, "acc": 0.25}
    for make in (lambda m: m.ProgBarLogger(log_freq=1), lambda m: m.Callback()):
        printed = []
        for m in (rcb, pcb):
            _drive(make(m), logs)
            printed.append(capsys.readouterr().out)
        assert printed[1] == printed[0]
    assert printed[0] == ""
    for m, lib in ((rcb, ropt), (pcb, popt)):
        model = _Scheduled(lib)
        for cb in (m.LRScheduler(), m.LRScheduler(by_step=False, by_epoch=True),
                   m.ModelCheckpoint(save_freq=2, save_dir=str(tmp_path))):
            cb.set_model(model)
            cb.set_params({"epochs": 3})
            _drive(cb, logs)
        if m is rcb:
            want = (model._optimizer.get_lr(), model.saved)
    assert (model._optimizer.get_lr(), model.saved) == want
    assert want[1] == [f"{tmp_path}/0", f"{tmp_path}/2"]
    assert isinstance(model._optimizer._learning_rate, plr.StepDecay)
    for kw in (dict(patience=1), dict(monitor="acc", mode="max", patience=2, min_delta=0.1)):
        got, ref = pcb.EarlyStopping(**kw), rcb.EarlyStopping(**kw)
        for cb in (got, ref):
            _drive(cb, logs)
        assert (got.best, got.wait, got.stopped) == (ref.best, ref.wait, ref.stopped)


def test_visualdl_writes_the_references_files(tmp_path):
    logs = {"loss": 1.5, "acc": 0.25, "name": "lenet"}
    for m, side in ((rcb, "ref"), (pcb, "port")):
        _drive(m.VisualDL(str(tmp_path / side)), logs)
    for name in ("train_loss.tsv", "train_acc.tsv", "eval_loss.tsv", "eval_acc.tsv"):
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "ref" / name).read_text() and got.count("\n") >= 3

    def records(side):
        (path,) = (tmp_path / side).glob("*.jsonl")
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in path.read_text().splitlines()]

    assert records("port") == records("ref") and len(records("port")) == 18
    with PLogWriter(str(tmp_path / "w"), file_name="a.jsonl") as pw, \
            RLogWriter(str(tmp_path / "r"), file_name="a.jsonl") as rw:
        for w in (pw, rw):
            w.add_histogram("h", np.arange(10.0), 1, buckets=4, walltime=5.0)
            w.add_text("t", "hello", 2, walltime=5.0)
            w.add_scalar("s/x", 3, 4, walltime=5.0)
        assert pw.scalars("s/x") == rw.scalars("s/x") == [(4, 3.0)]
    assert ((tmp_path / "w" / "a.jsonl").read_text()
            == (tmp_path / "r" / "a.jsonl").read_text())


def test_model_save_and_load_across_the_packages(tmp_path):
    ref, port = _pair(4)
    x = torch.from_numpy(np.stack([_mnist("port")[i][0] for i in range(4)]))
    port.train_batch([x], [torch.arange(4)])
    port.save(str(tmp_path / "port" / "m"))
    assert (tmp_path / "port" / "m.pdopt").exists()
    opt = ptorch.load(str(tmp_path / "port" / "m.pdopt"))
    assert opt["states"] == {} and opt["_step_count"] == 1
    ref.load(str(tmp_path / "port" / "m"))
    for k, v in reference_state_dict(port.network).items():
        np.testing.assert_array_equal(_state(ref.network)[k], v.detach().numpy())

    ref2, _ = _pair(5)
    ref2.save(str(tmp_path / "ref" / "m"))
    fresh = ptorch.Model(pvision.LeNet(device="cpu"))
    fresh.load(str(tmp_path / "ref" / "m"))
    for k, v in reference_state_dict(fresh.network).items():
        np.testing.assert_array_equal(v.detach().numpy(), _state(ref2.network)[k])
    with pytest.raises(ValueError, match="shape"):
        ptorch.Model(pvision.LeNet(num_classes=3, device="cpu")).load(str(tmp_path / "ref" / "m"))


def test_model_takes_a_plain_torch_module(tmp_path):
    """A ``torch.nn.Module`` that is not an ``nn.Layer`` is a network too:
    ``parameters`` is a list, ``save`` writes a tied weight once under its
    first name, ``load`` reads it back by key."""

    class Tied(torch.nn.Module):
        def __init__(self, seed):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            self.emb = torch.nn.Parameter(torch.randn(5, 3, generator=gen))
            self.head = torch.nn.Linear(3, 5)
            self.head.weight = self.emb

    net = Tied(0)
    model = ptorch.Model(net)
    params = model.parameters()
    assert isinstance(params, list) and len(params) == 2
    model.save(str(tmp_path / "m"), training=False)
    saved = ptorch.load(str(tmp_path / "m.pdparams"))
    assert sorted(saved) == ["emb", "head.bias"]
    back = ptorch.Model(Tied(1))
    back.load(str(tmp_path / "m"))
    assert torch.equal(back.network.head.weight, net.emb)
    assert torch.equal(back.network.head.bias, net.head.bias)
