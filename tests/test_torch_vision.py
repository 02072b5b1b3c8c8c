"""PyTorch port: the vision models and datasets against the reference, on
the CPU.

The reference builds each model, its ``state_dict()`` (the batch norms'
``_mean`` and ``_variance`` included) goes to the port through numpy
(``load_reference_state_dict``), and both run the same seeded images:

- LeNet (28 x 28), resnet18 and (slow tier; resnet18 is its tier-1
  sibling) resnet50 at 64 x 64, batch 2, f32, in training mode: logits,
  loss, every gradient, and the running statistics the forward moved;
  the state-dict keys are the reference's (no ``num_batches_tracked``).
  Not 32 x 32: there the last stage is 1 x 1, and its batch norms
  normalise each channel over the 2 images' values, so a channel whose
  two values nearly agree turns f32 rounding into an O(1) change of its
  output (resnet18's logits then differ by 1e-2 on the same weights);
  at 64 x 64 it is 8 values a channel;
- a 3-call ``TrainStep`` trajectory of resnet18 with ``Momentum``:
  losses, every parameter and every batch-norm buffer against the
  reference's ``TrainStep``; then an ``EvalStep`` forward in eval mode
  (the running statistics) against the reference's ``EvalStep``;
- ``resnext50_32x4d`` and ``wide_resnet50_2`` forwards (eval mode);
- under ``amp.auto_cast`` O1 every convolution runs in bf16 and every
  batch norm in f32 on both sides, and the logits agree to bf16 rounding;
- construction: parameter counts and tensor counts, seeded draws, the
  card by default;
- the synthetic MNIST, FashionMNIST, Cifar10 and Cifar100 equal to the
  reference's, item by item; the IDX and tar readers on small files;
- LeNet on the synthetic MNIST learns through ``TrainStep`` with Adam as
  ``tests/test_train_lenet.py``'s jitted test does (its criteria).

Tolerances: f32 sums in another order through up to 50 layers whose
batch norms renormalise every activation: logits within 2e-4 of their
largest magnitude, loss within 1e-4 relative (the cross entropy moves
by at most the largest logit error), each gradient within 1e-3
of its tensor's largest entry (the last stage's batch norms divide by
the standard deviation of 8 values, which amplifies rounding), running
statistics within 1e-5 of their largest. After 3
Momentum updates (lr 0.01): each tensor's change within 2e-3 of its
largest change (the gradients' limit, over three steps), the running
statistics (averages of activations that the updated weights computed)
within 1e-4 of their largest. ResNet-50 is
held to the reference's own noise (its test says why), its logits
within 1e-3 of their largest. O1: logits within 2^-5 of their largest
(a few bf16 ulps through the network).
"""

import gzip
import io
import pickle
import struct
import tarfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as ramp
from paddle_tpu import vision as rvision
from paddle_tpu.io import DataLoader
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import vision as pvision
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import Adam, Momentum

LOGITS_FRAC = 2e-4
LOSS_RTOL = 1e-4
GRAD_FRAC = 1e-3
BUFFER_FRAC = 1e-5
RESNET50_LOGITS_FRAC = 1e-3
UPDATE_FRAC = 2e-3
TRAJ_BUFFER_FRAC = 1e-4
O1_FRAC = 2.0 ** -5
LR = 0.01


def _frac_close(got, want, frac, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= frac * max(float(np.abs(want).max()), 1e-12), (what, err)


def _pair(name, seed=3, **kw):
    """(reference model, port model with its state) of ``name``."""
    paddle.seed(seed)
    model = getattr(rvision.models, name)(**kw)
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = getattr(pvision.models, name)(**kw, device="cpu")
    assert sorted(pmodel.state_dict()) == sorted(state)
    load_reference_state_dict(pmodel, state)
    return model, pmodel


def _images(seed, n=2, hw=64, c=3, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c, hw, hw).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int64))


def _buffers(model):
    return {k: np.asarray(v._data if hasattr(v, "_data") else v.numpy(), np.float32)
            for k, v in model.state_dict().items() if k.endswith(("_mean", "_variance"))}


def _loss_grads(model, pmodel, x, y):
    loss = RF.cross_entropy(model(paddle.to_tensor(x)), paddle.to_tensor(y))
    logits = model(paddle.to_tensor(x)).numpy()
    loss.backward()
    want = (float(loss.numpy()), {n: p.grad.numpy() for n, p in model.named_parameters()})
    out = pmodel(torch.from_numpy(x))
    ploss = PF.cross_entropy(out, torch.from_numpy(y))
    pmodel(torch.from_numpy(x))   # the reference's two forwards moved its statistics twice
    ploss.backward()
    got = (float(ploss.detach()), {n: p.grad.numpy() for n, p in pmodel.named_parameters()})
    return out.detach().numpy(), logits, got, want


def _global_rel(got, want):
    """||got - want|| / ||want|| over every tensor of a gradient dict."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((want[k] ** 2).sum()) for k in want)) ** 0.5


@pytest.mark.parametrize("name", ["LeNet", "resnet18"])
def test_logits_loss_and_every_gradient_match(name):
    kw = {} if name == "LeNet" else dict(num_classes=10)
    model, pmodel = _pair(name, **kw)
    x, y = _images(1, hw=28 if name == "LeNet" else 64, c=1 if name == "LeNet" else 3)
    got_logits, want_logits, (loss, grads), (loss_r, grads_r) = _loss_grads(model, pmodel, x, y)
    _frac_close(got_logits, want_logits, LOGITS_FRAC, "logits")
    np.testing.assert_allclose(loss, loss_r, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(grads_r)
    for n in grads_r:
        _frac_close(grads[n], grads_r[n], GRAD_FRAC, n)
    want_buf, got_buf = _buffers(model), _buffers(pmodel)
    assert sorted(got_buf) == sorted(want_buf)
    assert "num_batches_tracked" not in " ".join(pmodel.state_dict())
    for k in want_buf:
        _frac_close(got_buf[k], want_buf[k], BUFFER_FRAC, k)


@pytest.mark.slow  # ~60 s; its tier-1 sibling is test_logits_loss_and_every_gradient_match
def test_resnet50_gradients_within_the_references_own_noise():
    """ResNet-50 from random weights is ill-conditioned at this size: the
    reference's own gradients move by percents of a tensor's largest
    entry when only the batch's order changes (f32 sums in another
    order, amplified by 16 bottlenecks of batch norms over 8 to 32
    values). So the port is held to that yardstick: the relative norm of
    its difference from the reference, over every gradient, within twice
    the reference's against itself with the two images swapped; the
    logits, loss and running statistics as resnet18's."""
    model, pmodel = _pair("resnet50", num_classes=10)
    x, y = _images(1)
    got_logits, want_logits, (loss, grads), (loss_r, grads_r) = _loss_grads(model, pmodel, x, y)
    _frac_close(got_logits, want_logits, RESNET50_LOGITS_FRAC, "logits")
    np.testing.assert_allclose(loss, loss_r, rtol=LOSS_RTOL)
    model.clear_gradients()
    swapped = RF.cross_entropy(model(paddle.to_tensor(x[::-1].copy())),
                               paddle.to_tensor(y[::-1].copy()))
    swapped.backward()
    noise = _global_rel({n: p.grad.numpy() for n, p in model.named_parameters()}, grads_r)
    assert 0 < _global_rel(grads, grads_r) <= 2 * noise, (_global_rel(grads, grads_r), noise)


def test_model_sizes_and_construction():
    for name, tensors, params in (("resnet50", 161, 25557032), ("resnet18", 62, 11689512),
                                  ("LeNet", 10, 61610)):
        m = getattr(pvision.models, name)(device="cpu")
        assert len(list(m.parameters())) == tensors
        assert sum(p.numel() for p in m.parameters()) == params
    r = getattr(rvision.models, "resnet50")()
    assert sum(int(np.prod(p.shape)) for p in r.parameters()) == 25557032
    gen = torch.Generator()
    gen.manual_seed(0)
    a = pvision.resnet18(num_classes=5, device="cpu", generator=gen)
    gen.manual_seed(0)
    b = pvision.resnet18(num_classes=5, device="cpu", generator=gen)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    bf = pvision.LeNet(device="cpu", dtype=torch.bfloat16)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
    headless = pvision.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert headless(torch.randn(1, 3, 32, 32)).shape == (1, 512, 1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pvision.LeNet()


def _ref_steps(model, batches):
    opt = paddle.optimizer.Momentum(LR, parameters=model.parameters(), momentum=0.9)
    step = paddle.jit.TrainStep(model, opt, lambda x, y: RF.cross_entropy(model(x), y))
    losses = [float(step(*map(paddle.to_tensor, b)).numpy()) for b in batches]
    return losses, {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _port_steps(pmodel, batches):
    opt = Momentum(LR, parameters=pmodel.parameters(), momentum=0.9)
    step = TrainStep(pmodel, opt, lambda x, y: PF.cross_entropy(pmodel(x), y))
    losses = [float(step(*map(torch.from_numpy, b))) for b in batches]
    return losses, {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}


def test_train_step_trajectory_with_momentum_then_eval():
    model, pmodel = _pair("resnet18", seed=5, num_classes=10)
    model.train()
    pmodel.train()
    batches = [_images(10 + i) for i in range(3)]
    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    losses_r, params_r = _ref_steps(model, batches)
    losses, params = _port_steps(pmodel, batches)
    np.testing.assert_allclose(losses, losses_r, rtol=LOSS_RTOL)
    assert sorted(params) == sorted(params_r)
    for n in params_r:
        assert np.abs(params[n] - start[n]).max() > 1e-6, n
        _frac_close(params[n] - start[n], params_r[n] - start[n], UPDATE_FRAC, n)
    want_buf, got_buf = _buffers(model), _buffers(pmodel)
    for k in want_buf:
        _frac_close(got_buf[k], want_buf[k], TRAJ_BUFFER_FRAC, k)
    # eval: the running statistics normalise, no gradient, both compiled
    model.eval()
    pmodel.eval()
    x, _ = _images(20)
    want = paddle.jit.EvalStep(model, lambda a: model(a))(paddle.to_tensor(x))[0].numpy()
    got = EvalStep(pmodel, lambda a: pmodel(a))(torch.from_numpy(x))
    assert len(got) == 1 and not got[0].requires_grad
    _frac_close(got[0].numpy(), want, LOGITS_FRAC, "eval logits")
    for k, v in _buffers(pmodel).items():
        np.testing.assert_array_equal(v, got_buf[k])


# resnext50_32x4d takes ~18 s (the reference's 32-group convolutions); its
# tier-1 sibling is the wide variant of the same class
@pytest.mark.parametrize("name", [pytest.param("resnext50_32x4d", marks=pytest.mark.slow),
                                  "wide_resnet50_2"])
def test_variant_forwards_match(name):
    model, pmodel = _pair(name, seed=6, num_classes=10)
    model.eval()
    pmodel.eval()
    x, _ = _images(7)
    want = model(paddle.to_tensor(x)).numpy()
    got = pmodel(torch.from_numpy(x)).detach().numpy()
    _frac_close(got, want, LOGITS_FRAC, name)
    groups = {m._groups for m in pmodel.modules() if isinstance(m, pnn.Conv2D)}
    assert groups == ({1, 32} if name.startswith("resnext") else {1})


def test_o1_runs_conv_in_bf16_and_batch_norm_in_f32():
    model, pmodel = _pair("resnet18", seed=8, num_classes=10)
    x, _ = _images(9)
    seen = {}

    def record(mod, args, out):
        seen.setdefault(type(mod).__name__, set()).add(out.dtype)

    for m in pmodel.modules():
        if isinstance(m, (pnn.Conv2D, pnn.BatchNorm2D)):
            m.register_forward_hook(record)
    with ramp.auto_cast(level="O1", dtype="bfloat16"):
        want = model(paddle.to_tensor(x)).numpy()
    with pamp.auto_cast(level="O1", dtype="bfloat16"):
        got = pmodel(torch.from_numpy(x))
    assert seen == {"Conv2D": {torch.bfloat16}, "BatchNorm2D": {torch.float32}}
    assert {p.dtype for p in pmodel.parameters()} == {torch.float32}
    _frac_close(got.detach().float().numpy(), np.asarray(want, np.float32), O1_FRAC)


@pytest.mark.parametrize("cls,mode", [("MNIST", "train"), ("MNIST", "test"),
                                      ("FashionMNIST", "train"), ("Cifar10", "train"),
                                      ("Cifar10", "test"), ("Cifar100", "train")])
def test_synthetic_datasets_equal_the_references(cls, mode):
    ref = getattr(rvision.datasets, cls)(mode=mode)
    ds = getattr(pvision.datasets, cls)(mode=mode)
    assert isinstance(ds, torch.utils.data.Dataset) and len(ds) == len(ref)
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.labels, ref.labels)
    for i in (0, 7, len(ds) - 1):
        (img, label), (rimg, rlabel) = ds[i], ref[i]
        assert img.dtype == np.float32 and label.dtype == np.int64
        np.testing.assert_array_equal(img, rimg)
        np.testing.assert_array_equal(label, rlabel)


def test_local_file_readers(tmp_path):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    img_path, lbl_path = tmp_path / "img.gz", tmp_path / "lbl"
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    lbl_path.write_bytes(struct.pack(">II", 2049, 5) + labels.tobytes())
    ds = pvision.datasets.MNIST(str(img_path), str(lbl_path))
    ref = rvision.datasets.MNIST(str(img_path), str(lbl_path))
    np.testing.assert_array_equal(ds.images, images)
    np.testing.assert_array_equal(ds.labels, ref.labels)
    np.testing.assert_array_equal(ds[3][0], ref[3][0])
    tar_path = tmp_path / "cifar.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        for name, n in (("cifar-10-batches-py/data_batch_1", 3),
                        ("cifar-10-batches-py/test_batch", 2)):
            raw = pickle.dumps({b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                                b"labels": list(rng.randint(0, 10, n))})
            info = tarfile.TarInfo(name)
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    for mode in ("train", "test"):
        ds = pvision.datasets.Cifar10(str(tar_path), mode=mode)
        ref = rvision.datasets.Cifar10(str(tar_path), mode=mode)
        np.testing.assert_array_equal(ds.images, ref.images)
        np.testing.assert_array_equal(ds.labels, ref.labels)
        np.testing.assert_array_equal(ds[1][0], ref[1][0])
    with pytest.raises(ValueError):
        pvision.datasets.Cifar100(str(tar_path))


def test_lenet_learns_the_synthetic_mnist():
    """``tests/test_train_lenet.py``'s jitted test on the port: Adam 3e-3,
    batch 64, 50 ``TrainStep`` calls; the last loss below 0.8 of the
    first, accuracy on 256 training images above 0.5."""
    ds = pvision.datasets.MNIST(mode="train")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = pvision.LeNet(device="cpu", generator=gen)
    step = TrainStep(model, Adam(3e-3, parameters=model.parameters()),
                     lambda x, y: PF.cross_entropy(model(x), y))
    loader = pio.DataLoader(ds, batch_size=64, shuffle=True, generator=gen, device="cpu")
    batches = iter(loader)
    losses = [float(step(*next(batches))) for _ in range(50)]
    assert losses[-1] < 0.8 * losses[0], losses
    xs = torch.from_numpy(np.stack([ds[i][0] for i in range(256)]))
    ys = np.asarray([ds[i][1] for i in range(256)])
    acc = float((model(xs).argmax(1).numpy() == ys).mean())
    assert acc > 0.5, acc
    # the reference's loader yields the same batch shapes
    x_ref, _ = next(iter(DataLoader(rvision.datasets.MNIST(mode="train"), batch_size=64)))
    assert list(x_ref.shape) == [64, 1, 28, 28]
