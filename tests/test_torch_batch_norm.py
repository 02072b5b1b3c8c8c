"""PyTorch port: batch norm against the reference, on the CPU.

- training mode in f32: the output and the gradients of x, weight and
  bias against ``jax.vjp`` of the reference's ``batch_norm``, at 2-D
  ``[N, C]``, 3-D ``NCL`` and ``NLC``, 4-D ``NCHW`` and ``NHWC`` and 5-D
  inputs, with and without weight and bias;
- in bf16 the forward bit for bit against the reference's jitted form
  (statistics in f32, normalised in f32, rounded, then the affine in
  bf16), with ``torch.nn.functional.batch_norm`` as the control (it
  rounds once, after the affine);
- the running statistics after 3 calls against the reference's jitted
  update: bf16 buffers (``model.bfloat16()``) bit for bit, with the
  reference's eager update as the control (it rounds ``momentum *
  running`` to bf16 before the sum, which the compiled program does not);
  f32 buffers within 1e-6 relative, Paddle's momentum convention and
  the biased batch variance, with torch's ``F.batch_norm`` (unbiased) as
  the control;
- eval mode from f32 and bf16 buffers bit for bit against the
  reference's jitted form (``running_var + epsilon`` rounded to bf16, its
  rsqrt kept in f32); ``use_global_stats`` in training normalises by the
  running statistics and leaves them alone;
- the layers: ``_mean``/``_variance`` buffers (zeros and ones, f32) and
  no ``num_batches_tracked``, ``BatchNorm1D/2D/3D`` and ``BatchNorm``
  against the reference's layers with their state by key, the buffers
  updated in place (the same tensors), ``SyncBatchNorm`` at world size 1
  and ``convert_sync_batchnorm``;
- under ``amp.auto_cast`` O1 batch norm runs in f32 (a black-list op) on
  both sides, its output f32 from a bf16 input.

Tolerances: f32 reductions over at most 250 elements in another order,
within 1e-5 of the largest magnitude; the gradients (sums over the batch
of products) within 2e-5 of it; f32 running statistics (mean and
variance of 200 elements, summed in another order) within 1e-6
relative. Bit for bit in bf16 holds where the f32 statistics agree to an
ulp and no value lies that close to a bf16 rounding boundary (about one
element in 65,000 for a 1-ulp difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as ramp
from paddle_tpu import nn as rnn
from paddle_tpu.nn import functional as RF
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.nn import functional as PF

OUT_FRAC = 1e-5
GRAD_FRAC = 2e-5
RUNNING_RTOL = 1e-6


def _close(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-6))


def _inputs(shape, channels, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (rng.rand(channels) + 0.5).astype(np.float32)
    b = rng.randn(channels).astype(np.float32)
    m = (rng.randn(channels) * 0.3).astype(np.float32)
    v = (rng.rand(channels) + 0.5).astype(np.float32)
    return x, w, b, m, v


CASES = [("nc", (16, 6), 6, "NCHW"), ("ncl", (4, 6, 7), 6, "NCL"), ("nlc", (4, 7, 6), 6, "NLC"),
         ("nchw", (4, 6, 5, 3), 6, "NCHW"), ("nhwc", (4, 5, 3, 6), 6, "NHWC"),
         ("ncdhw", (2, 6, 3, 4, 2), 6, "NCDHW"), ("ndhwc", (2, 3, 4, 2, 6), 6, "NDHWC")]


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("name,shape,c,fmt", CASES, ids=[c[0] for c in CASES])
def test_training_forward_and_gradients_match_reference(name, shape, c, fmt, affine):
    x, w, b, m, v = _inputs(shape, c, len(name))
    cot = np.random.RandomState(1).randn(*shape).astype(np.float32)
    diff = (x, w, b) if affine else (x,)

    def ref(*a):
        return RF.batch_norm(Tensor(a[0]), Tensor(jnp.asarray(m)), Tensor(jnp.asarray(v)),
                             *(map(Tensor, a[1:]) if affine else ()), training=True,
                             data_format=fmt)._data

    want, vjp = jax.vjp(ref, *map(jnp.asarray, diff))
    want_g = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in diff]
    rm, rv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    got = PF.batch_norm(ts[0], rm, rv, *ts[1:], training=True, data_format=fmt)
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), want, OUT_FRAC)
    for t, g in zip(ts, want_g):
        _close(t.grad.numpy(), g, GRAD_FRAC)
    # the running statistics moved by the batch's (the reference's eager call)
    mt, vt = Tensor(jnp.asarray(m)), Tensor(jnp.asarray(v))
    RF.batch_norm(Tensor(jnp.asarray(x)), mt, vt, training=True, data_format=fmt)
    _close(rm.numpy(), np.asarray(mt._data), OUT_FRAC)
    _close(rv.numpy(), np.asarray(vt._data), OUT_FRAC)


def _bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


@pytest.mark.parametrize("fmt,shape", [("NCHW", (8, 16, 6, 6)), ("NHWC", (8, 6, 6, 16)),
                                       ("NCHW", (64, 16))])
def test_bf16_forward_is_the_references_jitted_rounding(fmt, shape):
    x, w, b, m, v = _inputs(shape, 16, 3)
    x, w, b = _bf16(x, w, b)

    def ref(xa, wa, ba):
        return RF.batch_norm(Tensor(xa), Tensor(jnp.asarray(m)), Tensor(jnp.asarray(v)),
                             Tensor(wa), Tensor(ba), training=True, data_format=fmt)._data

    want = np.asarray(jax.jit(ref)(*map(_jnp, (x, w, b))).astype(jnp.float32))
    got = PF.batch_norm(x, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()), w, b,
                        training=True, data_format=fmt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # control: torch's batch norm applies the affine before it rounds
    xc = x.movedim(-1, 1) if fmt == "NHWC" else x
    once = torch.nn.functional.batch_norm(xc.float(), None, None, w.float(), b.float(),
                                          training=True).bfloat16()
    once = (once.movedim(1, -1) if fmt == "NHWC" else once).float().numpy()
    assert np.mean(once != want) > 0.05


@pytest.mark.parametrize("buffers", ["float32", "bfloat16"])
def test_running_statistics_after_three_calls(buffers):
    """The reference's compiled update, 3 calls, with f32 buffers or bf16
    ones (after ``model.bfloat16()``; x then bf16 too): bf16 buffers bit
    for bit; f32 ones within RUNNING_RTOL (the batch mean and variance are
    f32 sums in another order)."""
    rng = np.random.RandomState(4)
    c = 64
    xs = [(rng.randn(8, c, 5, 5) * (1 + i) + i).astype(np.float32) for i in range(3)]
    low = buffers == "bfloat16"
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if low else (torch.float32, jnp.float32)
    rm, rv = torch.zeros(c, dtype=tdt), torch.ones(c, dtype=tdt)
    mean_id, var_id = id(rm), id(rv)
    mt, vt = jnp.zeros(c, jdt), jnp.ones(c, jdt)

    @jax.jit
    def ref_call(xa, ma, va):
        mm, vv = Tensor(ma), Tensor(va)
        RF.batch_norm(Tensor(xa), mm, vv, training=True, momentum=0.9)
        return mm._data, vv._data

    # the eager reference rounds momentum * running to the buffer's dtype
    # first: another result in bf16, the control
    em, ev = Tensor(jnp.zeros(c, jdt)), Tensor(jnp.ones(c, jdt))
    for x in xs:
        PF.batch_norm(torch.from_numpy(x).to(tdt), rm, rv, training=True, momentum=0.9)
        mt, vt = ref_call(jnp.asarray(x, jdt), mt, vt)
        RF.batch_norm(Tensor(jnp.asarray(x, jdt)), em, ev, training=True, momentum=0.9)
    assert id(rm) == mean_id and id(rv) == var_id and rm.dtype == tdt
    got = [t.float().numpy() for t in (rm, rv)]
    want = [np.asarray(t.astype(jnp.float32)) for t in (mt, vt)]
    eager = [np.asarray(t._data.astype(jnp.float32)) for t in (em, ev)]
    assert float(got[1].min()) > 1.5  # it moved towards the batches' variance
    if low:
        assert sum(int((g != e).sum()) for g, e in zip(got, eager)) > 0
    for g, w, e in zip(got, want, eager):
        if low:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RUNNING_RTOL, atol=0)
            np.testing.assert_allclose(g, e, rtol=RUNNING_RTOL, atol=0)
    if not low:
        # control: torch's update folds the unbiased variance
        cm, cv = torch.zeros(c), torch.ones(c)
        for x in xs:
            torch.nn.functional.batch_norm(torch.from_numpy(x), cm, cv, training=True,
                                           momentum=0.1)
        assert np.abs(cv.numpy() / want[1] - 1).max() > 1e-3


@pytest.mark.parametrize("buffers", ["float32", "bfloat16"])
def test_eval_is_the_references_jitted_rounding(buffers):
    x, w, b, m, v = _inputs((8, 16, 4, 4), 16, 6)
    low = buffers == "bfloat16"
    x, w, b = _bf16(x, w, b)
    m, v = torch.from_numpy(m), torch.from_numpy(v * 1e-4)  # small: epsilon's rounding shows
    if low:
        m, v = m.bfloat16(), v.bfloat16()

    def ref(xa, wa, ba, ma, va):
        return RF.batch_norm(Tensor(xa), Tensor(ma), Tensor(va), Tensor(wa), Tensor(ba),
                             training=False)._data

    want = np.asarray(jax.jit(ref)(*map(_jnp, (x, w, b, m, v))).astype(jnp.float32))
    got = PF.batch_norm(x, m, v, w, b, training=False)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_use_global_stats_normalises_by_the_running_statistics():
    x, w, b, m, v = _inputs((4, 6, 5, 5), 6, 8)
    rm, rv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    got = PF.batch_norm(torch.from_numpy(x), rm, rv, torch.from_numpy(w), torch.from_numpy(b),
                        training=True, use_global_stats=True)
    want = RF.batch_norm(*(Tensor(jnp.asarray(a)) for a in (x, m, v, w, b)), training=True,
                         use_global_stats=True)
    _close(got.numpy(), np.asarray(want._data), OUT_FRAC)
    assert torch.equal(rm, torch.from_numpy(m)) and torch.equal(rv, torch.from_numpy(v))


LAYERS = [("BatchNorm", (6,), {}, (4, 6, 5, 5)), ("BatchNorm1D", (6,), {}, (8, 6)),
          ("BatchNorm1D", (6,), dict(data_format="NLC"), (4, 7, 6)),
          ("BatchNorm2D", (6,), dict(momentum=0.8, epsilon=1e-3), (4, 6, 5, 5)),
          ("BatchNorm2D", (6,), dict(data_format="NHWC"), (4, 5, 5, 6)),
          ("BatchNorm3D", (6,), {}, (2, 6, 3, 4, 2))]


@pytest.mark.parametrize("cls,args,kw,shape", LAYERS,
                         ids=[f"{c[0]}_{i}" for i, c in enumerate(LAYERS)])
def test_layers_match_reference(cls, args, kw, shape):
    ref = getattr(rnn, cls)(*args, **kw)
    layer = getattr(pnn, cls)(*args, **kw, device="cpu")
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert sorted(layer.state_dict()) == sorted(state) == ["_mean", "_variance", "bias",
                                                           "weight"]
    assert torch.equal(layer._mean, torch.zeros(6)) and torch.equal(layer._variance,
                                                                    torch.ones(6))
    assert torch.equal(layer.weight.detach(), torch.ones(6))
    assert torch.equal(layer.bias.detach(), torch.zeros(6))
    state["weight"] = np.linspace(0.5, 2, 6).astype(np.float32)
    ref.weight._data = jnp.asarray(state["weight"])
    load_reference_state_dict(layer, state)
    buffers = (layer._mean, layer._variance)
    rng = np.random.RandomState(9)
    for _ in range(2):
        x = rng.randn(*shape).astype(np.float32)
        _close(layer(torch.from_numpy(x)).detach().numpy(), ref(paddle.to_tensor(x)).numpy(),
               OUT_FRAC)
    assert (layer._mean, layer._variance) == buffers
    for key in ("_mean", "_variance"):
        _close(getattr(layer, key).numpy(), np.asarray(ref.state_dict()[key]._data), OUT_FRAC)
    layer.eval()
    ref.eval()
    x = rng.randn(*shape).astype(np.float32)
    _close(layer(torch.from_numpy(x)).detach().numpy(), ref(paddle.to_tensor(x)).numpy(),
           OUT_FRAC)


def test_attrs_and_dtypes():
    bn = pnn.BatchNorm2D(4, weight_attr=False, bias_attr=False, device="cpu",
                         dtype=torch.bfloat16)
    assert bn.weight is None and bn.bias is None
    assert sorted(bn.state_dict()) == ["_mean", "_variance"]
    assert bn._mean.dtype == torch.float32
    out = bn(torch.randn(2, 4, 3, 3).bfloat16())
    assert out.dtype == torch.bfloat16
    held = pnn.BatchNorm2D(4, bias_attr=pnn.ParamAttr(
        initializer=pnn.initializer.Constant(0.5), learning_rate=0.1), device="cpu")
    assert torch.equal(held.bias, torch.full((4,), 0.5))
    assert held.bias.optimize_attr == {"learning_rate": 0.1}
    with pytest.raises(TypeError):
        pnn.BatchNorm2D(4, weight_attr=object(), device="cpu")
    bn = pnn.BatchNorm2D(4, device="cpu").bfloat16()
    assert bn._mean.dtype == torch.bfloat16 and "num_batches_tracked" not in bn.state_dict()


def test_sync_batch_norm_at_world_one():
    x = np.random.RandomState(10).randn(4, 6, 3, 3).astype(np.float32)
    model = pnn.Sequential(pnn.Conv2D(3, 6, 1, device="cpu"), pnn.BatchNorm2D(6, momentum=0.8,
                                                                               device="cpu"),
                           pnn.Sequential(pnn.BatchNorm1D(6, device="cpu")))
    bn = model[1]
    weight, mean = bn.weight, bn._mean
    converted = pnn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert converted is model
    assert type(model[1]) is pnn.SyncBatchNorm and type(model[2][0]) is pnn.SyncBatchNorm
    assert model[1].weight is weight and model[1]._mean is mean
    assert model[1]._momentum == 0.8
    plain = pnn.BatchNorm2D(6, device="cpu")
    sync = pnn.SyncBatchNorm(6, device="cpu")
    xt = torch.from_numpy(x)
    assert torch.equal(sync(xt), plain(xt))
    assert torch.equal(sync._mean, plain._mean) and torch.equal(sync._variance, plain._variance)
    ref = rnn.SyncBatchNorm(6)
    _close(sync(xt).detach().numpy(), ref(paddle.to_tensor(x)).numpy(), OUT_FRAC)
    single = pnn.SyncBatchNorm.convert_sync_batchnorm(pnn.BatchNorm2D(6, device="cpu"))
    assert type(single) is pnn.SyncBatchNorm


def test_o1_runs_batch_norm_in_f32_on_both_sides():
    x, w, b, m, v = _inputs((4, 6, 5, 5), 6, 12)
    xb = x.astype(np.float32)
    with ramp.auto_cast(level="O1", dtype="bfloat16"):
        xr = paddle.to_tensor(xb).astype("bfloat16")
        want = RF.batch_norm(xr, paddle.to_tensor(m), paddle.to_tensor(v), paddle.to_tensor(w),
                             paddle.to_tensor(b), training=True)
    with pamp.auto_cast(level="O1", dtype="bfloat16"):
        xp = torch.from_numpy(xb).bfloat16()
        got = PF.batch_norm(xp, torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                            torch.from_numpy(w), torch.from_numpy(b), training=True)
    assert got.dtype == torch.float32 and str(want.dtype).endswith("float32")
    _close(got.numpy(), want.numpy(), OUT_FRAC)
