"""PyTorch port: the convolutions against the reference, on the CPU.

- ``conv1d``/``conv2d``/``conv3d`` forward and both gradients (input and
  weight; the bias's too where there is one) against ``jax.vjp`` of the
  reference's functional, at every padding form (ints, per-dim pairs,
  flattened ``[before, after]`` lists, ``"SAME"`` at stride 1 and 2 on
  odd and even sizes, ``"VALID"``), dilation, groups, depthwise and
  channel-last layouts;
- the transposes likewise, with ``output_padding`` below and past the
  stride, negative effective pads, groups, dilation and channel-last
  layouts; a string padding refused on both sides;
- in bf16, a conv with a bias bit for bit against the reference's
  jitted form (the product rounded to bf16, then the bias added), with
  torch's own ``conv2d(..., bias)`` as the control (it adds the bias
  before its one rounding);
- the layers: parameter names, shapes and dtypes, the initial draw's
  bound ``1/sqrt(fan_in)`` (Kaiming-uniform with ``negative_slope =
  sqrt(5)``), ``bias_attr=False``, a ``ParamAttr`` honoured, seeded draws
  equal, forward against the reference layer with its weights by key;
- ``amp.auto_cast`` O1 runs conv in bf16 (a white-list op) on both
  sides; ``full_f32`` leaves cuDNN's TF32 setting as it found it.

Tolerances: f32 sums of products in another order, within 2e-5 of the
largest magnitude of each compared array (a few f32 ulps of a sum of up
to ~500 products). Under O1 both sides round to bf16 at the same op:
within 2^-7 of the largest magnitude (one bf16 ulp there).
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
from paddle_tpu_torch.nn.functional import conv as pconv

F32_FRAC = 2e-5
O1_FRAC = 2.0 ** -7


def _close(got, want, frac=F32_FRAC):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-6))


def _ref_vjp(fn, arrays, cot):
    """The reference functional's output and gradients (``jax.vjp``)."""
    out, vjp = jax.vjp(lambda *a: fn(*map(Tensor, a))._data, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_vjp(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(rfn, pfn, arrays, seed):
    want, want_g = _ref_vjp(rfn, arrays, _cot(rfn, arrays, seed))
    got, got_g = _port_vjp(pfn, arrays, _cot(rfn, arrays, seed))
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)
    return got


def _cot(rfn, arrays, seed):
    shape = rfn(*map(lambda a: Tensor(jnp.asarray(a)), arrays))._data.shape
    return np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)


def _inputs(seed, x_shape, w_shape, bias=True):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*x_shape).astype(np.float32), rng.randn(*w_shape).astype(np.float32)]
    if bias:
        arrays.append(rng.randn(w_shape[0]).astype(np.float32))
    return arrays


# (name, spatial, x shape, w shape, kwargs): x channel-first unless the
# data format says otherwise
CONV_CASES = [
    ("int_pad", 2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=1)),
    ("pair_pad", 2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 2])),
    ("flat_before_after", 2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 0, 2, 1])),
    ("nested_pairs_stride2", 2, (2, 4, 9, 8), (6, 4, 3, 2),
     dict(padding=[[0, 2], [1, 0]], stride=2)),
    ("same_stride1", 2, (2, 4, 9, 8), (6, 4, 4, 3), dict(padding="SAME")),
    ("same_stride2_odd", 2, (2, 4, 9, 11), (6, 4, 3, 3), dict(padding="same", stride=2)),
    ("same_stride2_even", 2, (2, 4, 10, 8), (6, 4, 3, 3), dict(padding="SAME", stride=2)),
    ("same_stride2_dilated", 2, (2, 4, 10, 9), (6, 4, 3, 3),
     dict(padding="SAME", stride=2, dilation=2)),
    ("valid_stride3", 2, (2, 4, 10, 9), (6, 4, 3, 3), dict(padding="VALID", stride=3)),
    ("dilation", 2, (2, 4, 11, 10), (6, 4, 3, 3), dict(padding=2, dilation=2)),
    ("groups", 2, (2, 4, 9, 8), (6, 2, 3, 3), dict(padding=1, groups=2)),
    ("depthwise", 2, (2, 6, 9, 8), (6, 1, 3, 3), dict(padding=1, groups=6, stride=2)),
    ("stem_7x7_s2", 2, (2, 3, 16, 16), (8, 3, 7, 7), dict(padding=3, stride=2)),
    ("nhwc", 2, (2, 9, 8, 4), (6, 4, 3, 3), dict(padding=1, stride=2, data_format="NHWC")),
    ("nhwc_same", 2, (2, 9, 8, 4), (6, 4, 3, 3), dict(padding="SAME", data_format="NHWC")),
    ("conv1d", 1, (2, 4, 13), (6, 4, 3), dict(padding=[1, 2], stride=2)),
    ("conv1d_nlc", 1, (2, 13, 4), (6, 4, 3), dict(padding="SAME", data_format="NLC")),
    ("conv3d", 3, (2, 3, 5, 6, 5), (4, 3, 3, 2, 3), dict(padding=1, stride=[1, 2, 1])),
    ("conv3d_ndhwc", 3, (2, 5, 6, 5, 3), (4, 3, 3, 3, 3),
     dict(padding="SAME", data_format="NDHWC")),
]
FUNCS = {1: ("conv1d", "conv1d_transpose"), 2: ("conv2d", "conv2d_transpose"),
         3: ("conv3d", "conv3d_transpose")}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("name,spatial,xs,ws,kw", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_matches_reference(name, spatial, xs, ws, kw, bias):
    fn = FUNCS[spatial][0]
    arrays = _inputs(len(name), xs, ws, bias)
    got = _hold(lambda *a: getattr(RF, fn)(*a, **kw), lambda *a: getattr(PF, fn)(*a, **kw),
                arrays, len(name))
    assert got.ndim == len(xs)


# transposes: the weight is [in, out/groups, *k]
TRANSPOSE_CASES = [
    ("plain", 2, (2, 4, 5, 6), (4, 3, 3, 3), dict()),
    ("stride2_pad1_outpad1", 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_padding=1)),
    ("outpad_past_stride", 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_padding=3)),
    ("pad_past_kernel", 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=3)),
    ("per_dim", 2, (2, 4, 5, 6), (4, 3, 3, 2),
     dict(stride=[2, 3], padding=[1, 0], output_padding=[1, 2])),
    ("groups", 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1, groups=2)),
    ("dilation", 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1, dilation=2)),
    ("nhwc", 2, (2, 5, 6, 4), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_padding=1, data_format="NHWC")),
    ("conv1d", 1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
    ("conv1d_nlc", 1, (2, 7, 4), (4, 3, 3), dict(stride=2, data_format="NLC")),
    ("conv3d", 3, (2, 4, 3, 4, 3), (4, 2, 3, 3, 2), dict(stride=2, padding=1, groups=2)),
]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("name,spatial,xs,ws,kw", TRANSPOSE_CASES,
                         ids=[c[0] for c in TRANSPOSE_CASES])
def test_conv_transpose_matches_reference(name, spatial, xs, ws, kw, bias):
    fn = FUNCS[spatial][1]
    groups = kw.get("groups", 1)
    arrays = _inputs(len(name) + 50, xs, ws, bias=False)
    if bias:
        arrays.append(np.random.RandomState(7).randn(ws[1] * groups).astype(np.float32))

    def call(mod):
        def run(x, w, *b):
            return getattr(mod, fn)(x, w, b[0] if b else None, **kw)
        return run

    _hold(call(RF), call(PF), arrays, len(name))


@pytest.mark.parametrize("padding", ["SAME", "valid"])
def test_transpose_refuses_string_padding(padding):
    x, w = _inputs(3, (1, 4, 5, 6), (4, 2, 3, 3), bias=False)
    with pytest.raises(ValueError):
        RF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w), stride=2, padding=padding)
    with pytest.raises(ValueError):
        PF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), stride=2, padding=padding)


def test_transpose_keyword_order():
    """conv1d_transpose takes (..., output_padding, groups, dilation, ...) as the reference."""
    x, w = _inputs(3, (1, 4, 5), (4, 2, 3), bias=False)
    got = PF.conv1d_transpose(torch.from_numpy(x), torch.from_numpy(w), None, 2, 1, 1, 2, 1)
    want = RF.conv1d_transpose(paddle.to_tensor(x), paddle.to_tensor(w), None, 2, 1, 1, 2,
                               1).numpy()
    _close(got.numpy(), want)


@pytest.mark.parametrize("case", ["nchw", "nhwc"])
def test_conv_bias_bf16_is_the_references_jitted_rounding(case):
    rng = np.random.RandomState(11)
    nhwc = case == "nhwc"
    x = rng.randn(4, 12, 12, 16) if nhwc else rng.randn(4, 16, 12, 12)
    w, b = rng.randn(32, 16, 3, 3) * 0.2, rng.randn(32) * 3
    x, w, b = (torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (x, w, b))
    fmt = "NHWC" if nhwc else "NCHW"

    def ref(xa, wa, ba):
        return RF.conv2d(Tensor(xa), Tensor(wa), Tensor(ba), 1, 1, data_format=fmt)._data

    want = np.asarray(jax.jit(ref)(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                     for a in (x, w, b))).astype(jnp.float32))
    got = PF.conv2d(x, w, b, 1, 1, data_format=fmt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # control: torch's conv adds the bias before it rounds
    xc = x.permute(0, 3, 1, 2) if nhwc else x
    once = torch.nn.functional.conv2d(xc.float(), w.float(), b.float(), 1, 1).bfloat16()
    once = (once.permute(0, 2, 3, 1) if nhwc else once).float().numpy()
    assert np.mean(once != want) > 0.05


def test_conv_weight_takes_the_input_dtype():
    x, w = _inputs(5, (1, 2, 6, 6), (3, 2, 3, 3), bias=False)
    out = PF.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), padding=1)
    assert out.dtype == torch.bfloat16
    want = PF.conv2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), padding=1)
    assert torch.equal(out, want)


LAYERS = [("Conv1D", (4, 6, 3), dict(padding=1), (2, 4, 9)),
          ("Conv2D", (4, 6, 3), dict(stride=2, padding=1, groups=2), (2, 4, 9, 8)),
          ("Conv3D", (3, 4, (3, 2, 3)), dict(padding=1), (1, 3, 5, 4, 5)),
          ("Conv1DTranspose", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9)),
          ("Conv2DTranspose", (4, 6, 3), dict(stride=2, groups=2), (2, 4, 5, 6)),
          ("Conv3DTranspose", (3, 4, 2), dict(stride=2), (1, 3, 3, 4, 3))]


@pytest.mark.parametrize("cls,args,kw,xs", LAYERS, ids=[c[0] for c in LAYERS])
def test_conv_layer_matches_reference(cls, args, kw, xs):
    paddle.seed(4)
    ref = getattr(rnn, cls)(*args, **kw)
    layer = getattr(pnn, cls)(*args, **kw, device="cpu")
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    assert sorted(state) == sorted(dict(layer.state_dict())) == ["bias", "weight"]
    for k, v in layer.state_dict().items():
        assert tuple(v.shape) == state[k].shape and v.dtype == torch.float32
    load_reference_state_dict(layer, state)
    x = np.random.RandomState(5).randn(*xs).astype(np.float32)
    _close(layer(torch.from_numpy(x)).detach().numpy(),
           ref(paddle.to_tensor(x)).numpy())


def test_conv_layer_initial_draw():
    gen = torch.Generator()
    gen.manual_seed(0)
    layer = pnn.Conv2D(64, 128, 3, device="cpu", generator=gen)
    bound = 1.0 / np.sqrt(64 * 9)
    for p in (layer.weight.detach(), layer.bias.detach()):
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.9 * bound
    # the variance of U(-b, b) is b^2 / 3
    assert abs(float(layer.weight.detach().var()) / (bound ** 2 / 3) - 1) < 0.05
    gen.manual_seed(0)
    again = pnn.Conv2D(64, 128, 3, device="cpu", generator=gen)
    assert torch.equal(again.weight, layer.weight) and torch.equal(again.bias, layer.bias)
    grouped = pnn.Conv2DTranspose(8, 12, 3, groups=4, bias_attr=False, device="cpu",
                                  dtype=torch.bfloat16)
    assert grouped.bias is None and grouped.weight.shape == (8, 3, 3, 3)
    assert grouped.weight.dtype == torch.bfloat16
    assert float(grouped.weight.detach().abs().max()) <= 1.0 / np.sqrt(2 * 9)
    for attr in ("weight_attr", "bias_attr"):
        with pytest.raises(TypeError):
            pnn.Conv2D(2, 2, 3, **{attr: object()}, device="cpu")
    dirac = pnn.Conv2D(2, 2, 3, padding=1, weight_attr=pnn.initializer.Dirac(),
                       bias_attr=pnn.ParamAttr(name="b", initializer=pnn.initializer.Constant(0.0)),
                       device="cpu")
    assert dirac.bias.paddle_name == "b"
    x = torch.randn(1, 2, 5, 5)
    assert torch.equal(dirac(x), x)
    with pytest.raises(NotImplementedError):
        pnn.Conv2D(2, 2, 3, padding_mode="reflect", device="cpu")


def test_o1_runs_conv_in_bf16_on_both_sides():
    x, w, b = _inputs(9, (2, 4, 8, 8), (6, 4, 3, 3))
    with ramp.auto_cast(level="O1", dtype="bfloat16"):
        want = RF.conv2d(*map(paddle.to_tensor, (x, w, b)), padding=1)
    with pamp.auto_cast(level="O1", dtype="bfloat16"):
        got = PF.conv2d(*map(torch.from_numpy, (x, w, b)), padding=1)
    assert got.dtype == torch.bfloat16 and str(want.dtype).endswith("bfloat16")
    _close(got.float().numpy(), np.asarray(want.numpy(), np.float32), O1_FRAC)


def test_full_f32_restores_the_setting():
    prev = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with pconv.full_f32():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = prev
