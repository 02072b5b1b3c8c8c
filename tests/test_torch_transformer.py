"""PyTorch port: the nn transformer surface against the reference, on the CPU.

- ``layer_norm``: in f32 with weight and bias, each absent, and over two
  axes; in bf16 the forward bit for bit against the reference's
  ``layer_norm`` under ``jax.jit``, with a control: torch's own
  ``layer_norm``, which applies the weight and bias before its one
  rounding, misses that hold; the ``LayerNorm`` layer's parameters and
  ``weight_attr=False`` / ``bias_attr=False``.
- every ported activation functional against the reference's in f32, and
  the layers against their functionals;
- dropout: ``p`` 0 and 1, eval mode, ``downscale_in_infer``, ``axis``,
  ``dropout2d``/``3d``, the keep rate within a binomial bound, the kept
  values exactly the reference's ``x / (1 - p)`` in f32 and bf16, and two
  encoder layers drawing different masks (with a control: plain deep
  copies repeat each other's);
- ``MultiHeadAttention`` (with and without a mask, ``kdim``/``vdim``),
  decoding step by step through ``Cache`` and ``StaticCache`` equal to the
  full pass, ``TransformerEncoderLayer`` pre- and post-LN,
  ``TransformerEncoder``, ``TransformerDecoder`` and ``Transformer``
  against the reference in f32, with its weights carried by key.

Tolerances: the elementwise functionals are the same formula in another
library, within 1e-6 (f32 ulps of values up to ~10). Layers: f32 sums of
products in another order through at most 4 blocks, within 2e-5
relative and absolute. The cached decode against the full pass: the same
products on the same rows, within 2e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.nn import functional as RF
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.nn import functional as PF

FUNC_TOL = 1e-6
LAYER_TOL = 2e-5
CACHE_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t.numpy(),
                                                                           np.float32)


def _carry(ref_layer, port_layer):
    """The reference layer's weights into the port's, by key."""
    state = {k: np.asarray(v._data) for k, v in ref_layer.state_dict().items()}
    return load_reference_state_dict(port_layer, state)


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------


def _ln_inputs(seed, shape, n_axes=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w = (rng.rand(*shape[-n_axes:]) * 1.5 + 0.25).astype(np.float32)
    b = rng.randn(*shape[-n_axes:]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("which", ["both", "no_weight", "no_bias", "neither", "two_axes"])
def test_layer_norm_f32_matches_reference(which):
    n_axes = 2 if which == "two_axes" else 1
    x, w, b = _ln_inputs(1, (3, 5, 48), n_axes)
    w = None if which in ("no_weight", "neither") else w
    b = None if which in ("no_bias", "neither") else b
    shape = x.shape[-n_axes:]
    want = RF.layer_norm(paddle.to_tensor(x), shape,
                         None if w is None else paddle.to_tensor(w),
                         None if b is None else paddle.to_tensor(b), 1e-5).numpy()
    got = PF.layer_norm(_t(x), shape, None if w is None else _t(w),
                        None if b is None else _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=FUNC_TOL, atol=FUNC_TOL)


@pytest.mark.parametrize("shape", [(4, 7, 32), (16, 768), (2, 64, 96)])
def test_layer_norm_bf16_is_the_references_jitted_rounding(shape):
    x, w, b = _ln_inputs(sum(shape), shape)
    # both sides start from the same bf16 values
    x, w, b = (_t(a).bfloat16() for a in (x, w, b))
    h = shape[-1]

    def ref(xa, wa, ba):
        return RF.layer_norm(Tensor(xa), h, Tensor(wa), Tensor(ba), 1e-12)._data

    want = np.asarray(jax.jit(ref)(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                     for a in (x, w, b))).astype(jnp.float32))
    got = PF.layer_norm(x, h, w, b, 1e-12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # control: torch's layer_norm rounds once, after the weight and bias
    once = torch.nn.functional.layer_norm(x, (h,), w, b, 1e-12).float().numpy()
    assert np.mean(once != want) > 0.05


def test_layer_norm_layer():
    ln = pnn.LayerNorm(16, device="cpu")
    assert ln.weight.shape == (16,) and torch.equal(ln.weight, torch.ones(16))
    assert torch.equal(ln.bias, torch.zeros(16))
    assert list(dict(ln.named_parameters())) == ["weight", "bias"]
    assert pnn.LayerNorm(16, weight_attr=False, device="cpu").weight is None
    bare = pnn.LayerNorm([4, 16], bias_attr=False, device="cpu")
    assert bare.bias is None and bare.weight.shape == (4, 16)
    ref_ln = rnn.LayerNorm(16, epsilon=1e-6)
    port_ln = _carry(ref_ln, pnn.LayerNorm(16, epsilon=1e-6, device="cpu"))
    x = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    np.testing.assert_allclose(port_ln(_t(x)).detach().numpy(),
                               ref_ln(paddle.to_tensor(x)).numpy(), rtol=FUNC_TOL,
                               atol=FUNC_TOL)
    # a ParamAttr is honoured (its initializer, trainable); a non-attribute raises
    held = pnn.LayerNorm(16, weight_attr=pnn.ParamAttr(initializer=pnn.initializer.Constant(2.0),
                                                        trainable=False), device="cpu")
    assert torch.equal(held.weight, torch.full((16,), 2.0)) and not held.weight.requires_grad
    with pytest.raises(TypeError, match="ParamAttr"):
        pnn.LayerNorm(16, weight_attr=object(), device="cpu")


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}), ("silu", {}), ("swish", {}),
    ("mish", {}), ("hardswish", {}), ("hardsigmoid", {}), ("softsign", {}),
    ("tanhshrink", {}), ("log_sigmoid", {}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("leaky_relu", {}), ("leaky_relu", {"negative_slope": 0.2}), ("elu", {"alpha": 0.7}),
    ("celu", {"alpha": 1.3}), ("selu", {}), ("selu", {"scale": 1.2, "alpha": 0.5}),
    ("rrelu", {}), ("hardtanh", {"min": -2.0, "max": 0.5}), ("hardshrink", {}),
    ("softshrink", {"threshold": 0.7}), ("softplus", {}),
    ("softplus", {"beta": 2.0, "threshold": 3.0}), ("maxout", {"groups": 2}),
    ("maxout", {"groups": 3, "axis": -1}), ("softmax", {}), ("softmax", {"axis": 1}),
    ("log_softmax", {}), ("log_softmax", {"axis": 0}), ("glu", {}), ("glu", {"axis": 1}),
    ("thresholded_relu", {}), ("thresholded_relu", {"threshold": 0.5, "value": -1.0}),
    ("swiglu", {}),
]


@pytest.mark.parametrize("name,kw", ACTIVATIONS,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}"
                              for n, k in ACTIVATIONS])
def test_activation_matches_reference(name, kw):
    x = (np.random.RandomState(3).randn(4, 6, 12) * 4).astype(np.float32)
    want = getattr(RF, name)(paddle.to_tensor(x), **kw).numpy()
    got = getattr(PF, name)(_t(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=FUNC_TOL, atol=FUNC_TOL)


@pytest.mark.parametrize("wshape,fmt", [((1,), "NCHW"), ((6,), "NCHW"), ((5,), "NHWC")])
def test_prelu_matches_reference(wshape, fmt):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 3, 5).astype(np.float32)
    w = rng.rand(*wshape).astype(np.float32)
    want = RF.prelu(paddle.to_tensor(x), paddle.to_tensor(w), fmt).numpy()
    np.testing.assert_allclose(PF.prelu(_t(x), _t(w), fmt).numpy(), want, rtol=FUNC_TOL)


def test_softmax_dtype_and_in_place():
    x = np.random.RandomState(5).randn(3, 7).astype(np.float32)
    xb = _t(x).bfloat16()
    got = PF.softmax(xb, dtype="float32")
    assert got.dtype == torch.float32
    want = RF.softmax(paddle.to_tensor(xb.float().numpy())).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=FUNC_TOL, atol=FUNC_TOL)
    assert PF.log_softmax(xb, dtype=torch.float32).dtype == torch.float32
    y = _t(x).clone()
    assert PF.softmax_(y) is y
    assert torch.equal(y, PF.softmax(_t(x)))


def test_random_activations():
    gen = torch.Generator().manual_seed(0)
    x = _t(np.random.RandomState(6).randn(64, 10).astype(np.float32))
    y = PF.rrelu(x, 0.1, 0.3, training=True, generator=gen)
    neg = x < 0
    slope = (y[neg] / x[neg])
    assert torch.equal(y[~neg], x[~neg]) and slope.min() >= 0.1 and slope.max() <= 0.3
    assert slope.std() > 0.01
    soft = PF.gumbel_softmax(x, temperature=0.5, generator=gen)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-5)
    hard = PF.gumbel_softmax(x.requires_grad_(True), hard=True, generator=gen)
    # the one-hot of the argmax, plus y - y in the forward (straight-through)
    one_hot = torch.zeros_like(hard).scatter_(-1, hard.argmax(-1, keepdim=True), 1.0)
    np.testing.assert_allclose(hard.detach().numpy(), one_hot.numpy(), atol=1e-6)
    hard.sum().backward()
    assert x.grad is not None


LAYERS = [("ReLU", "relu", (), {}), ("GELU", "gelu", (True,), {"approximate": True}),
          ("LeakyReLU", "leaky_relu", (0.2,), {"negative_slope": 0.2}),
          ("ELU", "elu", (), {}), ("SELU", "selu", (), {}), ("Softmax", "softmax", (0,),
                                                              {"axis": 0}),
          ("Hardtanh", "hardtanh", (-0.5, 0.5), {"min": -0.5, "max": 0.5}),
          ("Softplus", "softplus", (), {}), ("GLU", "glu", (), {}),
          ("ThresholdedReLU", "thresholded_relu", (0.3,), {"threshold": 0.3}),
          ("Maxout", "maxout", (2,), {"groups": 2}), ("Swish", "silu", (), {}),
          ("Tanhshrink", "tanhshrink", (), {}), ("LogSoftmax", "log_softmax", (), {})]


@pytest.mark.parametrize("cls,fn,args,kw", LAYERS, ids=[c for c, *_ in LAYERS])
def test_activation_layers_call_their_functional(cls, fn, args, kw):
    x = _t((np.random.RandomState(7).randn(4, 6) * 3).astype(np.float32))
    want = getattr(rnn, cls)(*args)(paddle.to_tensor(x.numpy())).numpy()
    got = getattr(pnn, cls)(*args)(x)
    assert torch.equal(got, getattr(PF, fn)(x, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=FUNC_TOL, atol=FUNC_TOL)
    with pytest.raises(TypeError):
        getattr(pnn, cls)(*args, bogus=1)


def test_prelu_and_rrelu_layers():
    layer = pnn.PReLU(3, init=0.1, device="cpu")
    assert torch.equal(layer.weight, torch.full((3,), 0.1))
    x = _t(np.random.RandomState(8).randn(2, 3, 4).astype(np.float32))
    assert torch.equal(layer(x), PF.prelu(x, layer.weight))
    rr = pnn.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(1)).eval()
    assert torch.equal(rr(x), PF.rrelu(x, 0.1, 0.3))


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_edges():
    x = _t(np.random.RandomState(9).randn(8, 16).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert PF.dropout(x, 0.0, generator=gen) is x
    assert PF.dropout(x, 0.4, training=False) is x
    assert torch.equal(PF.dropout(x, 1.0, generator=gen), torch.zeros_like(x))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xd = x.to(dtype)
        want = np.asarray(RF.dropout(Tensor(jnp.asarray(xd.float().numpy(), jdt)), 0.3,
                                     training=False, mode="downscale_in_infer")._data
                          .astype(jnp.float32))
        got = PF.dropout(xd, 0.3, training=False, mode="downscale_in_infer")
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    layer = pnn.Dropout(0.5, generator=gen).eval()
    assert layer(x) is x
    assert pnn.AlphaDropout(0.5).eval()(x) is x


@pytest.mark.parametrize("dtype,jdt", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_at_its_rate_and_scales_as_the_reference(dtype, jdt, p):
    n = 200_000
    x = _t((np.random.RandomState(10).rand(n).astype(np.float32) + 0.5)).to(dtype)
    out = PF.dropout(x, p, generator=torch.Generator().manual_seed(1))
    assert out.dtype == dtype
    kept = out != 0
    # the kept fraction within 5 standard deviations of a Binomial(n, 1 - p)
    assert abs(kept.float().mean().item() - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5
    want = np.asarray((jnp.asarray(x.float().numpy(), jdt) / (1.0 - p)).astype(jnp.float32))
    np.testing.assert_array_equal(out[kept].float().numpy(), want[kept.numpy()])
    down = PF.dropout(x, p, mode="downscale_in_infer", generator=torch.Generator().manual_seed(1))
    assert torch.equal(down != 0, kept) and torch.equal(down[kept], x[kept])


def test_dropout_axis_draws_one_mask_per_index_of_axis():
    x = torch.ones(6, 40, 5)
    gen = torch.Generator().manual_seed(2)
    out = PF.dropout(x, 0.5, axis=1, generator=gen)
    kept = (out != 0).float()
    assert torch.equal(kept, kept[:1, :, :1].expand_as(kept))
    assert 0 < kept[0, :, 0].sum() < 40
    out = PF.dropout(x, 0.5, axis=[0, 2], generator=gen)
    kept = (out != 0).float()
    assert torch.equal(kept, kept[:, :1, :].expand_as(kept))
    x4, x5 = torch.ones(4, 30, 3, 3), torch.ones(4, 30, 2, 2, 2)
    for fn, t in ((PF.dropout2d, x4), (PF.dropout3d, x5)):
        kept = (fn(t, 0.5, generator=gen) != 0).float()
        flat = kept.flatten(2)
        assert torch.equal(flat, flat[..., :1].expand_as(flat))
        assert 0 < flat[..., 0].sum() < 120
    last = (PF.dropout2d(torch.ones(4, 3, 3, 30), 0.5, data_format="NHWC",
                         generator=gen) != 0).float()
    assert torch.equal(last, last[:, :1, :1, :].expand_as(last))


def test_alpha_dropout_keeps_mean_and_variance():
    x = _t(np.random.RandomState(11).randn(400_000).astype(np.float32))
    out = PF.alpha_dropout(x, 0.2, generator=torch.Generator().manual_seed(3))
    assert abs(out.mean().item()) < 0.01 and abs(out.std().item() - 1.0) < 0.01
    assert PF.alpha_dropout(x, 0.2, training=False) is x


def _masks_of_two_layers(make_layers):
    """The dropout1 masks (where the output is 0 and the input not) of the
    first two layers of ``make_layers()``, run in training mode."""
    layers = make_layers()
    seen = []
    for lyr in layers[:2]:
        lyr.dropout1.register_forward_hook(
            lambda mod, args, out: seen.append((out == 0) & (args[0] != 0)))
    x = _t(np.random.RandomState(12).randn(2, 8, 16).astype(np.float32))
    for lyr in layers:
        lyr.train()
        x = lyr(x)
    return seen


def test_encoder_layers_draw_different_dropout_masks():
    gen = torch.Generator().manual_seed(4)
    layer = pnn.TransformerEncoderLayer(16, 2, 32, dropout=0.5, device="cpu", generator=gen)
    enc = pnn.TransformerEncoder(layer, 3)
    assert all(lyr.dropout1.generator is gen and lyr.self_attn.generator is gen
               for lyr in enc.layers)
    a, b = _masks_of_two_layers(lambda: list(enc.layers))
    assert not torch.equal(a, b)
    # control: plain deep copies clone the generator with its state, and
    # repeat each other's masks
    a, b = _masks_of_two_layers(lambda: [copy.deepcopy(layer) for _ in range(2)])
    assert torch.equal(a, b)
    # every copy starts from the same weights, as in the reference
    w = [lyr.linear1.weight for lyr in enc.layers]
    assert all(torch.equal(w[0], v) for v in w[1:]) and w[0] is not w[1]


# ---------------------------------------------------------------------------
# attention and the transformer stacks
# ---------------------------------------------------------------------------


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pad_mask(b, s, pad):
    """Additive [b, 1, 1, s]: 0 on real tokens, -1e9 on the last ``pad``."""
    m = np.zeros((b, 1, 1, s), np.float32)
    m[..., s - pad:] = -1e9
    return m


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kv", [None, (12, 20)])
def test_multi_head_attention_matches_reference(masked, kv):
    kdim, vdim = kv or (None, None)
    ref = rnn.MultiHeadAttention(32, 4, kdim=kdim, vdim=vdim)
    port = _carry(ref, pnn.MultiHeadAttention(32, 4, kdim=kdim, vdim=vdim, device="cpu"))
    q = _x(13, 2, 8, 32)
    k = _x(14, 2, 8, kdim or 32)
    v = _x(15, 2, 8, vdim or 32)
    mask = _pad_mask(2, 8, 3) if masked else None
    want = ref(*map(paddle.to_tensor, (q, k, v)),
               attn_mask=None if mask is None else paddle.to_tensor(mask))
    got = port(_t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask))
    _close(got, want)


def test_cached_decoding_equals_the_full_pass():
    ref = rnn.MultiHeadAttention(32, 4)
    port = _carry(ref, pnn.MultiHeadAttention(32, 4, device="cpu")).eval()
    x, mem = _x(16, 2, 8, 32), _x(17, 2, 8, 32)
    causal = pnn.Transformer.generate_square_subsequent_mask(8, device="cpu")
    ref_causal = rnn.Transformer.generate_square_subsequent_mask(8)
    np.testing.assert_array_equal(causal.numpy(), ref_causal.numpy())
    full = port(_t(x), attn_mask=causal)
    _close(full, ref(paddle.to_tensor(x), attn_mask=ref_causal))
    cache = port.gen_cache(_t(x))
    assert isinstance(cache, pnn.MultiHeadAttention.Cache) and cache.k.shape == (2, 0, 4, 8)
    steps = []
    for t in range(8):
        out, cache = port(_t(x[:, t:t + 1]), cache=cache)
        steps.append(out)
    assert cache.k.shape == (2, 8, 4, 8)
    _close(torch.cat(steps, 1), full, CACHE_TOL)
    # cross attention over memory through a StaticCache
    static = port.gen_cache(_t(mem), type=pnn.MultiHeadAttention.StaticCache)
    full = port(_t(x), _t(mem), _t(mem))
    ref_static = ref.gen_cache(paddle.to_tensor(mem), type=rnn.MultiHeadAttention.StaticCache)
    _close(full, ref(paddle.to_tensor(x), cache=ref_static))
    steps = [port(_t(x[:, t:t + 1]), cache=static) for t in range(8)]
    _close(torch.cat(steps, 1), full, CACHE_TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_matches_reference(pre_ln, activation):
    paddle.seed(20)
    ref_layer = rnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, activation=activation,
                                            normalize_before=pre_ln)
    ref = rnn.TransformerEncoder(ref_layer, 2, rnn.LayerNorm(32) if pre_ln else None)
    port_layer = pnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, activation=activation,
                                             normalize_before=pre_ln, device="cpu")
    port = pnn.TransformerEncoder(port_layer, 2,
                                  pnn.LayerNorm(32, device="cpu") if pre_ln else None)
    # distinct weights a layer, so a layer applied twice would show
    for p in ref.parameters():
        p._data = p._data + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size),
                                                     p._data.shape)
    _carry(ref, port)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    x, mask = _x(21, 2, 8, 32), _pad_mask(2, 8, 2)
    _close(port(_t(x), _t(mask)), ref(paddle.to_tensor(x), paddle.to_tensor(mask)))
    # one encoder layer with a cache, step by step, is its causal full pass
    lyr = port.layers[0]
    causal = pnn.Transformer.generate_square_subsequent_mask(8, device="cpu")
    full = lyr(_t(x), causal)
    cache = lyr.gen_cache(_t(x))
    steps = []
    for t in range(8):
        out, cache = lyr(_t(x[:, t:t + 1]), cache=cache)
        steps.append(out)
    _close(torch.cat(steps, 1), full, CACHE_TOL)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_decoder_and_transformer_match_reference(pre_ln):
    paddle.seed(22)
    ref = rnn.Transformer(32, 4, 2, 2, 48, dropout=0.0, normalize_before=pre_ln)
    port = pnn.Transformer(32, 4, 2, 2, 48, dropout=0.0, normalize_before=pre_ln,
                           device="cpu")
    for p in ref.parameters():
        p._data = p._data + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size + 1),
                                                     p._data.shape)
    _carry(ref, port)
    src, tgt = _x(23, 2, 8, 32), _x(24, 2, 8, 32)
    src_mask = _pad_mask(2, 8, 3)
    tgt_mask = rnn.Transformer.generate_square_subsequent_mask(8).numpy()
    want = ref(paddle.to_tensor(src), paddle.to_tensor(tgt), paddle.to_tensor(src_mask),
               paddle.to_tensor(tgt_mask), paddle.to_tensor(src_mask))
    got = port(_t(src), _t(tgt), _t(src_mask), _t(tgt_mask), _t(src_mask))
    _close(got, want)
    # the decoder stack alone, and decoding with its caches step by step
    memory = port.encoder(_t(src), _t(src_mask))
    full = port.decoder(_t(tgt), memory, _t(tgt_mask), _t(src_mask))
    _close(full, ref.decoder(paddle.to_tensor(tgt), ref.encoder(paddle.to_tensor(src),
                                                                paddle.to_tensor(src_mask)),
                             paddle.to_tensor(tgt_mask), paddle.to_tensor(src_mask)))
    caches = port.decoder.gen_cache(memory)
    steps = []
    for t in range(8):
        out, caches = port.decoder(_t(tgt[:, t:t + 1]), memory, None, _t(src_mask), caches)
        steps.append(out)
    _close(torch.cat(steps, 1), full, CACHE_TOL)


def test_containers():
    a, b = pnn.Linear(3, 4, device="cpu"), pnn.Linear(4, 2, device="cpu")
    seq = pnn.Sequential(a, b)
    assert list(seq.state_dict()) == ["0.weight", "0.bias", "1.weight", "1.bias"]
    named = pnn.Sequential(("first", a), ("second", b))
    assert list(dict(named.named_children())) == ["first", "second"]
    x = torch.randn(2, 3)
    assert torch.equal(seq(x), b(a(x))) and torch.equal(named(x), seq(x))
    lst = pnn.LayerList([a])
    lst.append(b)
    assert len(lst) == 2 and lst[-1] is b and list(lst.state_dict())[2] == "1.weight"
    assert isinstance(lst[:1], pnn.LayerList)
    assert pnn.Identity(3, foo=1)(x) is x
