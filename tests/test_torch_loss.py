"""PyTorch port: the loss functionals and layers against the reference, on
the CPU.

Every functional of ``nn/functional/loss.py`` and every one of the 22
layers of ``nn/layer/loss.py`` runs on the same seeded numpy inputs on
both sides, over its reductions and options. The gradients of
``sum(output * cotangent)`` (a seeded cotangent) with respect to each
floating input come from ``jax.grad`` of the reference functional on one
side and torch autograd on the other; a layer's parameter gradients from
the reference's eager tape. The two layers that own parameters
(``HSigmoidLoss``, ``AdaptiveLogSoftmaxWithLoss``) carry the reference's
state dict across by key (``load_reference_state_dict``), so their keys
and layouts are the reference's. Under ``amp.auto_cast`` O2 each
functional's output dtype is the reference's.

Tolerance, f32 throughout: values within 2e-6 of the largest value's
magnitude (plus 1e-7), gradients within 2e-6 of the largest entry of that
gradient: the same formulas, summed in other orders (the CTC and RNN-T
recursions add up to 7 log-space steps).
"""

import zlib

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

TOL = 2e-6


def _f(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.randn(*shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _i(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


def _sign(rng, *shape):
    return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _logp(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def _ctc(rng):
    return [_f(rng, 7, 3, 5), np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0]], np.int64),
            np.array([7, 5, 6], np.int64), np.array([3, 1, 2], np.int64)]


def _rnnt(rng):
    return [_f(rng, 2, 4, 3, 5), np.array([[1, 3], [2, 0]], np.int64),
            np.array([4, 3], np.int64), np.array([2, 1], np.int64)]


def _hs_table():
    return (np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3], [0, 2, -1]], np.int64),
            np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]], np.float32))


def _adaptive(rng):
    # in 6, cutoffs [3, 6], 9 classes: head [6, 3 + 2], clusters [6, 1] @ [1, 3] twice
    return [_f(rng, 5, 6), np.array([0, 4, 8, 2, 6], np.int64), _f(rng, 6, 5),
            [[_f(rng, 6, 1), _f(rng, 1, 3)], [_f(rng, 6, 1), _f(rng, 1, 3)]],
            [3, 6], _f(rng, 5)]


def _l1_distance(a, b):
    return (a - b).abs().sum(-1)


def _ref_l1_distance(a, b):
    return (a - b).abs().sum(-1)


# (id, name, inputs(rng) -> list, indices of the differentiable inputs, keywords)
CASES = [
    ("nll", "nll_loss", lambda r: [_logp(r, 6, 5), np.array([0, 4, -100, 2, 1, 3])], [0], {}),
    ("nll_weight_sum", "nll_loss", lambda r: [_logp(r, 6, 5), _i(r, 5, 6),
                                              _f(r, 5, lo=0.5, hi=2)], [0, 2],
     dict(reduction="sum")),
    ("nll_weight_mean_3d", "nll_loss", lambda r: [_logp(r, 3, 4, 2), _i(r, 4, 3, 2),
                                                  _f(r, 4, lo=0.5, hi=2)], [0], {}),
    ("nll_none", "nll_loss", lambda r: [_logp(r, 6, 5), _i(r, 5, 6)], [0],
     dict(reduction="none", ignore_index=2)),
    ("mse", "mse_loss", lambda r: [_f(r, 4, 3), _f(r, 4, 3)], [0, 1], {}),
    ("mse_none", "mse_loss", lambda r: [_f(r, 4, 3), _f(r, 4, 3)], [0, 1],
     dict(reduction="none")),
    ("l1_sum", "l1_loss", lambda r: [_f(r, 4, 3), _f(r, 4, 3)], [0, 1], dict(reduction="sum")),
    ("smooth_l1", "smooth_l1_loss", lambda r: [_f(r, 5, 3), _f(r, 5, 3)], [0, 1],
     dict(delta=0.7)),
    ("bce", "binary_cross_entropy", lambda r: [_f(r, 4, 3, lo=0.05, hi=0.95),
                                               _i(r, 2, 4, 3).astype(np.float32)], [0], {}),
    ("bce_weight_none", "binary_cross_entropy",
     lambda r: [_f(r, 4, 3, lo=0.05, hi=0.95), _f(r, 4, 3, lo=0, hi=1), _f(r, 3, lo=0.5, hi=2)],
     [0, 1, 2], dict(reduction="none")),
    ("bce_logits", "binary_cross_entropy_with_logits",
     lambda r: [_f(r, 4, 3), _i(r, 2, 4, 3).astype(np.float32)], [0], {}),
    ("bce_logits_weights", "binary_cross_entropy_with_logits",
     lambda r: [_f(r, 4, 3), _f(r, 4, 3, lo=0, hi=1), _f(r, 3, lo=0.5, hi=2)], [0, 1, 2],
     dict(reduction="sum", pos_weight=np.array([0.5, 2.0, 3.0], np.float32))),
    ("kl_div", "kl_div", lambda r: [_logp(r, 4, 5), _f(r, 4, 5, lo=0.01, hi=1)], [0, 1], {}),
    ("kl_div_batchmean_log", "kl_div", lambda r: [_logp(r, 4, 5), _logp(r, 4, 5)], [0, 1],
     dict(reduction="batchmean", log_target=True)),
    ("kl_div_none", "kl_div", lambda r: [_logp(r, 4, 5), _f(r, 4, 5, lo=0.01, hi=1)], [0, 1],
     dict(reduction="none")),
    ("margin_ranking", "margin_ranking_loss", lambda r: [_f(r, 8), _f(r, 8), _sign(r, 8)],
     [0, 1], dict(margin=0.3)),
    ("hinge_embedding", "hinge_embedding_loss", lambda r: [_f(r, 8), _sign(r, 8)], [0],
     dict(margin=0.5)),
    ("cosine_embedding", "cosine_embedding_loss",
     lambda r: [_f(r, 6, 4), _f(r, 6, 4), _sign(r, 6)], [0, 1], dict(margin=0.1)),
    ("triplet", "triplet_margin_loss", lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)],
     [0, 1, 2], dict(margin=2.0)),
    ("triplet_p1_swap", "triplet_margin_loss",
     lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)], [0, 1, 2],
     dict(p=1.0, swap=True, margin=3.0, reduction="sum")),
    ("ctc", "ctc_loss", _ctc, [0], {}),
    ("ctc_sum_blank", "ctc_loss", _ctc, [0], dict(reduction="sum", blank=4)),
    ("ctc_none_norm", "ctc_loss", _ctc, [0], dict(reduction="none", norm_by_times=True)),
    ("square_error_cost", "square_error_cost", lambda r: [_f(r, 4, 3), _f(r, 4, 3)], [0, 1],
     {}),
    ("sigmoid_focal", "sigmoid_focal_loss",
     lambda r: [_f(r, 6, 3), _i(r, 2, 6, 3).astype(np.float32)], [0], {}),
    ("sigmoid_focal_normalizer", "sigmoid_focal_loss",
     lambda r: [_f(r, 6, 3), _i(r, 2, 6, 3).astype(np.float32), np.array([4.0], np.float32)],
     [0], dict(reduction="mean", gamma=1.5, alpha=0.4)),
    ("log_loss", "log_loss", lambda r: [_f(r, 6, 1, lo=0.05, hi=0.95),
                                        _i(r, 2, 6, 1).astype(np.float32)], [0], {}),
    ("dice", "dice_loss", lambda r: [_f(r, 3, 4, 5, lo=0, hi=1), _i(r, 5, 3, 4, 1)], [0], {}),
    ("npair", "npair_loss", lambda r: [_f(r, 6, 4), _f(r, 6, 4),
                                       np.array([0, 1, 0, 2, 1, 3], np.float32)], [0, 1], {}),
    ("gaussian_nll", "gaussian_nll_loss",
     lambda r: [_f(r, 5, 2), _f(r, 5, 2), _f(r, 5, 2, lo=0.1, hi=2)], [0, 1, 2], {}),
    ("gaussian_nll_full", "gaussian_nll_loss",
     lambda r: [_f(r, 5, 2), _f(r, 5, 2), _f(r, 5, 2, lo=0.1, hi=2)], [0, 1, 2],
     dict(full=True, reduction="sum")),
    ("poisson_nll", "poisson_nll_loss", lambda r: [_f(r, 6), _f(r, 6, lo=0, hi=4)], [0, 1], {}),
    ("poisson_nll_full", "poisson_nll_loss",
     lambda r: [_f(r, 6, lo=0.1, hi=3), _f(r, 6, lo=0, hi=4)], [0, 1],
     dict(log_input=False, full=True, reduction="none")),
    ("multi_margin", "multi_margin_loss", lambda r: [_f(r, 5, 4), _i(r, 4, 5)], [0], {}),
    ("multi_margin_p2_weight", "multi_margin_loss",
     lambda r: [_f(r, 5, 4), _i(r, 4, 5)], [0],
     dict(p=2, margin=0.5, weight=np.array([1.0, 2.0, 0.5, 1.5], np.float32),
          reduction="sum")),
    ("soft_margin", "soft_margin_loss", lambda r: [_f(r, 4, 3), _sign(r, 4, 3)], [0], {}),
    ("margin_cross_entropy", "margin_cross_entropy",
     lambda r: [_f(r, 4, 6, lo=-0.9, hi=0.9), _i(r, 6, 4)], [0], {}),
    ("margin_cross_entropy_softmax", "margin_cross_entropy",
     lambda r: [_f(r, 4, 6, lo=-0.9, hi=0.9), _i(r, 6, 4)], [0],
     dict(margin1=0.9, margin2=0.2, margin3=0.1, scale=16.0, return_softmax=True,
          reduction="none")),
    ("hsigmoid", "hsigmoid_loss", lambda r: [_f(r, 4, 3), _i(r, 6, 4), 6, _f(r, 5, 3),
                                             _f(r, 5, 1)], [0, 3, 4], {}),
    ("hsigmoid_custom", "hsigmoid_loss",
     lambda r: [_f(r, 4, 3), _i(r, 6, 4), 6, _f(r, 5, 3), None, *_hs_table()], [0, 3], {}),
    ("huber", "huber_loss", lambda r: [_f(r, 6, 2), _f(r, 6, 2)], [0, 1], dict(delta=0.6)),
    ("hinge", "hinge_loss", lambda r: [_f(r, 6, 1), _i(r, 2, 6, 1).astype(np.float32)], [0],
     {}),
    ("rnnt", "rnnt_loss", _rnnt, [0], {}),
    ("rnnt_sum_plain", "rnnt_loss", _rnnt, [0], dict(fastemit_lambda=0.0, reduction="sum",
                                                     blank=4)),
    ("rnnt_none", "rnnt_loss", _rnnt, [0], dict(reduction="none")),
    ("multi_label_soft_margin", "multi_label_soft_margin_loss",
     lambda r: [_f(r, 4, 5), _i(r, 2, 4, 5).astype(np.float32)], [0], {}),
    ("multi_label_soft_margin_weight", "multi_label_soft_margin_loss",
     lambda r: [_f(r, 4, 5), _i(r, 2, 4, 5).astype(np.float32), _f(r, 5, lo=0.5, hi=2)],
     [0, 2], dict(reduction="none")),
    ("triplet_distance", "triplet_margin_with_distance_loss",
     lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)], [0, 1, 2], dict(margin=2.0)),
    ("triplet_distance_swap", "triplet_margin_with_distance_loss",
     lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)], [0, 1, 2],
     dict(swap=True, margin=2.5, reduction="sum")),
    ("adaptive_log_softmax", "adaptive_log_softmax_with_loss", _adaptive, [0, 2], {}),
    ("cross_entropy_soft", "cross_entropy", lambda r: [_f(r, 4, 5), _logp(r, 4, 5)], [0],
     dict(soft_label=True, reduction="sum")),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     lambda r: [_f(r, 4, 5), _i(r, 5, 4, 1)], [0], dict(return_softmax=True)),
]


def _port_args(arrays, diff):
    out = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a.copy())
            out.append(t.requires_grad_() if i in diff else t)
        elif isinstance(a, list) and isinstance(a[0], list):   # adaptive tail weights
            out.append([[torch.from_numpy(w) for w in pair] for pair in a])
        else:
            out.append(a)
    return out


def _kw(kw, to):
    return {k: (to(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _ref_call(name, arrays, kw):
    fn = getattr(RF, name)
    args = []
    for a in arrays:
        if isinstance(a, list) and isinstance(a[0], list):
            args.append([[Tensor(w) for w in pair] for pair in a])
        elif isinstance(a, (np.ndarray, jax.Array)):
            args.append(Tensor(a))
        else:
            args.append(a)
    return fn(*args, **_kw(kw, Tensor))


# these cases' reference functionals run eagerly: two read some inputs on the
# host, and hsigmoid's default tree is memoized (functools.lru_cache on
# _hsigmoid_tree), so built under jit it would cache a tracer that the next
# eager caller in the process reads (tests/test_nn_layers_r4.py's hsigmoid
# test failed after this file in one process)
_HOST_READS = ("hsigmoid", "hsigmoid_custom", "adaptive_log_softmax")


def _reference(cid, name, arrays, diff, cot, kw):
    """The reference's output and ``jax.grad`` of ``sum(output * cot)``
    with respect to the inputs at ``diff``."""
    def loss(*diffs):
        args = list(arrays)
        for i, d in zip(diff, diffs):
            args[i] = d
        out = _first(_ref_call(name, args, kw))._data
        return jnp.sum(out * cot), out

    grad = jax.value_and_grad(loss, argnums=tuple(range(len(diff))), has_aux=True)
    if cid not in _HOST_READS:
        grad = jax.jit(grad)
    (_, out), grads = grad(*(jnp.asarray(arrays[i]) for i in diff))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, what):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale + 1e-7, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_functional_values_and_gradients(case):
    cid, name, make, diff, kw = case
    arrays = make(np.random.RandomState(zlib.crc32(cid.encode())))
    args = _port_args(arrays, diff)
    out = getattr(PF, name)(*args, **_kw(kw, torch.from_numpy))
    got = _first(out)
    cot = np.asarray(np.random.RandomState(1).rand(*got.shape) + 0.5, np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    want, grads = _reference(cid, name, arrays, diff, cot, kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.detach().numpy(), want, f"{cid} value")
    for i, g in zip(diff, grads):
        _close(args[i].grad.numpy(), g, f"{cid} gradient of input {i}")
    if isinstance(out, tuple):          # a second, undifferentiated output
        ref_second = np.asarray(_ref_call(name, arrays, kw)[1]._data)
        _close(out[1].detach().numpy(), ref_second, f"{cid} second output")


def test_triplet_with_a_distance_function():
    rng = np.random.RandomState(4)
    arrays = [_f(rng, 5, 4) for _ in range(3)]
    for swap in (False, True):
        got = PF.triplet_margin_with_distance_loss(
            *(torch.from_numpy(a) for a in arrays), distance_function=_l1_distance,
            swap=swap, margin=3.0)
        want = RF.triplet_margin_with_distance_loss(
            *(paddle.to_tensor(a) for a in arrays), distance_function=_ref_l1_distance,
            swap=swap, margin=3.0)
        _close(got.numpy(), np.asarray(want._data), f"swap={swap}")


# (layer, arguments, inputs(rng), keywords of the functional the same inputs reach)
LAYERS = [
    ("CrossEntropyLoss", dict(label_smoothing=0.1), lambda r: [_f(r, 4, 5), _i(r, 5, 4)]),
    ("MSELoss", dict(reduction="sum"), lambda r: [_f(r, 4, 3), _f(r, 4, 3)]),
    ("L1Loss", {}, lambda r: [_f(r, 4, 3), _f(r, 4, 3)]),
    ("NLLLoss", dict(ignore_index=1), lambda r: [_logp(r, 6, 4), _i(r, 4, 6)]),
    ("BCELoss", {}, lambda r: [_f(r, 4, lo=0.1, hi=0.9), _f(r, 4, lo=0, hi=1)]),
    ("BCEWithLogitsLoss", dict(reduction="none"), lambda r: [_f(r, 4), _f(r, 4, lo=0, hi=1)]),
    ("SmoothL1Loss", dict(delta=0.5), lambda r: [_f(r, 4, 3), _f(r, 4, 3)]),
    ("KLDivLoss", dict(reduction="batchmean"),
     lambda r: [_logp(r, 3, 4), _f(r, 3, 4, lo=0.1, hi=1)]),
    ("MarginRankingLoss", dict(margin=0.2), lambda r: [_f(r, 6), _f(r, 6), _sign(r, 6)]),
    ("HingeEmbeddingLoss", {}, lambda r: [_f(r, 6), _sign(r, 6)]),
    ("CosineEmbeddingLoss", dict(margin=0.2), lambda r: [_f(r, 3, 4), _f(r, 3, 4), _sign(r, 3)]),
    ("TripletMarginLoss", dict(swap=True), lambda r: [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)]),
    ("CTCLoss", dict(blank=0, reduction="sum"), _ctc),
    ("PoissonNLLLoss", dict(full=True), lambda r: [_f(r, 5), _f(r, 5, lo=0, hi=3)]),
    ("RNNTLoss", {}, _rnnt),
    ("MultiLabelSoftMarginLoss", {}, lambda r: [_f(r, 3, 4), _i(r, 2, 3, 4).astype(np.float32)]),
    ("TripletMarginWithDistanceLoss", dict(margin=1.5),
     lambda r: [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)]),
    ("MultiMarginLoss", dict(p=2), lambda r: [_f(r, 5, 4), _i(r, 4, 5)]),
    ("SoftMarginLoss", {}, lambda r: [_f(r, 4), _sign(r, 4)]),
    ("GaussianNLLLoss", dict(full=True),
     lambda r: [_f(r, 4, 2), _f(r, 4, 2), _f(r, 4, 2, lo=0.2, hi=2)]),
]


@pytest.mark.parametrize("layer", LAYERS, ids=[c[0] for c in LAYERS])
def test_layers_equal_the_references(layer):
    cls, kw, make = layer
    arrays = make(np.random.RandomState(len(cls)))
    got = getattr(pnn, cls)(**kw)(*(torch.from_numpy(a) for a in arrays))
    ref = getattr(rnn, cls)(**kw)
    want = jax.jit(lambda *a: ref(*(Tensor(x) for x in a))._data)(*arrays)
    _close(got.numpy(), np.asarray(want), cls)


def _carried(ref_layer, port_layer):
    state = {k: np.asarray(v._data) for k, v in ref_layer.state_dict().items()}
    assert sorted(state) == sorted(dict(port_layer.named_parameters()))
    return load_reference_state_dict(port_layer, state)


def _tape_grads(ref_layer, out, cot):
    (out * paddle.to_tensor(cot)).sum().backward()
    return {k: np.asarray(p.grad._data) for k, p in ref_layer.named_parameters()}


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_layer_owns_the_references_parameters(bias):
    rng = np.random.RandomState(5)
    x, y = _f(rng, 6, 4), _i(rng, 7, 6)
    paddle.seed(2)
    ref = rnn.HSigmoidLoss(4, 7, bias_attr=None if bias else False)
    port = _carried(ref, pnn.HSigmoidLoss(4, 7, bias_attr=None if bias else False,
                                          device="cpu"))
    assert port.weight.shape == (6, 4) and (port.bias is None) != bias
    if bias:
        assert port.bias.shape == (6, 1)
    got = port(torch.from_numpy(x), torch.from_numpy(y))
    want = ref(paddle.to_tensor(x), paddle.to_tensor(y))
    _close(got.detach().numpy(), np.asarray(want._data), "hsigmoid")
    cot = rng.rand(6, 1).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    for k, g in _tape_grads(ref, want, cot).items():
        _close(dict(port.named_parameters())[k].grad.numpy(), g, k)
    with pytest.raises(ValueError):
        pnn.HSigmoidLoss(4, 1, device="cpu")


@pytest.mark.parametrize("head_bias", [False, True])
def test_adaptive_log_softmax_layer_owns_the_references_parameters(head_bias):
    rng = np.random.RandomState(6)
    x, y = _f(rng, 7, 8), np.array([0, 3, 5, 9, 11, 2, 7], np.int64)
    paddle.seed(3)
    ref = rnn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8], div_value=2.0, head_bias=head_bias)
    port = _carried(ref, pnn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 8], div_value=2.0,
                                                        head_bias=head_bias, device="cpu"))
    assert tuple(port.tail_w1_1.shape) == (8, 2) and tuple(port.tail_w2_1.shape) == (2, 4)
    out, loss = port(torch.from_numpy(x), torch.from_numpy(y))
    r_out, r_loss = ref(paddle.to_tensor(x), paddle.to_tensor(y))
    _close(out.detach().numpy(), np.asarray(r_out._data), "per-row")
    _close(loss.detach().numpy(), np.asarray(r_loss._data), "loss")
    loss.backward()
    r_loss.backward()
    for k, p in ref.named_parameters():
        _close(dict(port.named_parameters())[k].grad.numpy(), np.asarray(p.grad._data), k)
    lp = port.log_prob(torch.from_numpy(x))
    _close(lp.detach().numpy(), np.asarray(ref.log_prob(paddle.to_tensor(x))._data),
           "log_prob")
    np.testing.assert_allclose(torch.logsumexp(lp, -1).detach().numpy(), 0, atol=1e-5)
    np.testing.assert_array_equal(port.predict(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.predict(paddle.to_tensor(x))._data))
    with pytest.raises(ValueError):
        pnn.AdaptiveLogSoftmaxWithLoss(8, 12, [8, 4], device="cpu")


def test_every_reference_loss_is_ported():
    import paddle_tpu.nn.layer.loss as rlayers

    ref_layers = {n for n in dir(rlayers) if n.endswith("Loss") and n != "Layer"}
    assert len(ref_layers) == 22 and ref_layers <= set(pnn.__all__)
    tested = {c[0] for c in LAYERS} | {"HSigmoidLoss", "AdaptiveLogSoftmaxWithLoss"}
    assert tested == ref_layers
    ref_functionals = {n for n, v in vars(RF.loss).items()
                       if callable(v) and not n.startswith("_") and v.__module__ ==
                       RF.loss.__name__}
    assert ref_functionals == set(PF.loss.__all__)
    assert ref_functionals - {"cross_entropy"} <= {c[1] for c in CASES}


@pytest.mark.parametrize("case", CASES[::4], ids=[c[0] for c in CASES[::4]])
def test_amp_o2_casts_as_the_reference(case):
    cid, name, make, diff, kw = case
    arrays = make(np.random.RandomState(0))
    with pamp.auto_cast(level="O2", dtype="bfloat16"):
        got = _first(getattr(PF, name)(*_port_args(arrays, ()), **_kw(kw, torch.from_numpy)))
    def ref(*arrs):
        return _first(_ref_call(name, list(arrs), kw))._data

    with ramp.auto_cast(level="O2", dtype="bfloat16"):
        want = (ref if cid in _HOST_READS else jax.jit(ref))(*arrays)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), cid
