"""PyTorch port: the pools against the reference, on the CPU.

- ``max_pool1d/2d/3d`` forward and gradient against ``jax.vjp`` of the
  reference's functional: ResNet's stem pool (3x3, stride 2, pad 1),
  LeNet's (2x2, stride 2), ``ceil_mode`` on odd sizes (with a pad and
  without), flattened ``[before, after]`` pads, ``"SAME"`` at stride 2,
  ``"VALID"``, channel-last layouts; ``return_mask`` (flat indices over
  the unpadded plane) equal to the reference's, and inputs with ties
  (a ReLU's zeros and coarse values, in f32 and bf16): both route the
  gradient to the first maximum of each window;
- ``avg_pool1d/2d/3d`` with the exclusive divisor (the default) and
  without, with ``ceil_mode`` and pads, ``"SAME"`` (the window's size as
  divisor), channel-last layouts; ``divisor_override`` ignored;
- the adaptive pools at output sizes that divide the input and that do
  not (overlapping windows), 1-D to 3-D, channel-last average pools;
  adaptive max's gradient split between tied maxima as the reference's,
  and its mask equal to the reference's 3-D mask (the reference's 1-D
  and 2-D masks are zeros; a 2-D input is held as a 3-D one of depth 1);
- the layers against their functionals.

Tolerances: max pools pick values, so forward and masks are exact; a
gradient is a sum of at most 4 cotangents (overlapping windows), within
1e-6. Average pools: f32 sums of at most 27 values in another order and
one division, within 1e-6 of the largest magnitude; in bf16 one bf16
rounding more on either side, within 2^-7 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as rnn
from paddle_tpu.nn import functional as RF
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF

TOL = 1e-6
BF16_FRAC = 2.0 ** -7


def _close(got, want, frac=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1.0))


def _run(fn_ref, fn_port, x, seed=0, dtype=np.float32):
    """(port out, port grad, reference out, reference grad) of a pool of
    ``x`` (float32 numpy; cast to bf16 on both sides when asked), with a
    seeded cotangent; the mask too where the pool returns one."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    extra = {}

    def ref(a):
        out = fn_ref(Tensor(a))
        if isinstance(out, tuple):
            extra["ref_mask"] = np.asarray(out[1]._data)
            out = out[0]
        return out._data

    out_r, vjp = jax.vjp(ref, jnp.asarray(x, jdt))
    cot = np.random.RandomState(seed).randn(*out_r.shape).astype(np.float32)
    (g_r,) = vjp(jnp.asarray(cot, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = fn_port(xt)
    if isinstance(out, tuple):
        extra["mask"] = out[1].numpy()
        assert out[1].dtype == torch.int32
        out = out[0]
    assert out.dtype == tdt
    out.backward(torch.from_numpy(cot).to(tdt))
    return (out.detach().float().numpy(), xt.grad.float().numpy(),
            np.asarray(out_r.astype(jnp.float32)), np.asarray(g_r.astype(jnp.float32)), extra)


def _x(shape, seed=0, ties=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if ties:
        # a ReLU's zeros and values on a coarse grid: many windows tie
        x = np.maximum(np.round(x * 2) / 2, 0).astype(np.float32)
    return x


MAX_CASES = [
    ("stem_3x3_s2_p1", 2, (2, 3, 12, 12), dict(kernel_size=3, stride=2, padding=1)),
    ("lenet_2x2", 2, (2, 3, 8, 10), dict(kernel_size=2, stride=2)),
    ("ceil_odd", 2, (2, 3, 9, 11), dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("ceil_odd_pad", 2, (2, 3, 7, 10), dict(kernel_size=3, stride=2, padding=1,
                                            ceil_mode=True)),
    ("ceil_dropped_window", 2, (1, 2, 5, 5), dict(kernel_size=2, stride=2, padding=1,
                                                  ceil_mode=True)),
    ("flat_pads", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=[0, 1, 1, 0])),
    ("same_s2", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding="SAME")),
    ("valid", 2, (2, 3, 9, 8), dict(kernel_size=[3, 2], stride=[2, 1], padding="VALID")),
    ("nhwc", 2, (2, 9, 8, 3), dict(kernel_size=3, stride=2, padding=1, data_format="NHWC")),
    ("pool1d", 1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("pool1d_nlc", 1, (2, 11, 3), dict(kernel_size=2, data_format="NLC")),
    ("pool3d", 3, (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2, padding=1)),
    ("pool3d_ndhwc", 3, (1, 5, 6, 7, 2), dict(kernel_size=2, stride=2, ceil_mode=True,
                                              data_format="NDHWC")),
]


@pytest.mark.parametrize("mask", [False, True], ids=["values", "mask"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("name,spatial,shape,kw", MAX_CASES, ids=[c[0] for c in MAX_CASES])
def test_max_pool_matches_reference(name, spatial, shape, kw, ties, mask):
    if mask and kw.get("padding") == "SAME":
        for mod, a in ((RF, Tensor(jnp.asarray(_x(shape)))), (PF, torch.from_numpy(_x(shape)))):
            with pytest.raises(ValueError):
                getattr(mod, f"max_pool{spatial}d")(a, return_mask=True, **kw)
        return
    fn = f"max_pool{spatial}d"
    kw = dict(kw, return_mask=mask)
    got, g, want, gw, extra = _run(lambda a: getattr(RF, fn)(a, **kw),
                                   lambda a: getattr(PF, fn)(a, **kw), _x(shape, ties=ties))
    np.testing.assert_array_equal(got, want)
    _close(g, gw)
    if mask:
        np.testing.assert_array_equal(extra["mask"], extra["ref_mask"])


@pytest.mark.parametrize("name", ["stem_3x3_s2_p1", "ceil_odd_pad"])
def test_max_pool_bf16_ties(name):
    _, spatial, shape, kw = next(c for c in MAX_CASES if c[0] == name)
    x = _x(shape, 3, ties=True)
    got, g, want, gw, _ = _run(lambda a: RF.max_pool2d(a, **kw), lambda a: PF.max_pool2d(a, **kw),
                               x, dtype="bf16")
    np.testing.assert_array_equal(got, want)
    # the cotangents (bf16) are added where windows overlap: one rounding
    _close(g, gw, BF16_FRAC)
    # most windows hold a tie: half the input is a ReLU's zeros, the rest
    # takes 6 values
    assert (x == 0).mean() > 0.4 and len(np.unique(x)) <= 8


AVG_CASES = [
    ("plain", 2, (2, 3, 8, 10), dict(kernel_size=2)),
    ("pad_exclusive", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("pad_inclusive", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                            exclusive=False)),
    ("ceil_exclusive", 2, (2, 3, 9, 11), dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("ceil_inclusive", 2, (2, 3, 7, 10), dict(kernel_size=3, stride=2, padding=1,
                                              ceil_mode=True, exclusive=False)),
    ("flat_pads", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=[0, 1, 1, 0])),
    ("same", 2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding="SAME")),
    ("divisor_override_ignored", 2, (2, 3, 8, 8), dict(kernel_size=2, padding=1,
                                                       divisor_override=3)),
    ("nhwc", 2, (2, 9, 8, 3), dict(kernel_size=3, stride=2, padding=1, data_format="NHWC")),
    ("pool1d", 1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("pool1d_nlc", 1, (2, 11, 3), dict(kernel_size=2, exclusive=False, data_format="NLC")),
    ("pool3d", 3, (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2, padding=1)),
    ("pool3d_ceil", 3, (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2, ceil_mode=True)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,spatial,shape,kw", AVG_CASES, ids=[c[0] for c in AVG_CASES])
def test_avg_pool_matches_reference(name, spatial, shape, kw, dtype):
    fn = f"avg_pool{spatial}d"
    got, g, want, gw, _ = _run(lambda a: getattr(RF, fn)(a, **kw),
                               lambda a: getattr(PF, fn)(a, **kw), _x(shape, 1),
                               dtype=np.float32 if dtype == "f32" else "bf16")
    frac = TOL if dtype == "f32" else BF16_FRAC
    _close(got, want, frac)
    _close(g, gw, frac)


ADAPTIVE_CASES = [
    ("avg", 1, (2, 3, 12), 4, {}), ("avg", 1, (2, 3, 10), 4, {}),
    ("avg", 2, (2, 3, 8, 6), (4, 3), {}), ("avg", 2, (2, 3, 7, 9), (3, 4), {}),
    ("avg", 2, (2, 7, 7, 3), 1, dict(data_format="NHWC")),
    ("avg", 2, (2, 7, 9, 3), (3, 2), dict(data_format="NHWC")),
    ("avg", 3, (1, 2, 4, 6, 4), 2, {}), ("avg", 3, (1, 2, 5, 6, 7), (2, 3, 3), {}),
    ("avg", 3, (1, 5, 6, 7, 2), (2, 3, 3), dict(data_format="NDHWC")),
    ("max", 1, (2, 3, 12), 4, {}), ("max", 1, (2, 3, 10), 4, {}),
    ("max", 2, (2, 3, 8, 6), (4, 3), {}), ("max", 2, (2, 3, 7, 9), (3, 4), {}),
    ("max", 3, (1, 2, 4, 6, 4), 2, {}), ("max", 3, (1, 2, 5, 6, 7), (2, 3, 3), {}),
]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("kind,spatial,shape,size,kw", ADAPTIVE_CASES,
                         ids=[f"{c[0]}{c[1]}d_{'x'.join(map(str, c[2]))}_{c[3]}"
                              for c in ADAPTIVE_CASES])
def test_adaptive_pool_matches_reference(kind, spatial, shape, size, kw, ties):
    if kind == "avg" and ties:
        return
    fn = f"adaptive_{kind}_pool{spatial}d"
    got, g, want, gw, _ = _run(lambda a: getattr(RF, fn)(a, size, **kw),
                               lambda a: getattr(PF, fn)(a, size, **kw),
                               _x(shape, 2, ties=ties))
    _close(got, want)
    # adaptive max: a tied window splits its cotangent between its maxima
    # on both sides
    _close(g, gw)


@pytest.mark.parametrize("shape,size", [((2, 3, 8, 6), (4, 3)), ((2, 3, 7, 9), (3, 4)),
                                        ((2, 3, 6, 6), 1)])
def test_adaptive_max_mask_is_the_references_3d_mask(shape, size):
    x = _x(shape, 5, ties=True)
    out, mask = PF.adaptive_max_pool2d(torch.from_numpy(x), size, return_mask=True)
    size3 = (1, *size) if isinstance(size, tuple) else (1, size, size)
    want, want_mask = RF.adaptive_max_pool3d(Tensor(jnp.asarray(x[:, :, None])), size3,
                                             return_mask=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want._data)[:, :, 0])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask._data)[:, :, 0])
    # and the 3-D mask itself, divisible and not
    x3 = _x((1, 2, 5, 6, 7), 6, ties=True)
    for s3 in ((2, 3, 3), (5, 2, 7)):
        got = PF.adaptive_max_pool3d(torch.from_numpy(x3), s3, return_mask=True)[1]
        ref = RF.adaptive_max_pool3d(Tensor(jnp.asarray(x3)), s3, return_mask=True)[1]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref._data))
    # the 1-D mask: each index holds its window's maximum
    x1 = torch.from_numpy(_x((2, 3, 10), 7))
    vals, idx = PF.adaptive_max_pool1d(x1, 4, return_mask=True)
    assert torch.equal(x1.gather(-1, idx.long()), vals)


LAYER_CASES = [
    ("MaxPool1D", (3,), dict(stride=2, padding=1, ceil_mode=True), (2, 3, 11)),
    ("MaxPool2D", (3,), dict(stride=2, padding=1), (2, 3, 9, 8)),
    ("MaxPool3D", (2,), dict(stride=2), (1, 2, 4, 6, 4)),
    ("AvgPool1D", (3,), dict(stride=2, padding=1, exclusive=False), (2, 3, 11)),
    ("AvgPool2D", (3,), dict(stride=2, padding=1, ceil_mode=True), (2, 3, 9, 8)),
    ("AvgPool3D", (2,), dict(stride=2), (1, 2, 4, 6, 4)),
    ("AdaptiveAvgPool1D", (4,), {}, (2, 3, 10)),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 7, 7)),
    ("AdaptiveAvgPool3D", (2,), {}, (1, 2, 4, 6, 4)),
    ("AdaptiveMaxPool1D", (4,), {}, (2, 3, 10)),
    ("AdaptiveMaxPool2D", ((3, 4),), {}, (2, 3, 7, 9)),
    ("AdaptiveMaxPool3D", (2,), {}, (1, 2, 4, 6, 4)),
]


@pytest.mark.parametrize("cls,args,kw,shape", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_pool_layers_match_reference(cls, args, kw, shape):
    x = _x(shape, 8)
    got = getattr(pnn, cls)(*args, **kw)(torch.from_numpy(x))
    want = getattr(rnn, cls)(*args, **kw)(Tensor(jnp.asarray(x)))
    _close(got.numpy(), np.asarray(want._data))


def test_max_pool_layer_mask():
    x = _x((2, 3, 9, 8), 9, ties=True)
    out, mask = pnn.MaxPool2D(3, 2, 1, return_mask=True)(torch.from_numpy(x))
    want, want_mask = rnn.MaxPool2D(3, 2, 1, return_mask=True)(Tensor(jnp.asarray(x)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask._data))
