"""PyTorch port: int8 weight-only matmul with f32 activations, on the CPU.

The reference sends f32 activations to its Pallas kernels (``_dot`` at
``Precision.HIGHEST``). The port's tensor-core kernel takes them through an
exact split: ``x = h + m + l`` in three bf16 pieces, ``x @ W`` the sum of
three bf16 products with the int8 weights (exact in bf16) in f32; for dX
the split is of ``dout * scales`` formed in f32, as the reference's
``do * sb`` rounds there. The plain versions (what the wrappers run for CPU
tensors) compute the same three products, so these tests hold the split:

- the split itself, exactly (``h + m + l == x`` in f64) and its products
  against an f64 product;
- the f32 forward and dX plain versions against the reference's Pallas
  kernels in interpret mode (``jax.vjp`` for dX);
- a tiny f32 ``QuantizedLinear`` forward and backward against the
  reference's ``nn.quant``.

Tolerances: f32 sums over at most 256 products in another order (three
partial sums instead of one): 1e-5 relative plus 1e-4 absolute, as
tests/test_torch_quant_matmul.py holds f32, plus 1e-6 of the output's
largest magnitude, since an f32 sum of 256 products whose partial sums
reach ~1e3 carries ~sqrt(256) f32 ulps of them (the reference's own
kernel is 4.4e-4 from the f64 product at the largest case here); the split
against f64 within 1e-6 of the result's norm (f32 rounding of sums of
exact products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import quant as ref_q
from paddle_tpu.ops.pallas import quant_matmul as ref_qm
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as port_q
from paddle_tpu_torch.ops import quant_matmul as port_qm

F32_RTOL, F32_ATOL, F32_ATOL_FRAC = 1e-5, 1e-4, 1e-6
SPLIT_NORM_RTOL = 1e-6


def _assert_f32_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_ATOL + F32_ATOL_FRAC * np.abs(want).max())


def _case(m, k, n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * scale).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (np.abs(rng.randn(n)) * 0.1 + 1e-3).astype(np.float32)
    dout = rng.randn(m, n).astype(np.float32)
    return x, w, s, dout


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_split_is_exact(scale):
    """Three bf16 pieces carry all 24 bits of an f32, at any magnitude."""
    x = torch.from_numpy(_case(64, 96, 16, seed=1, scale=scale)[0])
    pieces = port_qm.split3(x)
    assert pieces.shape == (3, 64, 96) and pieces.dtype == torch.bfloat16
    total = pieces[0].double() + pieces[1].double() + pieces[2].double()
    assert torch.equal(total, x.double())
    # on the CPU the pre-pass's wrapper is the same split, with the scales
    # multiplied in f32 first
    s = torch.rand(96, dtype=torch.float32) + 0.5
    assert torch.equal(port_qm.int8_prepass(x), pieces)
    assert torch.equal(port_qm.int8_prepass(x, s), port_qm.split3(x * s))
    # ... and for bf16 dout (dX) the scaled dout, each product rounded once
    xb = x.bfloat16()
    assert torch.equal(port_qm.int8_prepass(xb, s), xb * s.bfloat16())


@pytest.mark.parametrize("m,k,n", [(72, 256, 48), (8, 128, 64)])
def test_split_products_match_an_f64_product(m, k, n):
    """The plain versions' three bf16 products, summed in f32, against the
    f64 product of the same f32 values: forward and dX."""
    x, w, s, dout = _case(m, k, n, seed=m + k)
    xt, wt, st, dt = (torch.from_numpy(a) for a in (x, w, s, dout))
    got = port_qm.int8_matmul_ref(xt, wt, st).double()
    want = (xt.double() @ wt.double()) * st.double()
    assert (got - want).norm() <= SPLIT_NORM_RTOL * want.norm()
    got = port_qm.int8_matmul_dx_ref(dt, wt, st).double()
    want = (dt * st).double() @ wt.double().T
    assert (got - want).norm() <= SPLIT_NORM_RTOL * want.norm()


@pytest.mark.parametrize("m,k,n", [(72, 128, 48), (16, 64, 32), (128, 256, 128)])
def test_f32_forward_matches_the_pallas_kernel(m, k, n):
    """f32 ``int8_matmul`` (the weight stream's M <= 64 and the tensor-core
    kernel's M > 64 share this plain version on the CPU) against the
    reference's kernel in interpret mode at f32."""
    x, w, s, _ = _case(m, k, n, seed=3 * m + n)
    want = np.asarray(ref_qm.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    for fn in (port_qm.int8_matmul, port_qm.int8_matmul_large_m):
        got = fn(*(torch.from_numpy(a) for a in (x, w, s)))
        assert got.dtype == torch.float32
        _assert_f32_close(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(72, 128, 48), (16, 64, 32)])
def test_f32_dx_matches_jax_vjp_through_the_pallas_kernel(m, k, n):
    x, w, s, dout = _case(m, k, n, seed=5 * m + k)
    _, vjp = jax.vjp(lambda xx: ref_qm.int8_matmul(xx, jnp.asarray(w), jnp.asarray(s)),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dout))
    got = port_qm.int8_matmul_dx(*(torch.from_numpy(a) for a in (dout, w, s)))
    assert got.dtype == torch.float32 and got.shape == (m, k)
    _assert_f32_close(got.numpy(), want)


def test_card_checks_take_f32_and_refuse_fp16():
    """The wrappers' checks (run before any launch) take f32; the forward
    takes fp16 too, dX refuses it."""
    w = torch.zeros((32, 32), dtype=torch.int8)
    s = torch.ones(32)
    port_qm._check(torch.zeros((4, 32)), w, s)
    port_qm._check(torch.zeros((4, 32)), w, s, "int8_matmul_dx", along=1)
    port_qm._check(torch.zeros((4, 32), dtype=torch.float16), w, s)
    with pytest.raises(TypeError):
        port_qm._check(torch.zeros((4, 32), dtype=torch.float16), w, s, "int8_matmul_dx",
                       along=1)


def test_prepass_refuses_what_its_kernel_does_not_take():
    """The pre-pass checks its arguments on the CPU too: the dtype, the
    scales that bf16 (dX's dout) needs, and scales of x's C columns."""
    x = torch.zeros((4, 32))
    s = torch.ones(32)
    with pytest.raises(TypeError):
        port_qm.int8_prepass(x.half(), s)
    with pytest.raises(ValueError, match="needs its scales"):
        port_qm.int8_prepass(x.bfloat16())
    with pytest.raises(ValueError, match="scales must be"):
        port_qm.int8_prepass(x, s[:16])
    with pytest.raises(ValueError, match="scales must be"):
        port_qm.int8_prepass(x.bfloat16(), s.double())
    with pytest.raises(ValueError, match=r"\[rows, C\]"):
        port_qm.int8_prepass(x[None], s)


@pytest.mark.parametrize("with_bias", [False, True])
def test_f32_quantized_linear_forward_and_backward_match_reference(with_bias):
    """A tiny f32 ``QuantizedLinear`` (72 tokens, 64 -> 48): output and the
    input's gradient against the reference's ``nn.quant`` on the same int8
    weights and scales."""
    rl = paddle.nn.Linear(64, 48, bias_attr=None if with_bias else False)
    rql = ref_q.QuantizedLinear(rl)
    pl = Linear(64, 48, bias_attr=None if with_bias else False, device="cpu")
    with torch.no_grad():
        pl.weight.copy_(torch.from_numpy(np.array(rl.weight.numpy())))
        if with_bias:
            pl.bias.copy_(torch.from_numpy(np.array(rl.bias.numpy())))
    pql = port_q.QuantizedLinear(pl)
    np.testing.assert_array_equal(pql.weight.numpy(), np.asarray(rql.weight.numpy()))

    rng = np.random.RandomState(9)
    x = rng.randn(72, 64).astype(np.float32)
    dout = rng.randn(72, 48).astype(np.float32)
    xr = paddle.to_tensor(x, stop_gradient=False)
    out_r = rql(xr)
    (out_r * paddle.to_tensor(dout)).sum().backward()
    xp = torch.from_numpy(x).requires_grad_(True)
    out_p = pql(xp)
    out_p.backward(torch.from_numpy(dout))
    assert out_p.dtype == torch.float32
    _assert_f32_close(out_p.detach().numpy(), out_r.numpy())
    _assert_f32_close(xp.grad.numpy(), xr.grad.numpy())
