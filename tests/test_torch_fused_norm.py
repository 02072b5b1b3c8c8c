"""PyTorch port: fused RMSNorm against the reference, on the CPU.

The port's plain versions (what its wrappers run for CPU tensors) against
the reference's ``rms_norm_2d`` Pallas kernels (interpret mode off the TPU,
as ``tests/test_fused_norm.py`` runs them) and their ``jax.grad``; and the
port's ``F.rms_norm`` against the reference's composed path. Inputs are
numpy draws from fixed seeds. Tolerances: f32 sums over H in another order;
in bf16, one bf16 step (both apply the weight in f32 before the one
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas import fused_norm as ref_fn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import fused_norm as fn

RTOL, ATOL = 1e-5, 1e-5


def _draw(seed, n, h):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) * 3).astype(np.float32)
    w = (rng.rand(h) + 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("n,h", [(32, 64), (24, 16), (7, 40)])
def test_plain_forward_and_inv_match_the_pallas_kernel(n, h):
    x, w = _draw(n + h, n, h)
    out_r, (_, _, inv_r) = ref_fn._rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-6)
    out, inv = fn.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_r)[0], rtol=RTOL, atol=0)


@pytest.mark.parametrize("n,h", [(32, 64), (24, 16)])
def test_plain_dx_and_dw_match_the_kernels_gradient(n, h):
    x, w = _draw(3 * n + h, n, h)

    def ref_loss(xa, wa):
        return jnp.sum(jnp.sin(ref_fn.rms_norm_2d(xa, wa, 1e-6)))

    gx_r, gw_r = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    torch.sin(fn.rms_norm_2d(xt, wt, 1e-6)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_r), rtol=1e-4, atol=1e-5)
    # the dx kernel on its own, from the same inv and dout
    dout = np.cos(np.asarray(ref_fn.rms_norm_2d(jnp.asarray(x), jnp.asarray(w), 1e-6)))
    _, (_, _, inv_r) = ref_fn._rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-6)
    dx = fn.rms_norm_bwd_dx(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(np.array(inv_r)[0]), torch.from_numpy(dout))
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx_r), rtol=1e-4, atol=1e-5)


def test_bf16_plain_forward_matches_the_pallas_kernel():
    x, w = _draw(9, 16, 128)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(ref_fn.rms_norm_2d(xb, wb, 1e-6).astype(jnp.float32))
    got = fn.rms_norm_2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("with_weight", [True, False])
def test_functional_rms_norm_matches_reference(with_weight):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = rng.rand(32).astype(np.float32)
    want = RF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w) if with_weight else None,
                       1e-6).numpy()
    got = PF.rms_norm(torch.from_numpy(x), torch.from_numpy(w) if with_weight else None, 1e-6)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_functional_routes_a_mixed_dtype_weight_to_the_composed_form():
    """A weight of another dtype takes the reference's composed form (cast,
    then multiply in x's dtype), bit for bit; the fused op is not called."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 64).astype(np.float32)
    w = rng.rand(64).astype(np.float32)
    want = RF.rms_norm(paddle.to_tensor(x).astype("bfloat16"), paddle.to_tensor(w),
                       1e-6).numpy()
    got = PF.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)
