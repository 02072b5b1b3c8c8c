"""PyTorch port: flash attention against the reference, on the CPU.

The port's plain versions (what its wrappers run for CPU tensors) against
the reference's FA2 Pallas kernels in interpret mode (``pallas_call``
patched as ``tests/test_flash_kernel.py`` does), and the port's attention
functionals against the reference's, forward and gradients (torch autograd
on the port's side, ``jax.grad`` on the reference's). Inputs are numpy
draws from fixed seeds, in f32. Tolerances: f32 sums in another order over
at most 384 keys of order-1 terms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.autograd.tape import no_grad as ref_no_grad
from paddle_tpu.nn import functional as RF
from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu.tensor import Tensor as RefTensor
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5       # outputs and lse
GRAD_ATOL = 5e-5  # gradients


@pytest.fixture()
def fk(monkeypatch):
    from jax.experimental import pallas as pl

    import paddle_tpu.ops.pallas.flash_kernel as mod

    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


def _draw(seed, B, S, H, Hk, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Hk, D).astype(np.float32)
    v = rng.randn(B, S, Hk, D).astype(np.float32)
    do = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v, do


def _bhsd(a):
    B, S, H, D = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))


def _bsnd(a, B):
    BH, S, D = a.shape
    return np.asarray(a).reshape(B, BH // B, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 384])
def test_plain_forward_and_backward_match_the_pallas_kernels(fk, causal, seq):
    B, H, D = 2, 2, 64
    q, k, v, do = _draw(seq + causal, B, seq, H, H, D)
    out_r, lse_r = fk.flash_fwd_partial(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                                        scale=None)
    out, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), _bsnd(out_r, B), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r).reshape(B, H, seq), atol=ATOL)

    delta_r = jnp.sum(jnp.asarray(_bhsd(do)) * out_r, axis=-1)[:, None, :]
    grads_r = fk.flash_bwd_partial(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do), lse_r, delta_r,
                                   causal=causal, scale=None)
    lse_t = torch.from_numpy(np.array(lse_r).reshape(B, H, seq))
    delta_t = torch.from_numpy(np.array(delta_r).reshape(B, H, seq))
    grads = fa.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                   lse_t, delta_t, causal)
    for g, gr in zip(grads, grads_r):
        np.testing.assert_allclose(g.numpy(), _bsnd(gr, B), atol=GRAD_ATOL)


def _ref_grads(fn, q, k, v, do):
    def loss(qa, ka, va):
        return jnp.sum(fn(qa, ka, va) * jnp.asarray(do))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    return np.asarray(fn(jq, jk, jv)), [np.asarray(g) for g in
                                        jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]


def _port_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _ref_functional(fn, **kw):
    def run(qa, ka, va):
        with ref_no_grad():
            out = fn(RefTensor(qa), RefTensor(ka), RefTensor(va), **kw)
        out = out[0] if isinstance(out, tuple) else out
        return out._data
    return run


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_with_gqa_matches_reference_attention(causal):
    """The port's differentiable flash op (plain on the CPU) in f32 with
    GQA, including the group sum of dK and dV, against the reference's
    composed attention differentiated by jax.grad."""
    q, k, v, do = _draw(11 + causal, 2, 40, 8, 2, 16)
    want, want_g = _ref_grads(lambda a, b, c: _sdpa_ref(a, b, c, causal=causal), q, k, v, do)
    got, got_g = _port_grads(lambda a, b, c: fa.flash_attention(a, b, c, causal), q, k, v, do)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_functional_matches_reference(causal):
    q, k, v, do = _draw(21 + causal, 2, 24, 4, 2, 16)
    want, want_g = _ref_grads(_ref_functional(RF.flash_attention, causal=causal), q, k, v, do)
    got, got_g = _port_grads(lambda a, b, c: PF.flash_attention(a, b, c, causal=causal)[0],
                             q, k, v, do)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


@pytest.mark.parametrize("mask_kind", ["bool", "additive", None])
def test_sdpa_with_mask_matches_reference(mask_kind):
    q, k, v, do = _draw(31, 2, 20, 4, 1, 8)
    rng = np.random.RandomState(5)
    if mask_kind == "bool":
        mask = rng.rand(2, 1, 20, 20) > 0.3
        mask[..., 0] = True                      # every row keeps a key
    elif mask_kind == "additive":
        mask = (rng.randn(2, 4, 20, 20) * 2).astype(np.float32)
    else:
        mask = None
    kw = dict(is_causal=mask is None)
    ref_mask = None if mask is None else RefTensor(jnp.asarray(mask))
    want, want_g = _ref_grads(
        _ref_functional(RF.scaled_dot_product_attention, attn_mask=ref_mask, **kw),
        q, k, v, do)
    port_mask = None if mask is None else torch.from_numpy(mask)
    got, got_g = _port_grads(
        lambda a, b, c: PF.scaled_dot_product_attention(a, b, c, attn_mask=port_mask, **kw),
        q, k, v, do)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


def test_gate_routes_by_the_reference_rules():
    q = torch.zeros((1, 8, 2, 16))
    # what the reference keeps composed: a head_dim that is not a multiple
    # of 8, and dtypes outside bf16/fp16/f32
    assert fa.flash_attention_bsnd(q[..., :12], q[..., :12], q[..., :12], True) is None
    assert fa.flash_attention_bsnd(q.double(), q.double(), q.double(), True) is None
    # bf16 and f32, sq == sk or not, are the flash op; on the CPU its plain
    # version, which never counts a kernel launch
    qb = q.bfloat16()
    before = dict(fa.flash_attention_fwd.by_route)
    for args in ((qb, qb, qb), (q, q, q), (qb[:, :4], qb, qb), (q, q[:, :3], q[:, :3])):
        out = fa.flash_attention_bsnd(*args, True)
        assert out.shape == args[0].shape and out.dtype == args[0].dtype
    assert fa.flash_attention_fwd.by_route == before


def test_bf16_plain_forward_rounds_probabilities_like_the_kernel():
    """In bf16 the plain version rounds the probabilities to bf16 before
    the product with V (as the TPU kernel does); the result stays within
    bf16 steps of the f32 attention."""
    q, k, v, _ = _draw(41, 1, 64, 4, 2, 32)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, lse = fa.flash_attention_fwd(qb, kb, vb, True)
    out32, lse32 = fa.flash_attention_fwd(qb.float(), kb.float(), vb.float(), True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.float().numpy(), out32.numpy(), atol=2e-2)


def test_tile_errors_catch_a_fault_confined_to_the_last_k_tile():
    """The per-tile measure the kernels are held to on the card. A dV whose
    last K tile also sums the rows before each key (a diagonal mask lost
    there) is off by about its own size in that tile, far over 1e-2 of the
    tile's norm, while the error stays under 2e-2 of the tensor's largest
    |dV|, which sits at key 0 that every row sees. The bf16 rounding of the
    plain backward itself (against f32 P and dS) stays under half the
    limit."""
    B, S, H, Hk, D = 1, 2048, 4, 1, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _draw(7, B, S, H, Hk, D))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, True)
    grads32 = fa.flash_attention_bwd(q.float(), k.float(), v.float(), do.float(), lse, delta,
                                     True)
    for g, g32 in zip(grads, grads32):
        assert fa.tile_errors(g, g32)[0] < 5e-3
    dv = grads[2]
    s = torch.einsum("bqhd,bkd->bhqk", q.float(), k.float()[:, :, 0]) / D ** 0.5
    p = torch.exp(torch.clamp_max(s - lse[..., None], fa.CLAMP))
    rows = torch.arange(S)
    lost = (rows[:, None] >= (S - 1) // 64 * 64) & (rows[None, :] > rows[:, None])
    dv_bad = (dv.float()
              + torch.einsum("bhqk,bqhd->bkd", p * lost, do.float())[:, :, None]).bfloat16()
    tile, err = fa.tile_errors(dv_bad, dv)
    assert tile > 0.5
    assert err < 2e-2 * dv.float().abs().max().item()
