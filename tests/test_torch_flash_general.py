"""PyTorch port: flash attention beyond the square bf16 case, on the CPU.

The port's flash op takes what the reference's gate sends to a kernel on a
TPU: f32, ``sq != sk`` and head dims other than 64 and 128. Its plain
versions (what the wrappers run for CPU tensors) and its gate are held
against the reference's composed ``_sdpa_ref`` (JAX), forward and
gradients (torch autograd on the port's side, ``jax.grad`` on the
reference's), on the same numpy inputs in f32. Causal attention with
``sq != sk`` is aligned bottom-right, as ``_sdpa_ref`` aligns it: query row
i sees keys ``j <= i + sk - sq``; with ``sk < sq`` the first ``sq - sk``
rows see no key, and the composed path's -1e30 mask makes them uniform
over all keys (the mean of V, and a gradient that does not pass the mask).

The last test records a fault of the reference: on a TPU its gate sends
``sq != sk`` to jax's bundled Mosaic kernel, whose causal mask (and its own
``mha_reference``) aligns top-left, so the kernel path and the composed
path give different answers there.

Tolerances: f32 sums in another order over at most 96 keys of order-1
terms, 2e-5 on outputs and 5e-5 on gradients (as
tests/test_torch_flash_attention.py holds the square case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5       # outputs
GRAD_ATOL = 5e-5  # gradients


def _draw(seed, B, sq, sk, H, Hk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, sq, H, D).astype(np.float32), rng.randn(B, sk, Hk, D).astype(np.float32),
            rng.randn(B, sk, Hk, D).astype(np.float32), rng.randn(B, sq, H, D).astype(np.float32))


def _reference(q, k, v, do, causal):
    """_sdpa_ref's output and (dq, dk, dv) of sum(out * do) by jax.grad."""
    def loss(a, b, c):
        return jnp.sum(_sdpa_ref(a, b, c, causal=causal) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = np.asarray(_sdpa_ref(*args, causal=causal))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return out, [np.asarray(g) for g in grads]


def _port(q, k, v, do, causal, fn):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts, causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(got, want):
    (out, grads), (out_r, grads_r) = got, want
    np.testing.assert_allclose(out, out_r, atol=ATOL)
    for g, gr in zip(grads, grads_r):
        np.testing.assert_allclose(g, gr, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(48, 96), (96, 48), (33, 70), (70, 33)])
def test_sq_ne_sk_matches_the_composed_reference(sq, sk, causal):
    """The flash op (plain versions) against ``_sdpa_ref``, both ways
    round, causal or not, GQA 2."""
    q, k, v, do = _draw(sq * 3 + sk + causal, 2, sq, sk, 4, 2, 32)
    want = _reference(q, k, v, do, causal)
    _check(_port(q, k, v, do, causal, fa.flash_attention), want)


@pytest.mark.parametrize("sq,sk", [(48, 48), (40, 72), (72, 40)])
def test_gate_takes_f32_and_sq_ne_sk_through_the_flash_op(sq, sk, monkeypatch):
    """``nn.functional.flash_attention`` sends f32 and ``sq != sk`` to the
    flash op (on the CPU its plain versions), not to the composed path,
    and agrees with the reference there."""
    import paddle_tpu_torch.nn.functional.attention as port_attn

    def composed(*a, **kw):
        raise AssertionError("the gate sent a flash call to the composed path")

    monkeypatch.setattr(port_attn, "sdpa_ref", composed)
    q, k, v, do = _draw(sq + 2 * sk, 1, sq, sk, 4, 4, 16)
    want = _reference(q, k, v, do, True)
    got = _port(q, k, v, do, True,
                lambda a, b, c, causal: PF.flash_attention(a, b, c, causal=causal)[0])
    _check(got, want)


def test_rows_that_see_no_key_are_uniform_like_the_composed_path():
    """Causal with sk < sq: the first sq - sk rows see no key. Their output
    is the mean of V over all keys, their dQ is 0, and each gives every
    key's dV 1 / sk of its dO; the rest agree with ``_sdpa_ref``."""
    B, sq, sk, H, Hk, D = 1, 56, 24, 2, 1, 16
    q, k, v, do = _draw(11, B, sq, sk, H, Hk, D)
    want = _reference(q, k, v, do, True)
    out, (dq, dk, dv) = _port(q, k, v, do, True, fa.flash_attention)
    _check((out, (dq, dk, dv)), want)
    dead = sq - sk
    np.testing.assert_allclose(out[:, :dead], np.broadcast_to(v.mean(axis=1, keepdims=True),
                                                              (B, dead, H, D)), atol=ATOL)
    assert np.array_equal(dq[:, :dead], np.zeros_like(dq[:, :dead]))
    # dV without the live rows: what the dead rows alone give every key
    _, (_, _, dv_live) = _port(q[:, dead:], k, v, do[:, dead:], True, fa.flash_attention)
    np.testing.assert_allclose(dv - dv_live,
                               np.broadcast_to(do[:, :dead].sum(axis=(1, 2))[:, None, None] / sk,
                                               dv.shape), atol=GRAD_ATOL)
    # the forward's lse of such a row is the mask value, as the composed path's
    _, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), True)
    assert (lse[:, :, :dead] <= -1e29).all() and (lse[:, :, dead:] > -1e29).all()


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_96_under_gqa(causal):
    """A head dim the kernels run padded on the card (to 128 columns): H 8
    over Hk 2, sq != sk."""
    q, k, v, do = _draw(96 + causal, 1, 40, 64, 8, 2, 96)
    want = _reference(q, k, v, do, causal)
    _check(_port(q, k, v, do, causal, fa.flash_attention), want)


def test_f32_square_matches_the_composed_reference():
    """f32 at sq == sk, causal, GQA 4: the case the tiny f32 Llama takes."""
    q, k, v, do = _draw(5, 2, 64, 64, 8, 2, 64)
    want = _reference(q, k, v, do, True)
    _check(_port(q, k, v, do, True, fa.flash_attention), want)


def test_bundled_kernel_reference_aligns_causal_top_left():
    """The reference's fault: jax's bundled ``mha_reference`` (the semantics
    of the Mosaic kernel its gate uses for sq != sk on a TPU) masks causal
    rows top-left (key j <= row i), ``_sdpa_ref`` bottom-right (j <= i +
    sk - sq). They agree at sq == sk and differ at sq != sk."""
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3))

    for sq, sk in ((32, 32), (16, 48)):
        q, k, v, _ = _draw(sq + sk, 1, sq, sk, 2, 2, 16)
        scale = 1.0 / np.sqrt(16)
        bundled = np.asarray(mha_reference(bhsd(q), bhsd(k), bhsd(v), None, causal=True,
                                           sm_scale=scale)).transpose(0, 2, 1, 3)
        composed = np.asarray(_sdpa_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
        ours = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), True)[0]
        np.testing.assert_allclose(ours.numpy(), composed, atol=ATOL)
        gap = np.abs(bundled - composed).max()
        if sq == sk:
            assert gap < 1e-2, gap          # bf16-precision products on both
        else:
            assert gap > 0.1, gap           # another mask, not rounding
