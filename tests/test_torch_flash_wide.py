"""PyTorch port: attention past 256 columns, on the CPU.

The reference's gate sends any head_dim that is a multiple of 8 to its
bundled flash kernel (``paddle_tpu/ops/pallas/flash_attention.py:91``), and
its composed paged path serves any head dim and page size. The port's
flash kernels' tiles stop at 256 columns; past that the flash op takes its
``wide`` route (``csrc/flash_attention.cu``'s wide kernels: the output in
chunks of :func:`fa.chunk_plan`), and paged attention its kernel's wide mode
(``csrc/paged_attention.cu``: four column slices whose partial scores are
added in warp order, units of boxes of rows of a page). On the CPU every
route runs the plain version, so these tests hold what the card's wide
kernels are held to (tests/test_torch_kernels_cuda.py and chip_smoke.py
hold the kernels against these plain versions), and the paged kernel's
arithmetic through its CPU emulation (``paged_decode_attention_split``):

- the flash op at head dims 320 and 512, causal or not, ``sq != sk``, GQA,
  forward and gradients, and through ``nn.functional.flash_attention``'s
  gate, against the reference's composed ``_sdpa_ref`` with ``jax.grad``;
- paged decode attention at head dims 320, 512, 520 and 1024 and at pages
  of 300 and 512 slots, the plain version and the wide mode's emulation,
  against the reference's composed path (``gather_lane_window`` +
  ``masked_attend``), in f32 and fp16;
- the routes: the router's ``wide`` past 256 and paged attention's ``mode``;
- the wide route's chunk plan at every head dim it takes.

Tolerances: f32 sums in another order over up to 512 columns and 96 keys
of order-1 terms: 5e-5 on outputs and 2e-4 on gradients (the scores grow
with the head dim); fp16 paged as tests/test_torch_paged_attention.py
holds it (4e-3: a rounding step of the output and of a probability apart),
the wide mode's emulation too (it keeps f32 scores and probabilities where
the reference rounds them to fp16; outputs stay below 4 here, where an fp16
step is 2^-9 at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import paged_attention as ref_pa
from paddle_tpu.models.llama import masked_attend
from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa

ATOL = 5e-5
GRAD_ATOL = 2e-4
PAGED_TOL = {np.float16: 4e-3, np.float32: 5e-5}


def _draw(seed, B, sq, sk, H, Hk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, sq, H, D).astype(np.float32), rng.randn(B, sk, Hk, D).astype(np.float32),
            rng.randn(B, sk, Hk, D).astype(np.float32), rng.randn(B, sq, H, D).astype(np.float32))


def _reference(q, k, v, do, causal):
    def loss(a, b, c):
        return jnp.sum(_sdpa_ref(a, b, c, causal=causal) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = np.asarray(_sdpa_ref(*args, causal=causal))
    return out, [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


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


@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(40, 40), (24, 56), (56, 24)])
def test_flash_past_256_matches_the_composed_reference(D, causal, sq, sk):
    q, k, v, do = _draw(D + sq + 2 * sk + causal, 1, sq, sk, 4, 2, D)
    want = _reference(q, k, v, do, causal)
    _check(_port(q, k, v, do, causal, fa.flash_attention), want)


def test_the_gate_sends_head_dim_320_to_the_flash_op(monkeypatch):
    import paddle_tpu_torch.nn.functional.attention as port_attn

    def composed(*a, **kw):
        raise AssertionError("the gate sent a flash call to the composed path")

    monkeypatch.setattr(port_attn, "sdpa_ref", composed)
    q, k, v, do = _draw(3, 2, 32, 32, 2, 2, 320)
    want = _reference(q, k, v, do, True)
    got = _port(q, k, v, do, True,
                lambda a, b, c, causal: PF.flash_attention(a, b, c, causal=causal)[0])
    _check(got, want)
    assert fa.route(torch.zeros((1, 1, 1, 320))) == "wide"
    assert fa.route(torch.zeros((1, 1, 1, 256), dtype=torch.bfloat16)) == "padded"


def _paged_case(np_dtype, hd, bs, lengths, seed, H=4, Hk=2, MB=3):
    rng = np.random.RandomState(seed)
    lanes, nb = len(lengths), 1 + len(lengths) * MB
    pk = rng.randn(nb, bs, Hk, hd).astype(np_dtype)
    pv = rng.randn(nb, bs, Hk, hd).astype(np_dtype)
    table = rng.permutation(np.arange(1, nb))[:lanes * MB].reshape(lanes, MB).astype(np.int32)
    q = rng.randn(lanes, H, hd).astype(np_dtype)
    return q, pk, pv, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("np_dtype,hd,bs", [
    (np.float32, 320, 16), (np.float32, 512, 8), (np.float16, 320, 16),
    (np.float32, 64, 512), (np.float16, 128, 512), (np.float32, 520, 300),
    (np.float16, 512, 16), (np.float16, 520, 8), (np.float32, 1024, 16),
    (np.float16, 1024, 8), (np.float32, 128, 300), (np.float16, 64, 300),
    (np.float16, 320, 512), (np.float32, 256, 512),
])
def test_paged_past_256_matches_the_composed_reference(np_dtype, hd, bs):
    """The plain version (the wrapper on CPU tensors) and the wide mode's
    emulation at three grids against the reference's composed path; the
    mode is ``wide`` for every shape here."""
    cap = 3 * bs
    q, pk, pv, table, ln = _paged_case(np_dtype, hd, bs, [0, 7, cap // 2, cap - 1], hd + bs)
    kc = ref_pa.gather_lane_window(jnp.asarray(pk), jnp.asarray(table))
    vc = ref_pa.gather_lane_window(jnp.asarray(pv), jnp.asarray(table))
    vis = jnp.arange(cap)[None, :] <= jnp.asarray(ln)[:, None]
    want = np.asarray(masked_attend(jnp.asarray(q), kc, vc, vis).astype(jnp.float32))
    args = [torch.from_numpy(a) for a in (q, pk, pv, table, ln)]
    got = pa.paged_decode_attention(*args)
    assert got.dtype == args[0].dtype
    tol = PAGED_TOL[np_dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    for grid in (264, 37, 1):
        got = pa.paged_decode_attention_split(*args, grid)
        assert got.dtype == args[0].dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    assert pa.mode(hd, bs) == "wide"


def test_chunk_plan_covers_the_padded_head_dim():
    """At every head dim the wide route takes (264 to 1024 in steps of 8):
    the chunks are whole 64-column boxes of at most 256 columns, in one or
    two widths a box apart, widest first, covering Dp = 64 ceil(D / 64)
    exactly; there are ceil(Dp / 256) of them (the count the kernels' cost
    note gives: (c + 1) / 2 and (5 c + 3) / 5 of the FLOP bounds)."""
    for D in range(264, fa.MAX_WIDE_HEAD_DIM + 1, 8):
        plan = fa.chunk_plan(D)
        dp = 64 * -(-D // 64)
        assert all(c % 64 == 0 and 0 < c <= fa.MAX_CHUNK for c in plan), (D, plan)
        assert sum(plan) == dp and len(plan) == -(-dp // 256), (D, plan)
        assert list(plan) == sorted(plan, reverse=True) and plan[0] - plan[-1] <= 64, (D, plan)
    assert fa.chunk_plan(320) == (192, 128) and fa.chunk_plan(1024) == (256,) * 4
    assert fa.chunk_plan(576) == (192,) * 3 and fa.chunk_plan(640) == (256, 192, 192)
