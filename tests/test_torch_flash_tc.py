"""PyTorch port: flash attention's tensor-core routes for f32 and for head
dims other than 64 and 128, on the CPU.

On the card every flash call runs a wgmma kernel of
``csrc/flash_attention.cu`` by one of three routes (``fa.route``): bf16
and fp16 at head_dim 64 or 128 as they are, the other head dims that are
multiples of 8 zero-padded to the next multiple of 64, and f32 as two bf16
pieces an operand, each product taken as three piece products. Here, with
numpy inputs shared with the reference:

- the f32 route's arithmetic, emulated on the CPU
  (``fa.flash_attention_fwd_split`` / ``fa.flash_attention_bwd_split``),
  forward and gradients against the reference's composed ``_sdpa_ref``
  under ``jax.grad``, with GQA, sq != sk and rows that see no key, and a
  control: the same products without the low pieces must fail the limit;
- a tiny f32 Llama (``LlamaConfig.tiny()``, head_dim 32) with its flash
  op on that emulation, loss and every gradient against the reference;
- the padded route's rule: the plain version on operands zero-padded to
  64 columns equals the unpadded one at head dims 8, 40, 96 and 200;
- the router, on stand-ins for CUDA tensors: every (dtype, head_dim) the
  check accepts goes to a tensor-core route.

Tolerances, stated where used: the split keeps 16 significant bits of each
operand (x = h + l, h = bf16(x), l = bf16(x - h)), about 2^-17 relative a
product; through softmax and the backward's dS that reads 6e-6 to 1.4e-5
of a tile's norm, so the emulation is held to F32_SPLIT_TILE_RTOL = 2e-5
of each 64-row tile's norm (``fa.tile_errors``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref
from paddle_tpu.nn.functional.attention import _sdpa_ref
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.ops import flash_attention as fa

F32_SPLIT_TILE_RTOL = 2e-5
TILE, FLOOR = 64, 1e-5
# bf16 rounding alone (one piece) reads about 3e-3 of a tile: the control
# must exceed this
CONTROL_MIN = 1e-4
# tiny Llama on the emulated route: f32 sums in another order and the
# split's 2^-17 through 2 layers: the loss within 1e-5 relative, every
# gradient within 2e-4 of its tensor's largest entry (as the f32 Llama
# training tests hold the plain path)
LOSS_RTOL, GRAD_FRAC = 1e-5, 2e-4


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


def _split_route(q, k, v, do, causal):
    """The emulated f32 route: forward, then the backward on its own lse
    and delta = rowsum(dO * O), as the autograd op calls them."""
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd_split(q, k, v, causal)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    return out, fa.flash_attention_bwd_split(q, k, v, do, lse, delta, causal)


def _tile_errors(got, want):
    out, grads = got
    out_r, grads_r = want
    return [fa.tile_errors(a, torch.from_numpy(b), TILE, FLOOR)[0]
            for a, b in zip((out, *grads), (out_r, *grads_r))]


@pytest.mark.parametrize("B,sq,sk,H,Hk,D,causal", [
    (1, 128, 128, 4, 1, 128, True),       # GQA 4, the training case
    (2, 96, 160, 4, 2, 64, True),         # more keys than queries
    (1, 160, 64, 2, 2, 96, True),         # 96 rows that see no key
    (1, 70, 33, 4, 2, 32, False),         # head_dim 32, ragged
])
def test_f32_split_matches_the_composed_reference(B, sq, sk, H, Hk, D, causal):
    q, k, v, do = _draw(sq + sk + D, B, sq, sk, H, Hk, D)
    errs = _tile_errors(_split_route(q, k, v, do, causal), _reference(q, k, v, do, causal))
    assert max(errs) <= F32_SPLIT_TILE_RTOL, errs


def test_f32_split_without_low_pieces_fails_the_limit(monkeypatch):
    """The control: products of the high pieces alone (bf16 operands) read
    far above the limit, so the limit holds a kernel that drops them."""
    monkeypatch.setattr(fa, "split2", lambda x: (x.to(torch.bfloat16).float(),
                                                 torch.zeros_like(x, dtype=torch.float32)))
    q, k, v, do = _draw(7, 1, 128, 128, 4, 1, 128)
    errs = _tile_errors(_split_route(q, k, v, do, True), _reference(q, k, v, do, True))
    assert min(errs) > CONTROL_MIN, errs


def test_tiny_f32_llama_on_the_split_route_matches_the_reference(monkeypatch):
    """The slice as a whole: LlamaConfig.tiny() in f32 (head_dim 32, GQA 2),
    its flash op on the f32 route's emulation, loss and every gradient
    against the reference model on the same weights and tokens."""
    monkeypatch.setattr(fa, "flash_attention_fwd", fa.flash_attention_fwd_split)
    monkeypatch.setattr(fa, "flash_attention_bwd", fa.flash_attention_bwd_split)
    paddle.seed(5)
    cfg = ref.LlamaConfig.tiny()
    model = ref.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    rng = np.random.RandomState(5)
    ids, labels = (rng.randint(0, cfg.vocab_size, (2, 96)).astype(np.int64) for _ in "il")
    loss_r, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    want = {n: p.grad.numpy() for n, p in model.named_parameters()}
    loss, _ = pmodel(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_r.numpy()), rtol=LOSS_RTOL)
    got = {n: p.grad.numpy() for n, p in pmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= GRAD_FRAC * np.abs(w).max(), n


@pytest.mark.parametrize("D", [8, 40, 96, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_operands_give_the_unpadded_result(D, dtype):
    """The padded route's rule: zero columns up to the next multiple of 64
    change no score and no product, so the plain version on the padded
    operands, with the true head_dim's scale, gives the unpadded output,
    lse and gradients in the first D columns and zeros past them. Both
    sides sum the same f32 products in another order: 1e-6 in f32, one
    rounding step of the type in bf16."""
    Dp = -(-D // 64) * 64
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _draw(D, 1, 96, 80, 4, 2, D))

    def pad(t):
        return torch.nn.functional.pad(t, (0, Dp - D))

    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd_ref(q, k, v, True, scale)
    out_p, lse_p = fa.flash_attention_fwd_ref(pad(q), pad(k), pad(v), True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, True, scale)
    grads_p = fa.flash_attention_bwd_ref(pad(q), pad(k), pad(v), pad(do), lse, delta, True,
                                         scale)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    for got, want in zip((out_p, *grads_p), (out, *grads)):
        torch.testing.assert_close(got[..., :D].float(), want.float(), **tol)
        assert not got[..., D:].any()


class _CudaLike:
    """What the wrappers read of a CUDA tensor: device, dtype, shape,
    strides and a 16-byte aligned address."""

    def __init__(self, dtype, shape):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, torch.Size(shape)
        self._strides = torch.empty(shape, device="meta").stride()

    def dim(self):
        return len(self.shape)

    def stride(self, i=None):
        return self._strides if i is None else self._strides[i]

    def data_ptr(self):
        return 1 << 20


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_router_sends_every_accepted_call_to_a_tensor_core_route(dtype):
    """Every head_dim up to 256 has a tensor-core route: f32 the split,
    bf16/fp16 unpadded at 64 and 128 and padded elsewhere; past 256, up to
    1024, the wide route, every dtype; the check refuses the rest (not multiples of 8,
    past 1024), so no call is left without a kernel."""
    for D in range(8, fa.MAX_HEAD_DIM + 1, 8):
        q = _CudaLike(dtype, (2, 33, 8, D))
        kv = _CudaLike(dtype, (2, 70, 2, D))
        fa._check("flash_attention_fwd", q, kv, kv)
        fa._check("flash_attention_bwd", q, kv, kv, q)
        want = ("f32" if dtype == torch.float32 else
                "wgmma" if D in fa.HEAD_DIMS else "padded")
        assert fa.route(q) == want
    for D in (264, 320, 512, 1024):
        q = _CudaLike(dtype, (2, 33, 8, D))
        fa._check("flash_attention_fwd", q, q, q)
        assert fa.route(q) == "wide"
    for D in (4, 12, 100, 1032):
        q = _CudaLike(dtype, (2, 33, 8, D))
        with pytest.raises(ValueError):
            fa._check("flash_attention_fwd", q, q, q)
