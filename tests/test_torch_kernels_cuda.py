"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90a) with nvcc; without one they skip.
Run them on the card with::

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

They cover shapes chip_smoke.py does not: other block sizes, head dims
and GQA ratios, f32 attention, ragged M and odd K/N for the GEMM, flash
attention at GQA ratios 1/4/8, head_dim 64 and 128, ragged S, causal or
not, fp16, and its determinism, RMSNorm at ragged N and several H, the
int8 GEMM's tensor-core forward and dX at ragged M, around the M = 64
switch and at the smallest K and N, dX's determinism, SwiGLU at odd sizes,
and the checks that refuse what a kernel does not take.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.nn import quant as nq

pytestmark = pytest.mark.cuda

# attention: the plain version rounds probabilities to q's dtype before the
# weighted sum, the kernel keeps f32; outputs mix N(0, 1) rows.
ATTN_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# GEMM: the same f32 sum in another order, rounded once to bf16.
GEMM_RTOL, GEMM_ATOL_FRAC = 2.0 ** -7, 1e-3
# flash attention, kernel vs plain on the same bf16/fp16 inputs, held tile
# by tile (fa.tile_errors): over each 64 rows of one (batch, head),
# ||got - want|| <= FLASH_TILE_RTOL (||want|| + FLASH_TILE_FLOOR sqrt(n))
# for the tile's n elements. The limit scales with each tile's own norm, so
# that an error confined to the late K tiles, the diagonal or the ragged
# tail fails as surely as one in the first tiles; the floor (an RMS of
# 1e-5) only matters where a tile is f32 rounding noise (dQ of a single
# row). The forward rounds the probabilities to the input type on both
# sides (the kernel against its running row maximum, the plain version
# against the row's maximum) and the output once: about 3e-3 of a tile's
# norm. The backward takes the kernel forward's lse and delta on both
# sides: P and dS round at the same places from f32 values that differ by
# summation order, then the results round once: about 1e-3. lse is f32 on
# both sides.
FLASH_TILE_RTOL, FLASH_TILE_FLOOR, FLASH_LSE_ATOL, FLASH_TILE = 1e-2, 1e-5, 1e-3, 64
# RMSNorm: the same f32 arithmetic summed in another order, one rounding to
# the storage type: one step of that type plus 1e-3 of the largest output.
NORM_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
NORM_ATOL_FRAC = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _attention_case(dev, lengths, H, Hk, hd, bs, MB, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lanes = len(lengths)
    nb = 1 + lanes * MB
    pk = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    pv = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[:lanes * MB] + 1)
    table = table.reshape(lanes, MB).int().contiguous()
    table[0] = 0                                     # lane 0: trash block only
    for b, n in enumerate(lengths):                  # poison every hidden slot
        for s in range(n + 1, MB * bs):
            pk[table[b, s // bs], s % bs] = 1e4
            pv[table[b, s // bs], s % bs] = 1e4
    q = torch.randn((lanes, H, hd), generator=g, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, table, ln


@pytest.mark.parametrize("H,Hk,hd,bs,MB,dtype", [
    (32, 8, 128, 16, 64, torch.bfloat16),
    (8, 2, 64, 4, 9, torch.float32),
    (4, 4, 256, 8, 6, torch.bfloat16),
    (16, 2, 32, 32, 3, torch.bfloat16),
])
def test_paged_attention_matches_plain(dev, H, Hk, hd, bs, MB, dtype):
    cap = MB * bs
    lengths = [0, 1, bs - 1, bs, cap // 2 + 3, cap - 1]
    q, pk, pv, table, ln = _attention_case(dev, lengths, H, Hk, hd, bs, MB, dtype,
                                           seed=hd + bs)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, pk, pv, table, ln)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    want = pa.paged_decode_attention_ref(q, pk, pv, table, ln)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_ATOL[dtype], err


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 13, 16, 33, 64])
@pytest.mark.parametrize("K,N", [(32, 16), (272, 400), (4096, 1024), (1024, 4096)])
def test_int8_matmul_matches_plain(dev, M, K, N):
    g = torch.Generator(device=dev)
    g.manual_seed(M * 31 + K + N)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=dev) * 0.02 + 1e-3
    before = qm.int8_matmul.launches
    got = qm.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 1
    want = qm.int8_matmul_ref(x, w, s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    diff = (got.float() - want.float()).abs()
    tol = GEMM_RTOL * want.float().abs() + GEMM_ATOL_FRAC * want.float().abs().max()
    assert bool((diff <= tol).all()), diff.max().item()


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros((4, 32), device=dev)
    w = torch.zeros((32, 16), dtype=torch.int8, device=dev)
    s = torch.ones((16,), device=dev)
    with pytest.raises(TypeError):
        qm.int8_matmul(x, w, s)                     # f32 activations
    with pytest.raises(ValueError):
        qm.int8_matmul(x.bfloat16(), w[:24], s)     # K mismatch
    q = torch.zeros((2, 4, 48), dtype=torch.bfloat16, device=dev)
    pages = torch.zeros((3, 4, 2, 48), dtype=torch.bfloat16, device=dev)
    table = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pages, pages, table,
                                  torch.zeros((2,), dtype=torch.int32, device=dev))


def test_engine_launches_both_kernels(dev):
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256, intermediate_size=512,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=1)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, n).tolist() for n in (3, 20, 1, 40, 7)]
    tokens = {}
    for wd in ("bf16", "int8"):
        eng = ServingEngine(model, ServeConfig(num_lanes=2, block_size=16,
                                               max_seq_len=64, weight_dtype=wd))
        a0, g0 = pa.paged_decode_attention.launches, qm.int8_matmul.launches
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        assert all(r.status == "done" and len(r.generated) == 6 for r in reqs)
        assert pa.paged_decode_attention.launches > a0
        assert (qm.int8_matmul.launches > g0) == (wd == "int8")
        tokens[wd] = [r.generated for r in reqs]
    assert tokens["bf16"] != [] and tokens["int8"] != []


def _flash_inputs(dev, B, S, H, Hk, hd, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hk, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hk, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    return q, k, v, do


def _assert_tiles_close(got, want):
    worst, _ = fa.tile_errors(got, want, FLASH_TILE, FLASH_TILE_FLOOR)
    assert worst <= FLASH_TILE_RTOL, worst


@pytest.mark.parametrize("B,S,H,Hk,hd,causal,dtype", [
    (1, 256, 8, 8, 128, True, torch.bfloat16),      # GQA ratio 1
    (2, 200, 8, 2, 128, True, torch.bfloat16),      # ratio 4, ragged S
    (1, 333, 16, 2, 64, False, torch.bfloat16),     # ratio 8, hd 64, not causal
    (1, 64, 16, 8, 64, True, torch.bfloat16),       # one tile
    (1, 129, 4, 1, 128, False, torch.float16),      # fp16, MQA, ragged
    (1, 1, 2, 1, 64, True, torch.bfloat16),         # a single row
])
def test_flash_attention_matches_plain(dev, B, S, H, Hk, hd, causal, dtype):
    q, k, v, do = _flash_inputs(dev, B, S, H, Hk, hd, dtype, seed=S + H + hd)
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == f0 + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (B, H, S)
    _assert_tiles_close(out, ref_out)
    assert (lse - ref_lse).abs().max().item() <= FLASH_LSE_ATOL
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == b0 + 1
    for g_, w_, t in zip(got, want, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        _assert_tiles_close(g_, w_)


def test_flash_attention_autograd_and_determinism(dev):
    q, k, v, do = _flash_inputs(dev, 1, 300, 8, 2, 128, torch.bfloat16, seed=3)
    grads = []
    for _ in range(2):
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention(qs, ks, vs, causal=True)
        out.backward(do)
        grads.append((out.detach(), qs.grad, ks.grad, vs.grad))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # through the gate: f32 and sq != sk stay composed (None)
    assert fa.flash_attention_bsnd(q.float(), k.float(), v.float(), True) is None
    assert fa.flash_attention_bsnd(q[:, :10], k, v, False) is None
    out = fa.flash_attention_bsnd(q, k, v, True)
    assert torch.equal(out, grads[0][0])


def test_flash_attention_refuses(dev):
    q, k, v, _ = _flash_inputs(dev, 1, 64, 4, 2, 96, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v, True)
    q, k, v, _ = _flash_inputs(dev, 1, 64, 4, 2, 64, torch.bfloat16, seed=1)
    padded = torch.zeros((1, 64, 4, 68), dtype=torch.bfloat16, device=dev)[..., :64]
    padded.copy_(q)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd(padded, k, v, True)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), k, v, True)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.float(), k.float(), v.float(), True)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q[:, :, :3], k, v, True)


@pytest.mark.parametrize("N,H,dtype", [
    (8192, 4096, torch.bfloat16), (37, 4096, torch.bfloat16), (1000, 1024, torch.bfloat16),
    (5, 1024, torch.float32), (3, 1001, torch.bfloat16), (1, 4096, torch.float16),
])
def test_rms_norm_matches_plain(dev, N, H, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(N + H)
    x = (torch.randn((N, H), generator=g, device=dev) * 3).to(dtype)
    w = torch.rand((H,), generator=g, device=dev).to(dtype) + 0.5
    do = torch.randn((N, H), generator=g, device=dev).to(dtype)
    f0, b0 = fn.rms_norm_fwd.launches, fn.rms_norm_bwd_dx.launches
    out, inv = fn.rms_norm_fwd(x, w, 1e-6)
    ref_out, ref_inv = fn.rms_norm_fwd_ref(x, w, 1e-6)
    dx = fn.rms_norm_bwd_dx(x, w, inv, do)
    ref_dx = fn.rms_norm_bwd_dx_ref(x, w, ref_inv, do)
    torch.cuda.synchronize()
    assert fn.rms_norm_fwd.launches == f0 + 1 and fn.rms_norm_bwd_dx.launches == b0 + 1
    rtol = NORM_RTOL.get(dtype, 2.0 ** -10)
    for got, want in ((out, ref_out), (dx, ref_dx)):
        assert got.dtype == dtype and got.shape == x.shape
        diff = (got.float() - want.float()).abs()
        tol = rtol * want.float().abs() + NORM_ATOL_FRAC * want.float().abs().max()
        assert bool((diff <= tol).all()), diff.max().item()
    assert torch.allclose(inv, ref_inv, rtol=1e-5, atol=0)


def test_rms_norm_autograd_and_refusal(dev):
    x = torch.randn((64, 256), device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones((256,), device=dev, dtype=torch.bfloat16, requires_grad=True)
    fn.rms_norm_2d(x, w, 1e-6).float().square().sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with pytest.raises(ValueError):
        fn.rms_norm_fwd(x.detach()[:, ::2], w.detach()[:128], 1e-6)  # strided
    with pytest.raises(TypeError):
        fn.rms_norm_fwd(x.detach(), w.detach().float(), 1e-6)


def _gemm_inputs(dev, M, K, N, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    dout = torch.randn((M, N), generator=g, device=dev).bfloat16()
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=dev) * 0.02 + 1e-3
    return x, dout, w, s


def _assert_gemm_close(got, want):
    diff = (got.float() - want.float()).abs()
    tol = GEMM_RTOL * want.float().abs() + GEMM_ATOL_FRAC * want.float().abs().max()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.parametrize("M", [1, 63, 64, 65, 127, 129, 1000])
@pytest.mark.parametrize("K,N", [(16, 16), (272, 400), (4096, 1024), (1024, 4096)])
def test_int8_large_m_forward_and_dx_match_plain(dev, M, K, N):
    """M > 64 takes the tensor-core forward and M <= 64 the weight stream;
    dX takes any M. Each counts its own launches."""
    x, dout, w, s = _gemm_inputs(dev, M, K, N, seed=M * 7 + K + N)
    f0, l0, d0 = qm.int8_matmul.launches, qm.int8_matmul_large_m.launches, \
        qm.int8_matmul_dx.launches
    out = qm.int8_matmul(x, w, s)
    dx = qm.int8_matmul_dx(dout, w, s)
    torch.cuda.synchronize()
    large = M > qm.LARGE_M
    assert qm.int8_matmul.launches == f0 + (not large)
    assert qm.int8_matmul_large_m.launches == l0 + large
    assert qm.int8_matmul_dx.launches == d0 + 1
    assert out.shape == (M, N) and dx.shape == (M, K) and dx.dtype == torch.bfloat16
    _assert_gemm_close(out, qm.int8_matmul_ref(x, w, s))
    _assert_gemm_close(dx, qm.int8_matmul_dx_ref(dout, w, s))
    _assert_gemm_close(qm.int8_matmul_large_m(x, w, s), qm.int8_matmul_ref(x, w, s))


def test_int8_dx_is_deterministic_and_the_ops_differentiate(dev):
    x, dout, w, s = _gemm_inputs(dev, 300, 512, 768, seed=5)
    a, b = qm.int8_matmul_dx(dout, w, s), qm.int8_matmul_dx(dout, w, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    xs = x.clone().requires_grad_(True)
    qm.int8_matmul_frozen(xs, w, s).backward(dout)
    assert torch.equal(xs.grad, a)
    # a QuantizedLinear over a 3-D bf16 input: forward and dx through the kernels
    lin = torch.nn.Module()
    lin.weight, lin.bias = torch.randn((512, 768), device=dev), None
    ql = nq.QuantizedLinear(lin)
    x3 = torch.randn((2, 150, 512), device=dev).bfloat16().requires_grad_(True)
    l0, d0 = qm.int8_matmul_large_m.launches, qm.int8_matmul_dx.launches
    ql(x3).float().sum().backward()
    torch.cuda.synchronize()
    assert qm.int8_matmul_large_m.launches == l0 + 1 and qm.int8_matmul_dx.launches == d0 + 1
    assert x3.grad.shape == x3.shape


def test_int8_kernels_refuse(dev):
    x, dout, w, s = _gemm_inputs(dev, 100, 64, 48, seed=1)
    with pytest.raises(TypeError):
        qm.int8_matmul(x.float(), w, s)                 # f32 activations, large M
    with pytest.raises(TypeError):
        qm.int8_matmul_dx(dout.float(), w, s)
    with pytest.raises(ValueError, match="multiples of 16"):
        qm.int8_matmul(x[:, :40].contiguous(), w[:40], s)
    with pytest.raises(ValueError, match="multiples of 16"):
        qm.int8_matmul_dx(dout[:, :40].contiguous(), w[:, :40].contiguous(), s[:40])
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul(torch.zeros((64, 100), dtype=torch.bfloat16, device=dev).t(), w, s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul_dx(torch.zeros((48, 100), dtype=torch.bfloat16, device=dev).t(), w, s)
    with pytest.raises(ValueError):
        qm.int8_matmul_dx(x, w, s)                      # x [M, K] is not dout [M, N]


@pytest.mark.parametrize("N,H,dtype", [
    (8192, 14336, torch.bfloat16), (37, 1001, torch.bfloat16), (1, 7, torch.bfloat16),
    (5, 33, torch.float32), (3, 129, torch.float16),
])
def test_swiglu_matches_plain(dev, N, H, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(N + H)
    a = (torch.randn((N, H), generator=g, device=dev) * 3).to(dtype)
    b = torch.randn((N, H), generator=g, device=dev).to(dtype)
    do = torch.randn((N, H), generator=g, device=dev).to(dtype)
    f0, b0 = fn.swiglu_fwd.launches, fn.swiglu_bwd.launches
    out = fn.swiglu_fwd(a, b)
    da, db = fn.swiglu_bwd(a, b, do)
    torch.cuda.synchronize()
    assert fn.swiglu_fwd.launches == f0 + 1 and fn.swiglu_bwd.launches == b0 + 1
    # the same f32 formula, one rounding each side: one step of the type
    rtol = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 1e-5}[dtype]
    for got, want in ((out, fn.swiglu_fwd_ref(a, b)), *zip((da, db), fn.swiglu_bwd_ref(a, b, do))):
        assert got.dtype == dtype and got.shape == a.shape
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= rtol * want.float().abs() + 1e-6).all()), diff.max().item()


def test_swiglu_autograd_and_refusal(dev):
    a = torch.randn((64, 256), device=dev, dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn((64, 256), device=dev, dtype=torch.bfloat16, requires_grad=True)
    fn.swiglu_2d(a, b).float().sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    with pytest.raises(ValueError):
        fn.swiglu_fwd(a.detach()[:, ::2], b.detach()[:, ::2])      # strided
    with pytest.raises(ValueError):
        fn.swiglu_fwd(a.detach(), b.detach().float())
    with pytest.raises(TypeError):
        fn.swiglu_fwd(a.detach().to(torch.int32), b.detach().to(torch.int32))
