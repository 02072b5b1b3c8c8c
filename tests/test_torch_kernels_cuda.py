"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90a) with nvcc; without one they skip.
Run them on the card with::

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

They cover shapes chip_smoke.py does not: paged attention at other page
sizes (5 to 512 slots, 300 among them), head dims (6 to 1024, the wide
mode past 256) and GQA ratios (1 to 12 heads a KV head), in bf16, fp16
and f32, with every hidden slot holding NaN or Inf, its determinism, a
captured CUDA graph replayed after the lengths and the block table
change, and one kernel a call; ragged M and
odd K/N for the GEMM, flash
attention at GQA ratios 1/4/8, head_dim 64 and 128, S below, at and just
past its 64- and 128-row tiles and ragged, causal or not, B 2, q/k/v as
head-slices of one fused tensor, fp16, and its determinism, flash with
sq != sk (bottom-right causal, rows that see no key), f32 and head dims
other than 64 and 128 (the f32 route's two bf16 pieces and the padded
route, at every head dim from 8 to 256 by route), and the functional gate sending
those to the kernels and never to the composed path, RMSNorm at ragged N
and several H, the int8 GEMM's tensor-core forward and dX at ragged M,
around the M = 64 switch and at the smallest K and N, dX's determinism,
f32 activations on all three int8 kernels (the weight stream, and the
split into three bf16 pieces), SwiGLU at odd sizes, the ring's lse merge
in bf16, fp16 and f32 at head_dim 8 to 256, small rings against the full
flash kernel (bf16, and f32 and ragged shards through the gate), and the
checks that refuse
what a kernel does not take.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops import ring_flash as rf
from paddle_tpu_torch.nn import quant as nq

pytestmark = pytest.mark.cuda

# attention: the plain version rounds probabilities to q's dtype before the
# weighted sum, the kernel keeps f32; outputs mix N(0, 1) rows (|out| < 5),
# so one rounding of each gives under 2e-2 in bf16 (2^-8 relative), under
# 5e-3 in fp16 (2^-11); in f32 the same products sum in another order.
ATTN_ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-5}
# GEMM: the same f32 sum in another order, rounded once to bf16.
GEMM_RTOL, GEMM_ATOL_FRAC = 2.0 ** -7, 1e-3
# GEMM in f32: the same exact products (the f32 split's three bf16 pieces on
# both sides) summed in f32 in another order, no rounding after: 1e-5
# relative plus 1e-5 of the largest output (an f32 sum over K <= 4096 of
# partial sums up to the largest carries ~sqrt(K) ulps of it). The tensor
# cores add each 16-deep partial product into the f32 accumulator
# truncated, up to one ulp of the running sum per step, all of one sign:
# their kernel is held to one ulp (2^-23) of the largest output per step of
# its 3 R / 16 steps (R the reduction length) where that is larger, as
# chip_smoke.py holds it.
GEMM_F32_RTOL, GEMM_F32_ATOL_FRAC = 1e-5, 1e-5
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
# f32 flash takes each operand as two bf16 pieces (16 significant bits) and
# each product as three piece products: about 2^-17 relative a product, 1e-5
# to 2e-5 of a tile's norm on the H100. Operands rounded to TF32 would read
# about 4e-4, to bf16 about 3e-3: f32 is held to 1e-4, as chip_smoke.py
# holds it.
FLASH_F32_TILE_RTOL = 1e-4
# RMSNorm: the same f32 arithmetic summed in another order, one rounding to
# the storage type: one step of that type plus 1e-3 of the largest output.
NORM_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
NORM_ATOL_FRAC = 1e-3
# the round_first forward's bits may differ from its plain version's on at
# most this share of the elements (another summation order moves inv-rms by
# an f32 ulp or two, which flips a rounding on about 2^-15 of them); the
# plain fused version, held the same way, must fail (the roundings differ on
# about a quarter of the elements in bf16 and fp16)
ROUND_MISMATCH_MAX = 1e-3
# the ring's merge: the same f32 formula on both sides, each product and sum
# rounded alone; exp and log of two math libraries may differ by a few ulps.
MERGE_RTOL, MERGE_ATOL = 1e-5, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _attention_case(dev, lengths, H, Hk, hd, bs, MB, dtype, seed):
    """Inputs, and a copy of the pools whose slots no lane sees hold NaN,
    +Inf and -Inf in turn (the plain version's 0 * NaN would be NaN, so it
    runs on the pools with those slots at 1e4)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lanes = len(lengths)
    nb = 1 + lanes * MB
    pk = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    pv = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[:lanes * MB] + 1)
    table = table.reshape(lanes, MB).int().contiguous()
    table[0] = 0                                     # lane 0: trash block only
    hidden = torch.ones((nb, bs), dtype=torch.bool, device=dev)
    for b, n in enumerate(lengths):
        s = torch.arange(min(n + 1, MB * bs), device=dev)
        hidden[table[b].long()[s // bs], s % bs] = False
    pk[hidden], pv[hidden] = 1e4, 1e4
    bad = torch.tensor([float("nan"), float("inf"), float("-inf")], device=dev).to(dtype)
    fill = bad[torch.arange(nb * bs, device=dev) % 3].reshape(nb, bs, 1, 1)
    pk_bad, pv_bad = (torch.where(hidden[:, :, None, None], fill, p) for p in (pk, pv))
    q = torch.randn((lanes, H, hd), generator=g, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, table, ln, pk_bad.contiguous(), pv_bad.contiguous()


@pytest.mark.parametrize("H,Hk,hd,bs,MB,dtype", [
    (32, 8, 128, 16, 64, torch.bfloat16),
    (32, 8, 128, 16, 64, torch.float16),
    (32, 8, 128, 16, 64, torch.float32),
    (8, 2, 64, 4, 9, torch.float32),
    (4, 4, 256, 8, 6, torch.bfloat16),
    (16, 2, 32, 32, 3, torch.bfloat16),
    (32, 8, 80, 32, 8, torch.bfloat16),
    (32, 8, 96, 16, 10, torch.float16),
    (16, 4, 256, 8, 12, torch.float32),
    (24, 2, 128, 16, 7, torch.bfloat16),             # 12 heads a KV head: two passes
    (6, 2, 8, 256, 2, torch.bfloat16),               # the smallest head dim, the largest page
    (20, 4, 40, 5, 13, torch.float16),               # 5 heads a KV head, pages of 5 slots
    # rows that are no multiple of 16 bytes: no tensor map, the warp copies
    (32, 8, 20, 16, 10, torch.bfloat16),
    (32, 8, 100, 8, 12, torch.float16),
    (32, 8, 6, 16, 10, torch.float32),
    (8, 2, 7, 4, 9, torch.bfloat16),                 # an odd head dim: 2-byte copies
])
def test_paged_attention_matches_plain(dev, H, Hk, hd, bs, MB, dtype):
    cap = MB * bs
    lengths = [0, 1, bs - 1, bs, cap // 2 + 3, cap - 1]
    q, pk, pv, table, ln, pk_bad, pv_bad = _attention_case(dev, lengths, H, Hk, hd, bs, MB,
                                                           dtype, seed=hd + bs)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, pk_bad, pv_bad, table, ln)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    want = pa.paged_decode_attention_ref(q, pk, pv, table, ln)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_ATOL[dtype], err


def test_paged_attention_is_deterministic_and_graph_capturable(dev):
    """Two calls agree bit for bit (partials merge in split order); a
    captured call replayed after lengths and the block table change in
    place on the device gives the plain version's answer."""
    q, pk, pv, table, ln, _, _ = _attention_case(dev, [1023] * 8, 32, 8, 128, 16, 64,
                                                 torch.bfloat16, seed=5)
    first = pa.paged_decode_attention(q, pk, pv, table, ln)
    assert torch.equal(first, pa.paged_decode_attention(q, pk, pv, table, ln))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_decode_attention(q, pk, pv, table, ln)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_decode_attention(q, pk, pv, table, ln)
    for lengths in ([0, 1, 17, 250, 511, 700, 1000, 1023], [1023] + [31] * 7):
        ln.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
        table.copy_(table.roll(1, 0))
        graph.replay()
        want = pa.paged_decode_attention_ref(q, pk, pv, table, ln)
        assert (out.float() - want.float()).abs().max().item() <= ATTN_ATOL[torch.bfloat16]


def test_paged_attention_is_one_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    q, pk, pv, table, ln, _, _ = _attention_case(dev, [3, 700, 31, 1023], 32, 8, 128, 16, 64,
                                                 torch.bfloat16, seed=6)
    pa.paged_decode_attention(q, pk, pv, table, ln)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pa.paged_decode_attention(q, pk, pv, table, ln)
        torch.cuda.synchronize()
    ran = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ran) == 1 and "paged_decode_kernel" in ran[0], ran


# the weight stream's shapes: Llama-3-8B's projections and head, the
# smallest K and N, and a K that ends a quarter into a 64-row stage
STREAM_SHAPES = [(16, 16), (4112, 400), (4096, 4096), (4096, 1024), (4096, 14336),
                 (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("M", [1, 2, 3, 8, 9, 16, 33, 63, 64])
@pytest.mark.parametrize("K,N", STREAM_SHAPES)
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
        qm.int8_matmul_dx(x.half()[:, :16], w, s)   # fp16 dO: dX takes bf16 or f32
    with pytest.raises(ValueError):
        qm.int8_matmul(x.bfloat16(), w[:24], s)     # K mismatch
    q = torch.zeros((2, 4, 1032), dtype=torch.bfloat16, device=dev)    # head_dim past 1024
    pages = torch.zeros((3, 4, 2, 1032), dtype=torch.bfloat16, device=dev)
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


def _flash_inputs(dev, B, S, H, Hk, hd, dtype, seed, fused=False):
    """q, k, v, dO; with ``fused``, q, k and v are head-slices of one
    [B, S, H + 2 Hk, hd] tensor, so the kernels' tensor maps see row
    strides that are not the packed ones."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if fused:
        qkv = torch.randn((B, S, H + 2 * Hk, hd), generator=g, device=dev).to(dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hk], qkv[:, :, H + Hk:]
    else:
        q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, Hk, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, Hk, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    return q, k, v, do


def _flash_launches():
    """(forward, backward) flash launches over every route."""
    return (sum(fa.flash_attention_fwd.by_route.values()),
            sum(fa.flash_attention_bwd.by_route.values()))


def _assert_tiles_close(got, want):
    worst, _ = fa.tile_errors(got, want, FLASH_TILE, FLASH_TILE_FLOOR)
    assert worst <= (FLASH_F32_TILE_RTOL if want.dtype == torch.float32 else FLASH_TILE_RTOL), \
        worst


BF16, FP16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("B,S,H,Hk,hd,causal,dtype,fused", [
    (1, 256, 8, 8, 128, True, BF16, False),      # GQA ratio 1
    (2, 200, 8, 2, 128, True, BF16, False),      # ratio 4, ragged S
    (1, 333, 16, 2, 64, False, BF16, False),     # ratio 8, hd 64, not causal
    (1, 64, 16, 8, 64, True, BF16, False),       # one tile
    (1, 129, 4, 1, 128, False, FP16, False),     # fp16, MQA, ragged
    (1, 1, 2, 1, 64, True, BF16, False),         # a single row
    # the edges of the 128-row and 64-row tiles, causal and not
    (1, 1, 4, 2, 128, False, BF16, False),
    (1, 63, 4, 2, 128, True, BF16, False),
    (1, 63, 4, 2, 128, False, BF16, False),
    (1, 127, 8, 2, 128, True, BF16, False),
    (1, 127, 8, 2, 64, False, BF16, False),
    (1, 129, 8, 2, 128, True, BF16, False),
    (1, 129, 8, 2, 64, False, BF16, False),
    (1, 1000, 8, 2, 128, True, BF16, False),
    (1, 1000, 8, 2, 128, False, BF16, False),
    # two sequences: a ragged S must not read the next one's rows
    (2, 1000, 8, 4, 64, True, BF16, False),
    (2, 127, 4, 2, 128, False, BF16, False),
    # head-slices of one fused qkv tensor
    (1, 300, 8, 2, 128, True, BF16, True),
    (2, 129, 4, 4, 64, False, BF16, True),
    # fp16 at head_dim 64
    (1, 1000, 8, 2, 64, True, FP16, False),
    (2, 63, 4, 1, 64, False, FP16, False),
])
def test_flash_attention_matches_plain(dev, B, S, H, Hk, hd, causal, dtype, fused):
    q, k, v, do = _flash_inputs(dev, B, S, H, Hk, hd, dtype, seed=S + H + hd, fused=fused)
    f0, b0 = _flash_launches()
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert _flash_launches()[0] == f0 + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (B, H, S)
    _assert_tiles_close(out, ref_out)
    assert (lse - ref_lse).abs().max().item() <= FLASH_LSE_ATOL
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _flash_launches()[1] == b0 + 2
    for g_, a_, w_, t in zip(got, again, want, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        assert torch.equal(g_, a_)
        _assert_tiles_close(g_, w_)


@pytest.mark.parametrize("B,S,H,Hk,hd,causal,dtype,fused", [
    (1, 300, 8, 2, 128, True, BF16, False),
    (2, 1000, 8, 2, 128, True, BF16, False),
    (1, 127, 4, 1, 64, False, FP16, False),
    (2, 129, 8, 2, 128, True, BF16, True),
])
def test_flash_attention_autograd_and_determinism(dev, B, S, H, Hk, hd, causal, dtype, fused):
    q, k, v, do = _flash_inputs(dev, B, S, H, Hk, hd, dtype, seed=3 + S, fused=fused)
    grads = []
    for _ in range(2):
        # fresh leaves on the same storage: a fused layout reaches the kernels
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention(qs, ks, vs, causal=causal)
        out.backward(do)
        grads.append((out.detach(), qs.grad, ks.grad, vs.grad))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # the autograd op against the plain versions, tile by tile
    ref_out, _ = fa.flash_attention_fwd_ref(q, k, v, causal)
    _assert_tiles_close(grads[0][0], ref_out)
    delta = (do.float() * grads[0][0].float()).sum(-1).transpose(1, 2).contiguous()
    _, lse = fa.flash_attention_fwd(q, k, v, causal)
    for got, want in zip(grads[0][1:], fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)):
        _assert_tiles_close(got, want)
    # through the gate: f32 and sq != sk are the flash op too
    f0, r0 = _flash_launches()[0], fa.flash_attention_fwd.by_route["f32"]
    assert fa.flash_attention_bsnd(q.float(), k.float(), v.float(), causal).dtype == torch.float32
    assert fa.flash_attention_bsnd(q[:, :10], k, v, False).shape == q[:, :10].shape
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.by_route["f32"] == r0 + 1
    assert _flash_launches()[0] == f0 + 2
    out = fa.flash_attention_bsnd(q, k, v, causal)
    assert torch.equal(out, grads[0][0])


def test_flash_attention_refuses(dev):
    q, k, v, _ = _flash_inputs(dev, 1, 64, 4, 2, 100, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v, True)
    q, k, v, _ = _flash_inputs(dev, 1, 64, 4, 2, 1032, torch.float32, seed=1)
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
        fa.flash_attention_fwd(q.double(), k.double(), v.double(), True)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q[:, :, :3], k, v, True)
    with pytest.raises(ValueError, match="strides"):             # a broadcast KV head
        fa.flash_attention_fwd(q, k[:, :, :1].expand(1, 64, 2, 64), v, True)


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
        qm.int8_matmul(x.double(), w, s)                # f64 activations, large M
    with pytest.raises(TypeError):
        qm.int8_matmul_dx(dout.half(), w, s)
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
    # the pre-pass, called on its own
    with pytest.raises(TypeError):
        qm.int8_prepass(dout.half(), s)
    with pytest.raises(ValueError, match="needs its scales"):
        qm.int8_prepass(dout)
    with pytest.raises(ValueError, match="scales must be"):
        qm.int8_prepass(dout, s[:40])                   # a short scales
    with pytest.raises(ValueError, match="multiple of 8"):
        qm.int8_prepass(x.float()[:, :44].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_prepass(torch.zeros((48, 100), dtype=torch.bfloat16, device=dev).t(), s)
    with pytest.raises(ValueError, match="aligned"):
        qm.int8_prepass(x.float().reshape(-1)[2:2 + 64 * 99].reshape(99, 64))


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


@pytest.mark.parametrize("N,S,H,D,dtype,n_out", [
    (4, 256, 8, 128, torch.bfloat16, 1), (3, 37, 4, 64, torch.float16, 3),
    (2, 5, 3, 8, torch.bfloat16, 0), (1, 9, 2, 256, torch.bfloat16, 1),
])
def test_ring_merge_matches_plain(dev, N, S, H, D, dtype, n_out):
    g = torch.Generator(device=dev)
    g.manual_seed(N + S + D)
    acc = torch.randn((N, S, H, D), generator=g, device=dev)
    out_b = torch.randn((N, S, H, D), generator=g, device=dev).to(dtype)
    lse = torch.randn((N, H, S), generator=g, device=dev) * 3 + 4
    lse_b = torch.randn((N, H, S), generator=g, device=dev) * 3 + 4
    lse_b[:, :, ::2] = -1e30
    got = [acc.clone(), lse.clone(), torch.zeros((n_out, S, H, D), dtype=dtype, device=dev)]
    want = [t.clone() for t in got]
    m0 = rf.ring_merge.launches
    rf.ring_merge(got[0], got[1], out_b, lse_b, got[2] if n_out else None)
    rf.ring_merge_plain(want[0], want[1], out_b, lse_b, want[2] if n_out else None)
    torch.cuda.synchronize()
    assert rf.ring_merge.launches == m0 + 1
    assert bool(((got[0] - want[0]).abs() <= MERGE_RTOL * want[0].abs() + MERGE_ATOL).all())
    assert bool(((got[1] - want[1]).abs() <= MERGE_RTOL * want[1].abs() + MERGE_ATOL).all())
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[dtype]
    assert bool(((got[2].float() - want[2].float()).abs()
                 <= step * want[2].float().abs() + 1e-6).all())
    assert torch.equal(got[0][:, ::2], acc[:, ::2]) and torch.equal(got[1][:, :, ::2],
                                                                     lse[:, :, ::2])


def test_ring_merge_refuses(dev):
    acc = torch.zeros((2, 4, 2, 64), device=dev)
    lse = torch.zeros((2, 2, 4), device=dev)
    out_b = torch.zeros((2, 4, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        rf.ring_merge(acc, lse, out_b.double(), lse)
    with pytest.raises(ValueError, match="multiple of 8"):
        rf.ring_merge(acc[..., :60].contiguous(), lse, out_b[..., :60].contiguous(), lse)
    with pytest.raises(ValueError, match="lse"):
        rf.ring_merge(acc, lse.transpose(1, 2).contiguous(), out_b, lse)
    with pytest.raises(ValueError, match="contiguous"):
        rf.ring_merge(acc[:, :, :, ::2], lse, out_b[:, :, :, ::2], lse)


@pytest.mark.parametrize("B,S,P,H,Hk,hd,causal", [
    (1, 512, 4, 8, 2, 128, True), (2, 300, 3, 8, 8, 64, True), (1, 256, 4, 4, 1, 64, False),
])
def test_ring_flash_matches_full_flash(dev, B, S, P, H, Hk, hd, causal):
    q, k, v, do = _flash_inputs(dev, B, S, H, Hk, hd, torch.bfloat16, seed=S + P)
    (f0, b0), m0 = _flash_launches(), rf.ring_merge.launches
    grads = []
    for fn in (lambda a, b, c: rf.ring_flash_attention(a, b, c, P, causal),
               lambda a, b, c: fa.flash_attention(a, b, c, causal)):
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qs, ks, vs)
        out.backward(do)
        grads.append((out.detach(), qs.grad, ks.grad, vs.grad))
    torch.cuda.synchronize()
    assert _flash_launches() == (f0 + P + 1, b0 + P + 1)
    assert rf.ring_merge.launches == m0 + P - 1
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        _assert_tiles_close(got, want)


# ---------------------------------------------------------------------------
# sq != sk, f32 and other head dims; f32 int8; the f32 ring
# ---------------------------------------------------------------------------


def _general_inputs(dev, B, sq, sk, H, Hk, hd, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, do = (torch.randn((B, sq, H, hd), generator=g, device=dev).to(dtype) for _ in "qo")
    k, v = (torch.randn((B, sk, Hk, hd), generator=g, device=dev).to(dtype) for _ in "kv")
    return q, k, v, do


@pytest.mark.parametrize("B,sq,sk,H,Hk,hd,causal,dtype", [
    (1, 256, 1024, 8, 2, 128, True, BF16),       # wgmma, more keys than queries
    (1, 256, 1000, 8, 2, 64, False, BF16),
    (2, 1000, 300, 8, 2, 128, True, BF16),       # 700 rows that see no key
    (1, 129, 64, 4, 4, 64, True, FP16),
    (1, 300, 500, 8, 2, 128, True, torch.float32),   # the f32 route
    (1, 500, 200, 8, 2, 96, True, torch.float32),    # f32, no key for 300 rows
    (1, 512, 512, 8, 2, 96, True, BF16),         # the padded route
    (2, 200, 77, 4, 1, 256, False, torch.float32),
    (1, 333, 100, 4, 4, 40, True, BF16),
    (1, 65, 65, 2, 1, 8, True, FP16),
])
def test_flash_general_matches_plain(dev, B, sq, sk, H, Hk, hd, causal, dtype):
    q, k, v, do = _general_inputs(dev, B, sq, sk, H, Hk, hd, dtype, seed=sq + sk + hd)
    route = fa.route(q)
    f0, b0 = fa.flash_attention_fwd.by_route[route], fa.flash_attention_bwd.by_route[route]
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.by_route[route] == f0 + 1
    assert fa.flash_attention_bwd.by_route[route] == b0 + 2
    assert out.shape == q.shape and lse.shape == (B, H, sq)
    _assert_tiles_close(out, ref_out)
    # a row that sees no key has lse -1e30 on both sides (to f32 rounding)
    assert bool(((lse - ref_lse).abs() <= FLASH_LSE_ATOL + 1e-6 * ref_lse.abs()).all())
    for g_, a_, w_, t in zip(got, again, want, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        assert torch.equal(g_, a_)
        _assert_tiles_close(g_, w_)


@pytest.mark.parametrize("dtype,hd", [(BF16, d) for d in (8, 40, 80, 96, 192, 256)]
                         + [(FP16, d) for d in (8, 40, 80, 96, 192, 256)]
                         + [(torch.float32, d) for d in (64, 96, 128, 256)])
@pytest.mark.parametrize("B,sq,sk,H,Hk,causal", [
    (1, 300, 500, 8, 2, True),          # more keys than queries, GQA 4
    (2, 500, 200, 4, 4, True),          # 300 rows that see no key
    (1, 129, 129, 4, 1, False),         # just past a 64- and 128-row tile
])
def test_flash_tensor_core_routes(dev, dtype, hd, B, sq, sk, H, Hk, causal):
    """Every (dtype, head_dim) the check takes launches a tensor-core kernel
    on the route :func:`route` names (padded for bf16/fp16 outside 64 and
    128, the two-piece split for f32), held tile by tile against the plain
    versions, the backward twice bit for bit."""
    q, k, v, do = _general_inputs(dev, B, sq, sk, H, Hk, hd, dtype, seed=sq + hd)
    route = fa.route(q)
    assert route == ("f32" if dtype == torch.float32 else "padded" if hd not in fa.HEAD_DIMS
                     else "wgmma")
    before = (fa.flash_attention_fwd.by_route[route], fa.flash_attention_bwd.by_route[route])
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.by_route[route],
            fa.flash_attention_bwd.by_route[route]) == (before[0] + 1, before[1] + 2)
    _assert_tiles_close(out, ref_out)
    assert bool(((lse - ref_lse).abs() <= FLASH_LSE_ATOL + 1e-6 * ref_lse.abs()).all())
    for g_, a_, w_, t in zip(got, again, want, (q, k, v)):
        assert g_.dtype == dtype and g_.shape == t.shape
        assert torch.equal(g_, a_)
        _assert_tiles_close(g_, w_)


def test_functional_sends_f32_sq_ne_sk_and_hd96_to_kernels(dev, monkeypatch):
    """``nn.functional.flash_attention`` on f32, sq != sk and head_dim 96:
    every call launches a flash kernel (the counters move) and none reaches
    the composed ``sdpa_ref``."""
    import paddle_tpu_torch.nn.functional.attention as attn
    from paddle_tpu_torch.nn import functional as F

    def composed(*a, **kw):
        raise AssertionError("a flash call reached the composed path on the card")

    monkeypatch.setattr(attn, "sdpa_ref", composed)
    cases = ((1, 256, 256, 8, 2, 128, torch.float32), (1, 128, 512, 8, 2, 128, BF16),
             (1, 256, 256, 8, 2, 96, BF16))
    for B, sq, sk, H, Hk, hd, dtype in cases:
        q, k, v, do = _general_inputs(dev, B, sq, sk, H, Hk, hd, dtype, seed=hd)
        route = fa.route(q)
        counts = (*_flash_launches(), fa.flash_attention_fwd.by_route[route],
                  fa.flash_attention_bwd.by_route[route])
        qs = q.requires_grad_(True)
        out, _ = F.flash_attention(qs, k, v, causal=True)
        out.backward(do)
        torch.cuda.synchronize()
        assert (*_flash_launches(), fa.flash_attention_fwd.by_route[route],
                fa.flash_attention_bwd.by_route[route]) == tuple(c + 1 for c in counts)
        assert torch.isfinite(qs.grad).all()


def _assert_gemm_f32_close(got, want, reduction=0):
    assert got.dtype == torch.float32
    diff = (got - want).abs()
    frac = max(GEMM_F32_ATOL_FRAC, 3 * -(-reduction // 16) * 2.0 ** -23)
    tol = GEMM_F32_RTOL * want.abs() + frac * want.abs().max()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.parametrize("M", [1, 8, 64, 65, 300, 1000])
@pytest.mark.parametrize("K,N", [(272, 400), (4096, 1024)])
def test_int8_f32_activations_match_plain(dev, M, K, N):
    """f32 on all three kernels: M <= 64 on the weight stream, M > 64 and
    every dX on the tensor-core kernel through the split pre-pass."""
    x, dout, w, s = _gemm_inputs(dev, M, K, N, seed=M + K + N)
    x, dout = x.float(), dout.float()
    counts = (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches,
              qm.int8_matmul_dx.launches, qm.int8_prepass.launches)
    out = qm.int8_matmul(x, w, s)
    dx = qm.int8_matmul_dx(dout, w, s)
    torch.cuda.synchronize()
    large = M > qm.LARGE_M
    assert (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches,
            qm.int8_matmul_dx.launches, qm.int8_prepass.launches) == \
        (counts[0] + (not large), counts[1] + large, counts[2] + 1, counts[3] + 1 + large)
    _assert_gemm_f32_close(out, qm.int8_matmul_ref(x, w, s), K if large else 0)
    _assert_gemm_f32_close(dx, qm.int8_matmul_dx_ref(dout, w, s), N)
    pieces = qm.int8_prepass(dout, s)
    assert torch.equal(pieces, qm.split3(dout * s))


@pytest.mark.parametrize("M", [1, 3, 8, 16, 33, 64])
@pytest.mark.parametrize("K,N", STREAM_SHAPES)
def test_int8_stream_f32_matches_plain(dev, M, K, N):
    """f32 x on the weight stream at its present elementwise limit: each
    16-deep step's three piece products are added in f32 registers."""
    x, _, w, s = _gemm_inputs(dev, M, K, N, seed=M + K + N)
    x = x.float() + 1e-3 * torch.randn_like(x.float())    # all 24 bits in use
    before = qm.int8_matmul.launches
    out = qm.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 1
    _assert_gemm_f32_close(out, qm.int8_matmul_ref(x, w, s))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (64, 4096, 1024), (8, 4096, 128256),
                                   (16, 14336, 4096)])
def test_int8_stream_is_one_deterministic_capturable_kernel(dev, M, K, N):
    """A profiler trace shows one kernel a call (no finalize kernel, no
    memset), two calls agree bit for bit (the K slices are reduced in
    order in the launch) and one captured CUDA graph replays it on new
    inputs."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    # the trace in a process of its own: after some of this file's tests the
    # profiler of this process records no kernel of the stream (alone, and
    # in chip_smoke.py, it records each)
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "from torch.profiler import ProfilerActivity, profile; "
            "from paddle_tpu_torch.ops import quant_matmul as qm; "
            "M, K, N = map(int, sys.argv[2:]); "
            "x = torch.randn((M, K), device='cuda').bfloat16(); "
            "w = torch.randint(-127, 128, (K, N), device='cuda', dtype=torch.int8); "
            "s = torch.rand((N,), device='cuda'); qm.int8_matmul(x, w, s); "
            "torch.cuda.synchronize()\n"
            "with profile(activities=[ProfilerActivity.CUDA]) as prof:\n"
            "    qm.int8_matmul(x, w, s); torch.cuda.synchronize()\n"
            "import json; print(json.dumps([e.name for e in prof.events() "
            "if e.device_type == torch.autograd.DeviceType.CUDA]))")
    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code, root, str(M), str(K), str(N)],
                         capture_output=True, text=True, timeout=300)
    ran = json.loads(out.stdout.strip().splitlines()[-1]) if out.stdout.strip() else out.stderr
    assert len(ran) == 1 and "int8_stream_kernel" in ran[0], ran

    x, _, w, s = _gemm_inputs(dev, M, K, N, seed=M + N)
    first = qm.int8_matmul(x, w, s)
    assert torch.equal(first, qm.int8_matmul(x, w, s))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qm.int8_matmul(x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qm.int8_matmul(x, w, s)
    x.copy_(torch.randn_like(x.float()).bfloat16())
    graph.replay()
    torch.cuda.synchronize()
    _assert_gemm_close(out, qm.int8_matmul_ref(x, w, s))


def test_int8_dx_prepass_rounds_like_plain(dev):
    """bf16 dX's pre-pass writes bf16(dO * bf16(s)) bit for bit as the plain
    version, one launch per dX."""
    _, dout, w, s = _gemm_inputs(dev, 300, 512, 768, seed=9)
    p0 = qm.int8_prepass.launches
    got = qm.int8_prepass(dout, s)
    qm.int8_matmul_dx(dout, w, s)
    torch.cuda.synchronize()
    assert qm.int8_prepass.launches == p0 + 2
    assert torch.equal(got, dout * s.bfloat16())


def test_ring_merge_takes_an_f32_partial(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    N, S, H, D = 3, 100, 4, 64
    acc = torch.randn((N, S, H, D), generator=g, device=dev)
    out_b = torch.randn((N, S, H, D), generator=g, device=dev)
    lse, lse_b = (torch.randn((N, H, S), generator=g, device=dev) * 3 for _ in "ab")
    got = [acc.clone(), lse.clone(), torch.zeros((2, S, H, D), device=dev)]
    want = [t.clone() for t in got]
    rf.ring_merge(got[0], got[1], out_b, lse_b, got[2])
    rf.ring_merge_plain(want[0], want[1], out_b, lse_b, want[2])
    torch.cuda.synchronize()
    for a_, b_ in zip(got, want):
        assert bool(((a_ - b_).abs() <= MERGE_RTOL * b_.abs() + MERGE_ATOL).all())


@pytest.mark.parametrize("B,S,P,hd,dtype", [
    (2, 300, 3, 128, BF16), (1, 4000, 4, 64, FP16), (1, 300, 3, 96, torch.float32),
])
def test_ring_attention_takes_the_kernels_at_a_ragged_shard(dev, B, S, P, hd, dtype):
    """S / P not a multiple of 128 (100 or 1000 positions a rank): the
    gate still sends the call to the ring schedule over the flash kernels
    (its wgmma, padded or f32 route) and the merge, and the result agrees
    with full flash."""
    from paddle_tpu_torch.ops import ring_attention as ra

    q, k, v, do = _flash_inputs(dev, B, S, 8, 2, hd, dtype, seed=S + hd)
    route = fa.route(q)

    def counts():
        return (fa.flash_attention_fwd.by_route[route], fa.flash_attention_bwd.by_route[route],
                rf.ring_merge.launches)

    f0, b0, m0 = counts()
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = ra.ring_attention(qs, ks, vs, P, True)
    out.backward(do)
    torch.cuda.synchronize()
    assert counts() == (f0 + P, b0 + P, m0 + P - 1)
    qf, kf, vf = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    full = fa.flash_attention(qf, kf, vf, True)
    full.backward(do)
    for got, want in zip((out, qs.grad, ks.grad, vs.grad), (full, qf.grad, kf.grad, vf.grad)):
        assert got.dtype == dtype and got.shape == want.shape
        _assert_tiles_close(got.detach(), want.detach())


@pytest.mark.parametrize("causal", [True, False])
def test_f32_ring_takes_the_kernels_through_the_gate(dev, causal):
    """f32 with S / P a multiple of 128: ``ring_attention`` takes the ring
    schedule over flash's f32 route and agrees with full flash."""
    from paddle_tpu_torch.ops import ring_attention as ra

    P = 4
    q, k, v, do = _flash_inputs(dev, 1, 1024, 8, 2, 128, torch.float32, seed=11)
    assert ra.flash_runs(q)
    s0, m0 = fa.flash_attention_fwd.by_route["f32"], rf.ring_merge.launches
    grads = []
    for fn in (lambda a, b, c: ra.ring_attention(a, b, c, P, causal),
               lambda a, b, c: fa.flash_attention(a, b, c, causal)):
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qs, ks, vs)
        out.backward(do)
        grads.append((out.detach(), qs.grad, ks.grad, vs.grad))
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.by_route["f32"] == s0 + P + 1
    assert rf.ring_merge.launches == m0 + P - 1
    for got, want in zip(*grads):
        _assert_tiles_close(got, want)


# -- the eleventh slice: fp16 int8, RMSNorm's rounding mode, attention past
# 256 columns, and the serving engine's programs as CUDA graphs ------------

# fp16 GEMM: the same exact products (fp16 x int8 is exact in f32) summed in
# f32 in another order, rounded once to fp16: one fp16 step relative plus
# 1e-3 of the largest output.
GEMM_FP16_RTOL = 2.0 ** -10


@pytest.mark.parametrize("M", [1, 8, 16, 64, 65, 8192])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (14336, 4096), (272, 400)])
def test_int8_fp16_matches_plain(dev, M, K, N):
    """fp16 activations: the weight stream's fp16 instantiation (M <= 64)
    and the tensor-core kernel's (M > 64), each counted once."""
    if M == 8192 and K * N > 4096 * 4096:
        pytest.skip("one large-M shape a K, N class is enough")
    x, _, w, s = _gemm_inputs(dev, M, K, N, seed=M + 3 * K + N)
    x = x.half()
    counts = (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches)
    out = qm.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    large = M > qm.LARGE_M
    assert (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches) == \
        (counts[0] + (not large), counts[1] + large)
    want = qm.int8_matmul_ref(x, w, s)
    assert out.dtype == torch.float16 and out.shape == (M, N)
    diff = (out.float() - want.float()).abs()
    tol = GEMM_FP16_RTOL * want.float().abs() + GEMM_ATOL_FRAC * want.float().abs().max()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.parametrize("N,H,dtype", [
    (8192, 4096, torch.bfloat16), (37, 4096, torch.bfloat16), (3, 1001, torch.bfloat16),
    (5, 1024, torch.float32), (7, 1024, torch.float16),
])
def test_rms_norm_round_first_matches_plain(dev, N, H, dtype):
    """The kernel's composed-form mode (what a TrainStep reaches): forward
    and dx against the plain versions of the same mode, and the autograd op
    against autograd through the composed form."""
    g = torch.Generator(device=dev)
    g.manual_seed(N + H + 1)
    x = (torch.randn((N, H), generator=g, device=dev) * 3).to(dtype)
    w = (torch.rand((H,), generator=g, device=dev) + 0.5).to(dtype)
    do = torch.randn((N, H), generator=g, device=dev).to(dtype)
    out, inv = fn.rms_norm_fwd(x, w, 1e-6, round_first=True)
    ref_out, ref_inv = fn.rms_norm_fwd_ref(x, w, 1e-6, round_first=True)
    dx = fn.rms_norm_bwd_dx(x, w, inv, do, round_first=True)
    ref_dx = fn.rms_norm_bwd_dx_ref(x, w, ref_inv, do, round_first=True)
    rtol = NORM_RTOL.get(dtype, 2.0 ** -10)
    for got, want in ((out, ref_out), (dx, ref_dx)):
        diff = (got.float() - want.float()).abs()
        tol = rtol * want.float().abs() + NORM_ATOL_FRAC * want.float().abs().max()
        assert bool((diff <= tol).all()), diff.max().item()
    if dtype != torch.float32:     # f32 has no narrower rounding to hold bits to
        assert (out != ref_out).float().mean().item() <= ROUND_MISMATCH_MAX
        fused = fn.rms_norm_fwd_ref(x, w, 1e-6)[0]
        assert (out != fused).float().mean().item() > ROUND_MISMATCH_MAX     # the control


def _wide_flash_case(dev, B, sq, sk, H, Hk, D, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, sk, Hk, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, sk, Hk, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, sq, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("B,sq,sk,H,Hk,D,causal,dtype", [
    (1, 256, 256, 4, 2, 320, True, BF16),
    (1, 100, 300, 4, 1, 512, True, BF16),       # sq != sk, bottom-right
    (2, 129, 129, 2, 2, 264, False, FP16),
    (1, 200, 70, 4, 2, 384, True, torch.float32),   # rows that see no key
    (1, 130, 190, 4, 2, 320, True, torch.float32),  # f32, chunks of 192 + 128
    (1, 64, 64, 2, 1, 1024, False, BF16),
    (1, 160, 330, 4, 1, 1024, True, BF16),      # four chunks, sq != sk, causal
])
def test_flash_wide_route_matches_plain(dev, B, sq, sk, H, Hk, D, causal, dtype):
    """Past 256 columns the flash op takes its wide route (one launch each
    way, counted there), held tile by tile against the plain versions; lse,
    which only the first chunk's blocks write, against the plain lse; the
    backward bit for bit again."""
    assert len(fa.chunk_plan(D)) > 1
    q, k, v, do = _wide_flash_case(dev, B, sq, sk, H, Hk, D, dtype, seed=D + sq)
    f0, b0 = fa.flash_attention_fwd.by_route["wide"], fa.flash_attention_bwd.by_route["wide"]
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    ref_grads = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.by_route["wide"], fa.flash_attention_bwd.by_route["wide"]) \
        == (f0 + 1, b0 + 1)
    _assert_tiles_close(out, ref_out)
    live = ref_lse > -1e29
    assert torch.allclose(lse[live], ref_lse[live], rtol=1e-6, atol=FLASH_LSE_ATOL)
    assert torch.allclose(lse[~live], ref_lse[~live], rtol=1e-6)
    for got, want in zip(grads, ref_grads):
        _assert_tiles_close(got, want)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("H,Hk,hd,bs,MB,dtype", [
    (8, 2, 320, 16, 6, torch.bfloat16), (4, 4, 512, 8, 5, torch.float32),
    (8, 2, 128, 512, 2, torch.float16), (6, 2, 1024, 16, 3, torch.bfloat16),
    (8, 2, 320, 16, 6, torch.float16), (8, 2, 320, 16, 6, torch.float32),
    (8, 2, 512, 16, 5, torch.bfloat16), (8, 2, 512, 8, 5, torch.float16),
    (4, 1, 520, 16, 4, torch.bfloat16), (4, 1, 520, 16, 4, torch.float16),
    (4, 1, 520, 16, 4, torch.float32), (6, 2, 1024, 16, 3, torch.float16),
    (4, 2, 1024, 8, 3, torch.float32),
    (8, 2, 128, 300, 3, torch.bfloat16), (8, 2, 64, 300, 3, torch.float32),
    (8, 2, 128, 512, 2, torch.bfloat16), (8, 4, 256, 512, 2, torch.float32),
    (4, 4, 8, 512, 2, torch.bfloat16),               # slices 1-3 wholly past the head dim
    (24, 2, 320, 16, 5, torch.bfloat16),             # 12 heads a KV head: two passes
    # rows that are no multiple of 16 bytes: no tensor map, the warp copies
    (8, 2, 300, 16, 6, torch.bfloat16), (6, 2, 7, 300, 3, torch.float16),
    (8, 2, 6, 300, 3, torch.float32),
])
def test_paged_attention_wide_matches_plain(dev, H, Hk, hd, bs, MB, dtype):
    """Head dims or pages past 256: the kernel's wide mode, one launch a
    call counted under ``wide``, every hidden slot NaN or Inf, two calls bit
    for bit, held against the plain version evaluated in f32 on the same
    inputs (the kernel keeps f32 scores and sums and rounds its
    probabilities once, where the plain version in bf16 also rounds its
    normalised probabilities: two roundings of an output in [4, 8) can sit
    a bf16 step, 0.03125, apart); captured in a graph and replayed after
    lengths and the block table change in place."""
    assert pa.mode(hd, bs) == "wide"
    cap = MB * bs
    lengths = [0, 1, bs, cap // 2 + 3, cap - 1]
    q, pk, pv, table, ln, pk_bad, pv_bad = _attention_case(dev, lengths, H, Hk, hd, bs, MB,
                                                           dtype, seed=hd + bs)
    n0, w0 = pa.paged_decode_attention.launches, pa.paged_decode_attention.by_route["wide"]
    got = pa.paged_decode_attention(q, pk_bad, pv_bad, table, ln)
    again = pa.paged_decode_attention(q, pk_bad, pv_bad, table, ln)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 2
    assert pa.paged_decode_attention.by_route["wide"] == w0 + 2
    assert torch.equal(got, again)
    want = pa.paged_decode_attention_ref(q.float(), pk.float(), pv.float(), table, ln)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want).abs().max().item()
    assert err <= ATTN_ATOL[dtype], err

    # a graph over pools every lane sees whole, replayed after the lengths
    # shrink and the table's rows rotate (each lane then sees another lane's
    # pages: every slot it sees holds values)
    q, pk, pv, table, ln, _, _ = _attention_case(dev, [cap - 1] * 5, H, Hk, hd, bs, MB, dtype,
                                                 seed=hd + bs + 1)
    pa.paged_decode_attention(q, pk, pv, table, ln)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_decode_attention(q, pk, pv, table, ln)
    ln.copy_(torch.tensor([0, 1, bs - 1, 7, cap // 2], dtype=torch.int32, device=dev))
    table.copy_(table.roll(1, 0))
    graph.replay()
    want = pa.paged_decode_attention_ref(q.float(), pk.float(), pv.float(), table, ln)
    assert (out.float() - want).abs().max().item() <= ATTN_ATOL[dtype]


def test_paged_attention_wide_is_one_kernel(dev):
    """A profiler trace of five calls (head dims past 256 through TMA and
    through copies, pages past 256 slots, f32) shows five
    ``paged_decode_wide_kernel`` launches: one a call. The trace runs in a
    process of its own, as the weight stream's test takes it (after some
    of this file's tests this process's profiler records no kernel)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "from torch.profiler import ProfilerActivity, profile; "
            "from paddle_tpu_torch.ops import paged_attention as pa\n"
            "calls = []\n"
            "for H, Hk, hd, bs, dt in ((8, 2, 320, 16, torch.bfloat16), "
            "(4, 2, 1024, 16, torch.float32), (8, 2, 128, 512, torch.float16), "
            "(8, 2, 300, 16, torch.bfloat16), (6, 2, 7, 300, torch.float16)):\n"
            "    q = torch.randn((3, H, hd), device='cuda').to(dt)\n"
            "    pk = torch.randn((7, bs, Hk, hd), device='cuda').to(dt)\n"
            "    table = torch.arange(1, 7, device='cuda', dtype=torch.int32).reshape(3, 2)\n"
            "    ln = torch.tensor([0, bs, 2 * bs - 1], device='cuda', dtype=torch.int32)\n"
            "    calls.append((q, pk, table, ln)); pa.paged_decode_attention(q, pk, pk, table, ln)\n"
            "torch.cuda.synchronize()\n"
            "with profile(activities=[ProfilerActivity.CUDA]) as prof:\n"
            "    for q, pk, table, ln in calls:\n"
            "        pa.paged_decode_attention(q, pk, pk, table, ln); torch.cuda.synchronize()\n"
            "import json; print(json.dumps([e.name for e in prof.events() "
            "if e.device_type == torch.autograd.DeviceType.CUDA]))")
    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True,
                         timeout=300)
    ran = json.loads(out.stdout.strip().splitlines()[-1]) if out.stdout.strip() else out.stderr
    assert len(ran) == 5 and all("paged_decode_wide_kernel" in n for n in ran), ran


def _tiny_engine_model(dev, dtype=torch.bfloat16):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256, intermediate_size=512,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2)
    return LlamaForCausalLM(cfg, device=dev, dtype=dtype, seed=1)


def _serve(model, eager, **cfg):
    """A staggered trace of mixed greedy and sampled requests; returns the
    streams and the engine."""
    from paddle_tpu_torch.inference.serving import SamplingParams, ServeConfig, ServingEngine

    eng = ServingEngine(model, ServeConfig(num_lanes=3, block_size=16, max_seq_len=96,
                                           prefill_chunk=16, **cfg), eager=eager)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, n).tolist() for n in (3, 40, 1, 20, 7)]

    def params(i):
        if not cfg.get("sampling") or i % 2:
            return None
        return SamplingParams(temperature=0.8, top_k=(0, 20)[i % 4 // 2], top_p=0.9,
                              seed=10 + i)

    reqs = [eng.submit(p, 8, sampling=params(i)) for i, p in enumerate(prompts[:3])]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p, 8, sampling=params(i + 3)) for i, p in enumerate(prompts[3:])]
    eng.run()
    return [(r.status, r.generated) for r in reqs], eng


@pytest.mark.parametrize("cfg", [dict(), dict(weight_dtype="int8"),
                                 dict(sampling=True), dict(sampling=True, nan_guard=True,
                                                           weight_dtype="int8")])
def test_graphed_engine_matches_the_eager_engine(dev, cfg):
    """The engine's two programs as CUDA graphs (one capture each) against
    the same programs run eagerly: identical streams, bit for bit, greedy
    and sampled, bf16 and int8. A replay runs kernels that no wrapper
    counts, so the kernels the device ran are read from a device trace:
    paged attention once a layer in each decode call, and with int8 the
    weight stream once a projection in each call of either program."""
    from torch.profiler import ProfilerActivity, profile

    model = _tiny_engine_model(dev)
    want, eager = _serve(model, eager=True, **cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got, eng = _serve(model, eager=False, **cfg)
        torch.cuda.synchronize()
    assert got == want and all(s == "done" for s, _ in got)
    assert eng.stats()["captures"] == {"decode": 1, "prefill": 1}
    assert eager.stats()["captures"] == {"decode": 0, "prefill": 0}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    calls, layers = eng.stats()["program_calls"], model.config.num_hidden_layers
    assert calls == eager.stats()["program_calls"]
    assert sum("paged_decode_kernel" in n for n in names) == layers * calls["decode"]
    head = int(isinstance(eng._w["lm_head"], dict))
    want_stream = ((7 * layers + head) * calls["decode"] + 7 * layers * calls["prefill"]
                   if cfg.get("weight_dtype") == "int8" else 0)
    assert sum("int8_stream_kernel" in n for n in names) == want_stream


def test_graphed_engine_nan_guard_and_fp16_int8(dev):
    """The guard inside the decode graph: one lane's pages poisoned, that
    request fails with "nonfinite logits", the others keep the clean run's
    streams; and an fp16 int8 engine serves through the fp16 kernels."""
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    model = _tiny_engine_model(dev)

    def run(poison):
        eng = ServingEngine(model, ServeConfig(num_lanes=3, block_size=16, max_seq_len=64,
                                               nan_guard=True))
        reqs = [eng.submit([5 + i, 9, 11, 13, 2][: 5 - i], 8) for i in range(3)]
        for i in range(4):
            if i == 3 and poison:
                eng._kv.pages_k[:, eng._kv.lane_blocks(reqs[1].lane)] = float("nan")
            eng.step()
        eng.run()
        return reqs

    bad, clean = run(True), run(False)
    assert bad[1].status == "failed" and bad[1].error == "nonfinite logits"
    assert [r.generated for r in (bad[0], bad[2])] == [r.generated for r in (clean[0], clean[2])]
    m16 = _tiny_engine_model(dev, torch.float16)
    s0 = qm.int8_matmul.launches
    got, eng = _serve(m16, eager=False, weight_dtype="int8")
    want, _ = _serve(m16, eager=True, weight_dtype="int8")
    assert got == want and qm.int8_matmul.launches > s0
