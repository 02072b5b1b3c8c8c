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
flash kernel (bf16, and f32 and ragged shards through the gate), the
checks that refuse
what a kernel does not take; and the paths of the prefix cache and of
speculative decoding: paged attention over block tables whose lanes alias
pages, the weight stream at the speculative verify's M = 40, and both
engines graphed against eager; and the fused optimizer step's multi-tensor
kernel against the card's composed per-parameter update, bit for bit over
3 steps (SGD, Momentum with and without Nesterov, Adam, AdamW in f32, bf16
and fp16; master weights; the global-norm clip with mixed need_clip; decay
exemptions and two parameter groups; numels 1, 4097 and 2^20 + 3; more
tensors than one launch holds; f32 gradients on bf16 parameters); one
paged-attention lane's bits across the other lanes' lengths, narrow and
wide; the AMP loop (O2 bf16, O1, O2 fp16 with a skipped step) through
the kernels against its plain versions; an ERNIE TrainStep through the
fused optimizer against its plain version, bit for bit; and the vision
path: f32 convolutions in full f32 (with a TF32 control), bf16 batch norm
against the CPU's bits, and two resnet18 TrainStep calls; and the
high-level API: an epoch of the device loader (0 and 4 workers) bit for
bit against the CPU loader, a worker's exception raised in the consumer,
and LeNet's ``Model.fit`` on the card against the CPU with the fused
optimizer once a step; and the Mixture-of-Experts layer: dense and sort
dispatch on the card (decisions, aux losses and two sort runs bit for bit,
values in f32), an MoE Llama on the card against the CPU in f32, and step
1's gradients under each recompute policy against none's with the
recomputed forwards' launches counted; and the op surface: each op's
first case of ``paddle_tpu_torch.tools.op_cases`` on the card against the
CPU, and one eager step of chip_smoke's ``OpsLlama`` (nn.Layer,
create_parameter, public ops) with its flash, RMSNorm and fused-update
launches counted; and the distributed tier through the launcher: one
NCCL rank training the sharded model bit for bit as ``TrainStep`` with
exact launches, ``DataParallel`` over two gloo ranks on the one card with
bit-identical gradients, tensor parallelism and the pipeline (pp 2, every
schedule style's gradients against a one-process backward, two planted
faults, 1F1B's memory below FThenB's) over two gloo ranks on the one
card, and NCCL refusing two ranks on one card.
"""

import contextlib

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


@pytest.mark.parametrize("lanes,held", [(8, 0), (8, 7), (40, 39)])
@pytest.mark.parametrize("hd,bs,MB", [(128, 16, 64), (320, 16, 64), (128, 512, 2)])
def test_paged_attention_lane_bits_do_not_depend_on_other_lanes(dev, hd, bs, MB, lanes, held):
    """The held lane (length 600) gives the same bits while the other
    lanes hold 1, 30 or 1000 tokens, narrow and in the wide mode (hd 320,
    pages of 512): Kc, and with it a lane's split points, come from the
    shapes. The last of 40 lanes: its pairs' chunks are their blocks'
    second, after the first lanes' chunks. Each call within ATTN_ATOL of
    the CPU emulation of its schedule."""
    g = torch.Generator(device=dev)
    g.manual_seed(hd + bs)
    nb = 1 + lanes * MB
    pk, pv = (torch.randn((nb, bs, 8, hd), generator=g, device=dev).bfloat16()
              for _ in range(2))
    table = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(lanes, MB).int()
    q = torch.randn((lanes, 32, hd), generator=g, device=dev).bfloat16()
    ln = torch.zeros(lanes, dtype=torch.int32, device=dev)
    grid = pa._plan_for(q, pk, table)[0]
    cpu = [t.cpu() for t in (q, pk, pv, table)]
    outs = []
    for other in (1, 30, 1000):
        lengths = [other] * lanes
        lengths[held] = 600
        ln.copy_(torch.tensor(lengths, dtype=torch.int32))
        got = pa.paged_decode_attention(q, pk, pv, table, ln)
        emu = pa.paged_decode_attention_split(*cpu, ln.cpu(), grid)
        assert (got.cpu().float() - emu.float()).abs().max().item() <= ATTN_ATOL[torch.bfloat16]
        outs.append(got[held])
    assert all(torch.equal(f, outs[0]) for f in outs[1:])


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
    # a rank's heads of Llama-3-8B at tensor 2
    (1, 2048, 16, 4, 128, True, BF16, False),
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


def _aliased_tables(dev, lanes, MB, shared, nb, seed):
    """Block tables as the prefix cache leaves them: the first ``shared``
    entries of every lane are the same pages, lane 1 holds a private fork
    of the last shared page, the rest of each row is private."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pages = torch.randperm(nb - 1, generator=g, device=dev) + 1
    table = torch.zeros((lanes, MB), dtype=torch.int32, device=dev)
    table[:, :shared] = pages[:shared].int()
    rest = pages[shared:]
    for b in range(lanes):
        table[b, shared:] = rest[b * (MB - shared):(b + 1) * (MB - shared)].int()
    table[1, shared - 1] = int(rest[lanes * (MB - shared)])
    return table


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lengths", [[600, 511, 700, 531, 1000, 520, 512, 640],
                                     [511, 40, 511, 600, 0, 1023, 512, 513]])
def test_paged_attention_over_aliased_pages(dev, dtype, lengths):
    """The prefix cache's tables: 8 lanes share a 32-page system prompt,
    one lane holds a fork of its last page. The kernel reads pages only
    through the table and keys its split scratch and tickets by (lane, KV
    head, pass), so it gives the plain version's output within ATTN_ATOL,
    twice bit for bit, and inside a captured graph."""
    lanes, H, Hk, hd, bs, MB = 8, 32, 8, 128, 16, 64
    nb = 1 + 32 + lanes * (MB - 32) + 1
    g = torch.Generator(device=dev)
    g.manual_seed(len(lengths) + hd)
    pk = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    pv = torch.randn((nb, bs, Hk, hd), generator=g, device=dev).to(dtype)
    table = _aliased_tables(dev, lanes, MB, 32, nb, seed=3)
    q = torch.randn((lanes, H, hd), generator=g, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    first = pa.paged_decode_attention(q, pk, pv, table, ln)
    again = pa.paged_decode_attention(q, pk, pv, table, ln)
    want = pa.paged_decode_attention_ref(q, pk, pv, table, ln)
    assert torch.equal(first, again)
    assert (first.float() - want.float()).abs().max().item() <= ATTN_ATOL[dtype]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_decode_attention(q, pk, pv, table, ln)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_decode_attention(q, pk, pv, table, ln)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("K,N", STREAM_SHAPES)
def test_int8_stream_at_the_verify_rows(dev, dtype, K, N):
    """M = 40: the verify program's rows (8 lanes x (k + 1), k = 4), one
    weight-stream launch a call, against the plain version."""
    M = 40
    g = torch.Generator(device=dev)
    g.manual_seed(K + N + (dtype == torch.float16))
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=dev) * 0.02 + 1e-3
    before = (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches)
    got = qm.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert (qm.int8_matmul.launches, qm.int8_matmul_large_m.launches) == \
        (before[0] + 1, before[1])
    want = qm.int8_matmul_ref(x, w, s)
    rtol = GEMM_RTOL if dtype == torch.bfloat16 else GEMM_FP16_RTOL
    diff = (got.float() - want.float()).abs()
    tol = rtol * want.float().abs() + GEMM_ATOL_FRAC * want.float().abs().max()
    assert got.dtype == dtype and bool((diff <= tol).all()), diff.max().item()


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def _prefix_trace(model, eager, **cfg):
    """A shared 48-token prompt (3 blocks) opened by most requests, one
    that is the shared prompt alone (a COW fork), a 100-token unrelated
    prompt between (in a pool of 8 blocks it pushes the cache out);
    requests served one at a time."""
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    eng = ServingEngine(model, ServeConfig(num_lanes=3, block_size=16, max_seq_len=128,
                                           prefill_chunk=16, **cfg), eager=eager)
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 512, 48).tolist()
    prompts = [shared + rng.randint(1, 512, n).tolist() for n in (5, 17)]
    prompts += [rng.randint(1, 512, 100).tolist(), shared, shared + [7, 8]]
    out = []
    for p in prompts:
        r = eng.submit(p, 8)
        eng.run()
        out.append((r.status, r.generated))
    return out, eng


@pytest.mark.parametrize("cfg", [dict(), dict(weight_dtype="int8"),
                                 dict(num_blocks=9, host_kv_blocks=8),
                                 dict(num_blocks=9, host_kv_blocks=0)])
def test_graphed_prefix_cache_engine(dev, cfg):
    """The prefix cache on the card: hits, a fork, and with an 8-block pool
    evictions to the host and restores (or drops), through the two graphs
    (one capture each), bit for bit equal to the eager engine and to a
    cache-cold graphed engine; paged attention once a layer a decode call
    (device trace)."""
    model = _tiny_engine_model(dev)
    cold, _ = _prefix_trace(model, eager=False, **{k: v for k, v in cfg.items()
                                                   if k != "host_kv_blocks"})
    want, eager = _prefix_trace(model, eager=True, prefix_cache=True, **cfg)
    got, ks = _device_kernels(lambda: _prefix_trace(model, eager=False, prefix_cache=True,
                                                    **cfg))
    got, eng = got
    assert got == want == cold and all(s == "done" for s, _ in got)
    st = eng.stats()
    assert st["captures"] == {"decode": 1, "prefill": 1}
    pc = st["prefix_cache"]
    assert pc["hits"] >= 3 and (pc["forks"] >= 1 or cfg.get("host_kv_blocks") == 0)
    assert st["kv_calls"]["kv_restore"] == pc["restores"]
    assert st["kv_calls"]["kv_offload"] == pc["evictions_host"]
    if cfg.get("host_kv_blocks"):
        assert pc["evictions_host"] >= 1 and pc["restores"] >= 1
    elif "num_blocks" in cfg:
        assert pc["evictions_drop"] >= 1
    layers = model.config.num_hidden_layers
    assert sum("paged_decode_kernel" in n for n in ks) == layers * st["program_calls"]["decode"]
    eng._kv.audit(eng._prefix.cached_blocks)


@pytest.mark.parametrize("cfg", [dict(), dict(sampling=True), dict(weight_dtype="int8")])
def test_graphed_speculative_engine(dev, cfg):
    """Draft decode, verify and prefill as CUDA graphs (one capture each)
    against the same programs run eagerly: identical streams; greedy
    tokens equal to the non-speculative graphed engine's in f32 (TF32
    off); with int8 the weight stream once a projection in each verify and
    prefill call (the draft stays unquantized) and no other int8 kernel."""
    from paddle_tpu_torch.inference.serving.speculative import DraftConfig
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = _tiny_engine_model(dev)
    draft = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512, hidden_size=128,
                                              intermediate_size=256, num_hidden_layers=1,
                                              num_attention_heads=2, num_key_value_heads=1),
                             device=dev, dtype=torch.bfloat16, seed=2)
    dc = DraftConfig(draft, 3)
    want, eager = _serve(model, eager=True, draft=dc, **cfg)
    (got, eng), ks = _device_kernels(lambda: _serve(model, eager=False, draft=dc, **cfg))
    assert got == want and all(s == "done" for s, _ in got)
    assert eng.stats()["captures"] == {"draft_decode": 1, "verify": 1, "prefill": 1}
    calls = eng.stats()["program_calls"]
    assert calls == eager.stats()["program_calls"]
    assert not any("paged_decode" in n for n in ks)
    layers = model.config.num_hidden_layers
    head = int(isinstance(eng._w["lm_head"], dict))
    want_stream = ((7 * layers + head) * calls["verify"] + 7 * layers * calls["prefill"]
                   if cfg.get("weight_dtype") == "int8" else 0)
    assert sum("int8_stream_kernel" in n for n in ks) == want_stream
    assert not any("int8_tc_kernel" in n for n in ks)


def test_speculative_f32_greedy_equals_the_plain_engine(dev):
    from paddle_tpu_torch.inference.serving.speculative import DraftConfig

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = _tiny_engine_model(dev, torch.float32)
        base, _ = _serve(model, eager=False)
        spec, eng = _serve(model, eager=False, draft=DraftConfig(model, 4))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert spec == base
    assert eng.stats()["spec"]["accept_rate"] >= 0.9


# ---------------------------------------------------------------------------
# the fused optimizer step: the multi-tensor kernel against the card's
# composed per-parameter update (PADDLE_OPT_FUSED=0), bit for bit
# ---------------------------------------------------------------------------

# numels 1, 4097 (a ragged vector tail), 2^20 + 3 (many chunks, a tail),
# one tensor smaller than a block and a 2-D one
FO_SHAPES = [(1,), (4097,), (2 ** 20 + 3,), (3,), (64, 33)]


def _bits(t):
    """The tensor's bit pattern (NaNs compare by payload)."""
    return t.detach().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _fo_run(make, dtype, regime, monkeypatch, shapes=FO_SHAPES, clipped=(), steps=3):
    from paddle_tpu_torch.ops import fused_optimizer as fo

    monkeypatch.setenv("PADDLE_OPT_FUSED", regime)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ps = []
    for i, s in enumerate(shapes):
        p = torch.nn.Parameter(torch.randn(s, generator=g, device="cuda").to(dtype))
        p.paddle_name = f"w{i}" if i % 2 else f"b{i}"
        if i in clipped:
            p.need_clip = False
        ps.append(p)
    o = make(ps)
    launches = fo.multi_tensor_update.launches
    for t in range(steps):
        for p in ps:
            p.grad = (torch.randn(p.shape, generator=g, device="cuda") * 0.1).to(dtype)
        o.step()
    torch.cuda.synchronize()
    return ps, o, fo.multi_tensor_update.launches - launches


def _fo_same(kern, plain):
    (pk, ok, _), (pp, op, launched) = kern, plain
    assert launched == 0
    for a, b in zip(pk, pp):
        assert torch.equal(_bits(a), _bits(b))
        sa, sb = ok._accumulators[id(a)], op._accumulators[id(b)]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(_bits(sa[k]), _bits(sb[k])), k
        assert (id(a) in ok._master_weights) == (id(b) in op._master_weights)
        if id(a) in ok._master_weights:
            assert torch.equal(_bits(ok._master_weights[id(a)]),
                               _bits(op._master_weights[id(b)]))


FO_CASES = {
    "sgd_l2": lambda o, ps: o.SGD(0.1, parameters=ps, weight_decay=0.01),
    "momentum": lambda o, ps: o.Momentum(0.1, 0.9, parameters=ps),
    "momentum_nesterov_l2": lambda o, ps: o.Momentum(0.1, 0.9, parameters=ps,
                                                     use_nesterov=True, weight_decay=0.01),
    "adam_l2": lambda o, ps: o.Adam(1e-3, parameters=ps, weight_decay=0.01),
    "adamw": lambda o, ps: o.AdamW(1e-3, parameters=ps, weight_decay=0.1),
}


@pytest.mark.parametrize("case", list(FO_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_optimizer_matches_composed_update(dev, monkeypatch, case, dtype):
    from paddle_tpu_torch import optimizer as popt

    def make(ps):
        return FO_CASES[case](popt, ps)

    kern = _fo_run(make, dtype, "1", monkeypatch)
    assert kern[2] == 3
    _fo_same(kern, _fo_run(make, dtype, "0", monkeypatch))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_optimizer_master_weights_and_mixed_need_clip(dev, monkeypatch, dtype):
    """f32 masters written back to bf16 / fp16, the global-norm clip's
    scale applied in the kernel to the gradients with need_clip only."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt

    def make(ps):
        return popt.AdamW(1e-3, parameters=ps, weight_decay=0.1, multi_precision=True,
                          grad_clip=pnn.ClipGradByGlobalNorm(0.5))

    kern = _fo_run(make, dtype, "1", monkeypatch, clipped=(1, 3))
    _fo_same(kern, _fo_run(make, dtype, "0", monkeypatch, clipped=(1, 3)))
    assert all(p.dtype == dtype for p in kern[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_optimizer_decay_exemptions_and_param_groups(dev, monkeypatch, dtype):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt

    def make(ps):
        return popt.AdamW(1e-3, weight_decay=0.1, apply_decay_param_fun=lambda n: "w" in n,
                          grad_clip=pnn.ClipGradByGlobalNorm(1.0), parameters=[
                              {"params": ps[:2], "learning_rate": 3e-3, "weight_decay": 0.3},
                              {"params": ps[2:]}])

    kern = _fo_run(make, dtype, "1", monkeypatch, clipped=(2,))
    _fo_same(kern, _fo_run(make, dtype, "0", monkeypatch, clipped=(2,)))


def test_fused_optimizer_more_tensors_than_one_launch(dev, monkeypatch):
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.ops import fused_optimizer as fo

    shapes = [((i * 37) % 5000 + 1,) for i in range(2 * fo.MAX_TENSORS + 44)]

    def make(ps):
        return popt.Momentum(0.1, 0.9, parameters=ps, use_nesterov=True)

    kern = _fo_run(make, torch.bfloat16, "1", monkeypatch, shapes=shapes)
    assert kern[2] == 3 * 3
    _fo_same(kern, _fo_run(make, torch.bfloat16, "0", monkeypatch, shapes=shapes))


@pytest.mark.parametrize("clip", [False, True])
def test_fused_optimizer_f32_gradients_on_bf16_parameters(dev, clip):
    """TrainStep's accumulated gradients: an f32 mean on bf16 parameters,
    clipped in f32 and then rounded to bf16 inside the kernel, as the
    composed path's clip and g.to(p.dtype) do."""
    from paddle_tpu_torch.nn.clip import global_norm_scale
    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    runs = []
    for update in (fo.multi_tensor_update, fo.multi_tensor_update_plain):
        g.manual_seed(1)
        params = [torch.randn(s, generator=g, device="cuda").bfloat16() for s in FO_SHAPES]
        states = [AdamW.init_state(p) for p in params]
        for t in range(1, 4):
            grads = [torch.randn(p.shape, generator=g, device="cuda") for p in params]
            scale = global_norm_scale(1.0, grads, [True] * len(grads)) if clip else None
            entries = [fo.Entry(p, gr, s, 3e-4, (0.1, 0.9, 0.999, 1e-8), scale)
                       for p, gr, s in zip(params, grads, states)]
            update(AdamW, entries, t)
        torch.cuda.synchronize()
        runs.append((params, states))
    (params_k, states_k), (params_p, states_p) = runs
    for pk, pp, sk, sp in zip(params_k, params_p, states_k, states_p):
        assert torch.equal(_bits(pk), _bits(pp))
        for k in sk:
            assert torch.equal(_bits(sk[k]), _bits(sp[k]))


def test_fused_optimizer_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.optimizer import SGD, Lamb

    p = torch.zeros(8, device="cuda")
    with pytest.raises(TypeError):
        fo.multi_tensor_update(Lamb, [fo.Entry(p, p, {}, 0.1, (0.0,))], 1)
    with pytest.raises(ValueError):
        fo.multi_tensor_update(SGD, [fo.Entry(p, torch.zeros(9, device="cuda"), {}, 0.1,
                                              (0.0,))], 1)
    with pytest.raises(ValueError):
        fo.multi_tensor_update(SGD, [fo.Entry(torch.zeros(8, 2, device="cuda").t(),
                                              torch.zeros(2, 8, device="cuda"), {}, 0.1,
                                              (0.0,))], 1)


# the AMP loop (amp.auto_cast, decorate, GradScaler) through the kernels
# against the same loop through the plain versions: chip_smoke.py phase
# 18c's check at a small width (hidden 512, head_dim 128, 2 layers, seq
# 256), with its limits (hold_amp_paths: STEP_LOSS_RTOL on each loss,
# AMP_GRAD_RTOL on each leaf's step-1 gradient, AMP_MASTER_RTOL on each
# master's change after 3 steps, the control above AMP_GRAD_RTOL); the
# readings are printed
@pytest.mark.parametrize("level,dtype,scale", [("O2", "bfloat16", None),
                                               ("O1", "bfloat16", None),
                                               ("O2", "float16", 1000.0)])
def test_amp_steps_match_the_plain_versions(dev, level, dtype, scale):
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           intermediate_size=1024, vocab_size=4096)
    kern = LlamaForCausalLM(cfg, device=dev, seed=0)
    plain = LlamaForCausalLM(cfg, device=dev, seed=1)
    plain.load_state_dict(kern.state_dict())
    rng = np.random.RandomState(2)
    batches = [cs.token_batch(rng, 256, cfg.vocab_size) for _ in range(4)]
    runs = {"kernel": cs.make_amp(kern, level, dtype, scale),
            "plain": cs.make_amp(plain, level, dtype, scale)}
    held = cs.hold_amp_paths(cs.amp_paths(runs, level, dtype, batches[:3]), "card test")
    print(f"amp card test {level} {dtype}: {held}")
    (_, ok, sk), (_, op, sp) = runs["kernel"], runs["plain"]
    assert sk.state_dict() == sp.state_dict() and ok._step_count == op._step_count == 3
    if dtype == "float16":
        assert cs.hold_skip(runs, level, dtype, batches[3], "fp16")[
            "skipped_step_state_bit_for_bit"]


# an ERNIE TrainStep (post-LN encoder, masked composed attention, AdamW in
# bf16) through the fused optimizer's kernel against the same steps with its
# plain version: chip_smoke.py phase 19c at a small width (hidden 256, 4
# heads, 2 layers, batch 8 x 64 with ragged rows), every parameter and
# moment bit for bit (the forward and backward are the same code)
def test_ernie_train_step_matches_the_plain_optimizer(dev):
    import chip_smoke as cs

    out = cs.ernie_check(0, batch=8, seq=64, phase="card test", vocab_size=1000,
                         hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=512)
    assert out["bit_for_bit"] and out["tensors"] == 5 + 16 * 2 + 2 + 2
    assert out["moved_elements"] > 0


# the vision path: cuDNN's convolutions, torch's pools and the composed
# batch norm. An f32 convolution on the card runs full f32 forward and
# backward (TF32 off inside the port's conv): within CONV_F32_FRAC of the
# largest magnitude of a float64 CPU reference, a few f32 ulps of sums of
# up to 3136 products. The control runs cuDNN with TF32 allowed: cuDNN
# takes it only in its tensor-core algorithms, which it picks for some of a
# convolution's three products and not for others (not for the depthwise
# one, nor for the stem's dgrad, on an H100 with torch 2.11), so the control
# must exceed the limit in at least one of them for ResNet's own cases
# (TF32_CASES) and is printed for the rest.
CONV_F32_FRAC = 5e-5
CONV_CASES = [("stem", (4, 3, 64, 64), (64, 3, 7, 7), dict(stride=2, padding=3)),
              ("3x3", (4, 64, 28, 28), (64, 64, 3, 3), dict(padding=1)),
              ("1x1_s2", (4, 256, 28, 28), (512, 256, 1, 1), dict(stride=2)),
              ("depthwise", (4, 32, 28, 28), (32, 1, 3, 3), dict(padding=1, groups=32))]
TF32_CASES = ("stem", "3x3", "1x1_s2")


@contextlib.contextmanager
def _cudnn_tf32():
    from paddle_tpu_torch.nn.functional import conv

    @contextlib.contextmanager
    def allow():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    saved, conv.full_f32 = conv.full_f32, allow
    try:
        yield
    finally:
        conv.full_f32 = saved


def _conv_run(fn, x, w, cot, **kw):
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = fn(x, w, **kw)
    out.backward(cot)
    return [t.detach().double().cpu() for t in (out, x.grad, w.grad)]


@pytest.mark.parametrize("name,xs,ws,kw", CONV_CASES + [
    ("transpose", (4, 64, 14, 14), (64, 32, 3, 3), dict(stride=2, padding=1, output_padding=1))],
    ids=[c[0] for c in CONV_CASES] + ["transpose"])
def test_f32_conv_is_full_f32_with_a_tf32_control(dev, name, xs, ws, kw):
    from paddle_tpu_torch.nn import functional as F

    fn = F.conv2d_transpose if name == "transpose" else F.conv2d
    g = torch.Generator(device="cpu")
    g.manual_seed(len(name))
    x, w = torch.randn(xs, generator=g), torch.randn(ws, generator=g) * 0.1
    cot = torch.randn(fn(x, w, **kw).shape, generator=g)
    want = _conv_run(fn, x.double(), w.double(), cot.double(), **kw)
    got = _conv_run(fn, x.to(dev), w.to(dev), cot.to(dev), **kw)
    with _cudnn_tf32():
        tf32 = _conv_run(fn, x.to(dev), w.to(dev), cot.to(dev), **kw)
    controls = {}
    for what, a, t, b in zip(("out", "dx", "dw"), got, tf32, want):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= CONV_F32_FRAC * scale, (what, err, scale)
        controls[what] = float((t - b).abs().max()) / (CONV_F32_FRAC * scale)
    print(f"conv {name}: TF32 control over the limit {controls}")
    if name in TF32_CASES:
        assert max(controls.values()) > 1, controls
    assert torch.backends.cudnn.allow_tf32 is True   # the port set nothing outside its block


# bf16 batch norm on the card against the CPU: the same composed ops, f32
# statistics summed in another order (an f32 ulp of the mean or the
# variance flips a bf16 rounding on about 2^-15 of the elements), so the
# forward and its gradient may differ on at most ROUND_MISMATCH_MAX of the
# elements, each by at most a bf16 ulp of itself (2^-7 relative) or, near
# zero, where a shifted mean moves the value by more ulps of its own, 2^-12
# of the largest; torch's own batch norm (one rounding, after the affine),
# held the same way, must fail. The bf16 running statistics: at most one
# element in a thousand off, by one ulp.
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_batch_norm_on_the_card_is_the_cpu_s_bits(dev, training):
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    x = (torch.randn(16, 64, 28, 28, generator=g) * 2 + 0.5).bfloat16()
    w, b = (torch.rand(64, generator=g) + 0.5).bfloat16(), torch.randn(64, generator=g).bfloat16()
    rm = (torch.randn(64, generator=g) * 0.3).bfloat16()
    rv = (torch.rand(64, generator=g) + 0.5).bfloat16()
    cot = torch.randn(x.shape, generator=g).bfloat16()

    def run(device):
        xs = x.to(device).requires_grad_(True)
        m, v = rm.to(device), rv.to(device)
        out = F.batch_norm(xs, m, v, w.to(device), b.to(device), training=training)
        out.backward(cot.to(device))
        return [t.detach().cpu() for t in (out, xs.grad, m, v)]

    def mismatch(a, c):
        return float((a != c).float().mean())

    card, cpu = run(dev), run("cpu")
    for what, a, c in zip(("out", "dx"), card[:2], cpu[:2]):
        assert mismatch(a, c) <= ROUND_MISMATCH_MAX, (what, mismatch(a, c))
        a, c = a.float(), c.float()
        assert bool(((a - c).abs() <= 2**-7 * c.abs() + 2**-12 * c.abs().max()).all()), what
    for a, c in zip(card[2:], cpu[2:]):
        assert mismatch(a, c) <= 1e-3 or int((a != c).sum()) <= 1
        torch.testing.assert_close(a.float(), c.float(), rtol=2**-8, atol=0)
    once = torch.nn.functional.batch_norm(
        x.to(dev).float(), rm.to(dev).float(), rv.to(dev).float(), w.to(dev).float(),
        b.to(dev).float(), training=training).bfloat16().cpu()
    assert mismatch(once, cpu[0]) > ROUND_MISMATCH_MAX


# two bench-style steps of resnet18 in bf16 on the card (Momentum through
# TrainStep, batch 8 at 64 x 64): finite losses, the fused optimizer once a
# step for its 62 tensors and no other hand-written kernel, every velocity
# nonzero (a bf16 parameter near 1 keeps its value under a step below half
# its ulp, so not every tensor need move), most weight elements and every
# running mean moved
def test_resnet18_train_step_on_the_card(dev):
    import chip_smoke as cs
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = vision.resnet18(device=dev, generator=gen).bfloat16()
    start = [p.detach().clone() for p in model.parameters()]
    step = TrainStep(model, Momentum(0.1, parameters=model.parameters(), momentum=0.9),
                     lambda a, c: F.cross_entropy(model(a), c))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 3, 64, 64).astype(np.float32)).to(dev).bfloat16()
    y = torch.from_numpy(rng.randint(0, 1000, 8)).to(dev)
    counters = cs.training_counters()
    cs.zero_counts(counters)
    losses = [step(x, y).item() for _ in range(2)]
    assert all(np.isfinite(losses))
    assert cs.read_counts(counters) == cs.optimizer_launches(2, tensors=62)
    assert all(bool(st["velocity"].ne(0).any()) for st in step._opt_state)
    moved = sum(int(p.ne(p0).sum()) for p, p0 in zip(model.parameters(), start))
    assert moved > 0.5 * sum(p.numel() for p in start), moved
    stats = cs.bn_buffers(model)
    assert len(stats) == 40 and all(bool(torch.isfinite(t).all()) for t in stats)
    assert all(not torch.equal(m, torch.zeros_like(m)) for m in stats[0::2])


def test_device_loader_equals_the_cpu_loader(dev):
    import chip_smoke as cs

    seconds = cs.loader_bits(0)
    assert set(seconds) == {"cpu_workers_0", "cuda_workers_0", f"cuda_workers_{cs.FLOWERS_WORKERS}"}


def test_model_fit_on_the_card(dev):
    import chip_smoke as cs

    got = cs.hapi_card_vs_cpu(0)
    assert got["launches"] == cs.HAPI_CHECK_STEPS and got["max_rel_diff"] <= got["limit"]


# Mixture of Experts, chip_smoke.py phase 22b-c at small widths (hidden 512,
# head_dim 128, 4 experts, 2 layers): dense against sort dispatch on each
# layer's own input (decisions, combine weights, aux losses and two sort runs
# bit for bit in bf16; outputs and gradients within MOE_PATH_F32_FRAC in
# f32), a 1-layer MoE Llama in f32 on the card against the CPU, and step 1's
# loss and gradients under each recompute policy against "none" (within
# phase 6's limits; bit for bit printed) with the recomputed forwards'
# flash and RMSNorm launches counted
MOE_CARD_CFG = dict(hidden_size=512, intermediate_size=1024, num_attention_heads=4,
                    num_key_value_heads=2, vocab_size=4096, moe_num_experts=4)


def test_moe_dense_and_sort_dispatch_agree_on_the_card(dev):
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig

    out = cs.moe_dispatch_check(0, cfg=LlamaConfig.tiny(**MOE_CARD_CFG), seq=512,
                                phase="card test")
    assert out["decisions_bit_for_bit"] and out["f32_worst_frac"] <= out["f32_tol"]


def test_moe_llama_on_the_card_matches_the_cpu(dev):
    import chip_smoke as cs

    out = cs.moe_card_vs_cpu(0, phase="card test")
    assert out["worst_grad_frac"] <= out["grad_tol"]


def test_moe_recompute_policies_on_the_card(dev):
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(**MOE_CARD_CFG), device=dev,
                             dtype=torch.bfloat16, seed=0)
    out = cs.moe_recompute_grads(model, cs.token_batch(np.random.RandomState(1), 512, 4096))
    print(f"moe recompute card test: {out}")
    assert set(out) == {"none", "every_layer", "selective"}


# the op surface: each op's first case of paddle_tpu_torch.tools.op_cases on
# the card against the CPU (chip_smoke.py phase 23b runs every case), one
# test a group of the registry's modules; drawing ops by shape, dtype, their
# check of values and replay from one generator state
OP_GROUPS = (("math", "logic"), ("manipulation", "search"), ("creation", "linalg"), ("nn_",))


@pytest.mark.parametrize("group", OP_GROUPS, ids=[g[0] for g in OP_GROUPS])
def test_op_surface_on_the_card_matches_the_cpu(dev, group):
    from paddle_tpu_torch.ops.registry import OP_REGISTRY
    from paddle_tpu_torch.tools import op_cases as oc

    firsts = {}
    for n, case in enumerate(oc.CASES):
        if case.op not in firsts and OP_REGISTRY[case.op].module.startswith(group):
            firsts[case.op] = n
    res = oc.card_vs_cpu(0, only=sorted(firsts.values()))
    print(f"op surface card test {group}: {res['held']} held, worst {res['worst']} "
          f"at {res['worst_case']}")
    assert res["failures"] == [] and res["held"] == len(firsts) > 0


# a layer's default draw on the card comes from the port's generator of the
# card: seed(0) twice gives the same Linear, Conv2D (bias included) and
# Embedding, and torch's own CUDA generator is neither read nor advanced
def test_layer_default_draws_follow_the_ports_seed_on_the_card(dev):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    def build():
        paddle.seed(0)
        layers = (nn.Linear(64, 32), nn.Conv2D(4, 8, 3), nn.Embedding(16, 8))
        return [t.detach().clone() for m in layers for t in m.state_dict().values()]

    saved = torch.cuda.get_rng_state()
    try:
        a = build()
        assert torch.equal(torch.cuda.get_rng_state(), saved)
        torch.cuda.manual_seed(12345)
        b = build()
    finally:
        torch.cuda.set_rng_state(saved)
    assert all(t.is_cuda for t in a) and all(torch.equal(x, y) for x, y in zip(a, b))


# chip_smoke.py phase 23a at a small width (hidden 512, 4 heads of 128, 2
# layers, S 512): OpsLlama's eager step (loss.backward(); opt.step();
# opt.clear_grad()) launches flash forward and backward once a layer, RMSNorm
# fused 2 L + 1 times each way and the fused update once; its loss equals
# LlamaForCausalLM's with the same weights bit for bit
def test_ops_llama_eager_step_launches_the_kernels(dev):
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(hidden_size=512, intermediate_size=1024, num_attention_heads=4,
                           num_key_value_heads=2, vocab_size=4096)
    model = cs.ops_llama_class()(cfg, dtype="bfloat16")
    ref = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    assert model.set_state_dict(ref.state_dict()) == ([], [])
    assert model.parameters()[0].device.type == "cuda"
    ids, labels = cs.token_batch(np.random.RandomState(0), 512, 4096)
    opt = AdamW(3e-4, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    counters = cs.training_counters()
    cs.zero_counts(counters)
    loss = model(ids, labels=labels)[0]
    loss.backward()
    opt.step()
    opt.clear_grad()
    want = cs.expected_launches(cfg.num_hidden_layers, traced=False)
    want.update(multi_tensor_update=1, multi_tensor_update_direct=1)
    assert cs.read_counts(counters) == want
    assert float(loss) == float(ref(ids, labels=labels)[0])


def _dist_ranks(tmp_path, nproc, phase, env=None):
    """Launch ``paddle_tpu_torch/tools/dist_train.py`` at tiny widths through
    the launcher: (exit code, launcher output and logs, each rank's json)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
           str(nproc), "--log_dir", str(tmp_path / "log"), "paddle_tpu_torch/tools/dist_train.py",
           "--phase", phase, "--out", str(tmp_path), "--tiny", "--layers", "2", "--seq", "512",
           "--steps", "2", "--check-seq", "256"]
    out = subprocess.run(cmd, cwd=str(root), env=dict(os.environ, **(env or {})),
                         capture_output=True, text=True, timeout=300)
    logs = out.stdout + out.stderr + "".join(
        p.read_text() for p in sorted((tmp_path / "log").glob("workerlog.*")))
    res = [json.loads((tmp_path / f"dist_{phase}.{r}.json").read_text()) for r in range(nproc)
           if (tmp_path / f"dist_{phase}.{r}.json").exists()]
    return out.returncode, logs, res


# one NCCL rank: fleet.init, group_sharded_parallel("p_g_os"), TrainStep on the
# sharded model: step 1 bit for bit as TrainStep, then exact launches a step
def test_dist_nccl_world_one_through_launch(dev, tmp_path):
    rc, logs, res = _dist_ranks(tmp_path, 1, "a")
    assert rc == 0, logs
    (a,) = res
    assert a["backend"] == "nccl" and a["check_params_equal"] == a["check_params"]
    assert a["check_loss"] == a["check_loss_plain"]
    assert a["launches"] == {"flash_wgmma_fwd": 4, "flash_wgmma_bwd": 4,
                             "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
                             "rms_norm_fwd_round_first": 10, "rms_norm_bwd_dx_round_first": 10,
                             "multi_tensor_update": 2}
    assert not a["collectives_per_step"]     # one data rank: nothing to sum


# two gloo ranks on the one card: DataParallel's reduced gradients and the
# parameters after one step bit-identical across the ranks; rank 0's reduced
# gradients within GRAD_TOL of a leaf's largest entry of the one-process
# backward on the whole batch, and the two planted faults (no division by
# the world, no reduce) beyond it
def test_dist_data_parallel_two_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL

    rc, logs, res = _dist_ranks(tmp_path, 2, "b", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    assert res[0]["grad_checksums"] == res[1]["grad_checksums"]
    assert res[0]["param_checksums"] == res[1]["param_checksums"]
    assert res[0]["backend"] == "gloo" and res[0]["device"] == res[1]["device"] == "cuda:0"
    assert res[0]["grad_vs_ref_beyond_tol"] == 0
    assert res[0]["grad_vs_ref_max_rel"] <= GRAD_TOL
    assert all(e > GRAD_TOL for e in res[0]["planted_faults_max_rel"].values())
    assert res[0]["vs_trainstep_beyond_tol"] == 0


# two gloo ranks on the one card at tensor 2: the semi-auto API's round trip
# on CUDA tensors; each rank's slices of the reduced gradients within
# GRAD_TOL of a one-process backward, the two planted faults beyond it, the
# uncut parameters bit-identical across the ranks after a step, with and
# without sequence parallelism; exact launches of the timed steps
def test_dist_tensor_parallel_two_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL

    rc, logs, res = _dist_ranks(tmp_path, 2, "t", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    assert all(res[0]["semi_auto"].values())
    for key in ("check", "check_sp"):
        assert res[0][key]["uncut_checksums"] == res[1][key]["uncut_checksums"]
        assert res[0][key]["grad_vs_ref_max_rel"] <= GRAD_TOL
    assert all(e > GRAD_TOL for e in res[0]["check"]["planted_faults_max_rel"].values())
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["launches"] == {"flash_wgmma_fwd": 4, "flash_wgmma_bwd": 4,
                                 "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
                                 "rms_norm_fwd_round_first": 10,
                                 "rms_norm_bwd_dx_round_first": 10, "multi_tensor_update": 2}
        assert r["collectives_per_step"]["all_reduce"] > 0


# two gloo ranks on the one card at pp 2 (the Llama split into embedding,
# decoder layers, norm and head): every style's reassembled gradients within
# GRAD_TOL of a one-process traced backward, both planted faults beyond it,
# 1F1B's peak memory on stage 0 below FThenB's, exact launches of the timed
# steps on each stage
def test_dist_pipeline_two_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, PIPE_M, PIPE_STYLES

    rc, logs, res = _dist_ranks(tmp_path, 2, "p", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    check = res[0]["check"]
    for style, _, _ in PIPE_STYLES:
        assert check[style]["grad_vs_ref_beyond_tol"] == 0 and check[style]["leaves_checked"]
        assert check[style]["grad_vs_ref_max_rel"] <= GRAD_TOL
    assert all(e > GRAD_TOL for e in check["planted_faults_max_rel"].values())
    mem = res[0]["memory"]
    assert mem["1f1b"]["peak_above_rest_gib"] < mem["fthenb"]["peak_above_rest_gib"]
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        norms = PIPE_M * (2 + r["rank"]) * 2
        assert r["launches"] == {"flash_wgmma_fwd": PIPE_M * 2, "flash_wgmma_bwd": PIPE_M * 2,
                                 "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
                                 "rms_norm_fwd_round_first": norms,
                                 "rms_norm_bwd_dx_round_first": norms, "multi_tensor_update": 2}
        assert r["transfers_per_step"]["send"] == r["transfers_per_step"]["recv"] == PIPE_M


# four gloo ranks on the one card at pp 2 x tensor 2 (phase 27's mesh at 2
# layers, one a stage): every style's gradients gathered over pipe and tensor
# within GRAD_TOL of a one-process traced backward, both planted faults
# beyond it, exact launches and bytes between stages (half the sequence) on
# each rank, and pp 2 x sharding 2's optimizer state half a stage's
def test_dist_hybrid_four_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, HY_M, HY_STYLES

    rc, logs, res = _dist_ranks(tmp_path, 4, "h", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    check = res[0]["check"]
    for style, _, _, spec in HY_STYLES:
        c = check[f"{style}_spec{int(spec)}"]
        assert c["grad_vs_ref_beyond_tol"] == 0 and c["leaves_checked"], c
        assert c["grad_vs_ref_max_rel"] <= GRAD_TOL
    assert all(check[f"1f1b_spec1_{p}"]["grad_vs_ref_max_rel"] > GRAD_TOL
               for p in ("unsummed", "wrong_peer"))
    assert res[0]["shard"]["grad_vs_ref_beyond_tol"] == 0
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["shard"]["state_numel"] * 2 == r["shard"]["pp2_state_numel"]
        stage = r["rank"] // 2
        norms = HY_M * (2 + stage) * 2
        assert r["launches"] == {"flash_wgmma_fwd": HY_M * 2, "flash_wgmma_bwd": HY_M * 2,
                                 "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
                                 "rms_norm_fwd_round_first": norms,
                                 "rms_norm_bwd_dx_round_first": norms, "multi_tensor_update": 2}
        # 4 microbatches of [1, 64 of 128, 256] bf16 each way
        assert r["transfer_bytes_per_step"]["send"] == HY_M * 64 * 256 * 2
        assert r["transfer_bytes_per_step"]["recv"] == HY_M * 64 * 256 * 2


# two gloo ranks on the one card at sep 2 (phase 28's mesh at tiny widths):
# the ring across processes bit for bit the one-process ring and within
# GRAD_TOL of the largest entry of the plain full attention, the ring's and Ulysses' gradients
# within GRAD_TOL of a one-process traced backward, the planted fault (RoPE
# without the rank's offset) beyond it, exact launches and ring bytes
def test_dist_sep_two_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, sep_bytes, sep_expected

    rc, logs, res = _dist_ranks(tmp_path, 2, "s", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    check = res[0]["check"]
    for name in ("ring", "ulysses"):
        c = check[name]
        assert c["grad_vs_ref_beyond_tol"] == 0 and c["leaves_checked"], c
    assert check["ring_no_offset"]["grad_vs_ref_max_rel"] > GRAD_TOL
    cfg = LlamaConfig.tiny(num_attention_heads=4, num_key_value_heads=2)
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        v = r["vs_one_process"]
        assert all(v["bit_identical"].values()), v
        assert max(v["vs_plain_max_rel"].values()) <= GRAD_TOL, v
        assert r["launches"] == sep_expected(r["sep_index"], 2, 2)
        assert r["collective_bytes_per_step"]["send"] == sep_bytes(cfg, 512, 2, 2)


# two gloo ranks on the one card, expert parallelism (phase 29's checks at
# tiny widths, 4 experts): the experts over dp (the all-to-all), at a capacity
# where tokens drop with the planted fault of per-rank routing, and over
# tensor, each within GRAD_TOL of a one-process traced backward (the fault
# beyond it), its router logits and loss within their bounds; exact launches, the all-to-all's bytes from its rows and every
# kept choice sent and returned
def test_dist_ep_two_gloo_ranks_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, ep_expected

    rc, logs, res = _dist_ranks(tmp_path, 2, "e", {"PADDLE_DISTRI_BACKEND": "gloo"})
    assert rc == 0, logs
    r0 = res[0]
    for name in ("check_dp", "check_fault", "check_tensor"):
        c = r0[name]["check"]
        assert c["grad_vs_ref_beyond_tol"] == 0 and c["leaves_checked"], (name, c)
        assert c["logits_max_ulps"] <= c["logits_tol_ulps"], (name, c)
        assert c["loss_rel_diff"] <= c["loss_rtol"], (name, c)
    assert r0["check_fault"]["alone"]["grad_vs_ref_max_rel"] > GRAD_TOL
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["launches"] == ep_expected(2, 2) == r["expected_launches"]
        assert r["collective_bytes"]["all_to_all_single"] == 2 * sum(r["a2a_rows"]) * 256 * 2
        assert r["collective_bytes"]["fused_allreduce"] == 4 * r["replicated_params"] * 2
    for layer in range(2):
        assert sum(r["a2a_rows"][layer] for r in res) == 2 * r0["kept_rows"][layer] > 0


# NCCL with more ranks than cards raises and names the card, never falls
# back to gloo
def test_dist_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a machine with exactly one card")
    rc, logs, _ = _dist_ranks(tmp_path, 2, "a")
    assert rc == 1
    assert "would share cuda:0" in logs


# the numerics sentinels' reduction: digests and counts are integers (exact
# on both sides); a sum of squares is the same f32 terms summed in another
# order, at most 1e-5 relative over these sizes.
SENTINEL_SQ_RTOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_profiler_sentinel_stats_match_the_plain_version(dev, dtype):
    from paddle_tpu_torch.ops import sentinels

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    sizes = (1, 7, 4097, 65536, 65536 + 3, 2 ** 20 + 5)
    ts = [torch.randn(n, device=dev, generator=g, dtype=torch.float32).to(dtype) for n in sizes]
    ts[2][5] = float("nan")
    ts[4][-1] = float("-inf")
    ts[5][::100003] = float("inf")
    ts.append(torch.randn(64, 3, device=dev, generator=g).to(dtype).t())  # not contiguous
    ts.append(torch.randn(33, device=dev, generator=g).to(dtype)[1:])     # not 16-byte aligned
    before = sentinels.tensor_stats.launches
    sq, ints = sentinels.tensor_stats(ts)
    sq2, ints2 = sentinels.tensor_stats(ts)
    assert sentinels.tensor_stats.launches == before + 2
    psq, pints = sentinels.tensor_stats_plain(ts)
    assert torch.equal(ints, pints)
    # the same bits twice (NaN sums included: compared as bits)
    assert torch.equal(sq.view(torch.int32), sq2.view(torch.int32)) and torch.equal(ints, ints2)
    fin = torch.isfinite(psq)
    assert torch.equal(fin, torch.isfinite(sq))
    torch.testing.assert_close(sq[fin], psq[fin], rtol=SENTINEL_SQ_RTOL, atol=0)
    assert int(ints[1, 2]) == 1 and int(ints[1, 4]) == 1 and int(ints[1, 5]) == 11


def test_profiler_train_step_sentinels_on_the_card(dev):
    """A tiny Llama TrainStep on the card: the sentinels launch once a step,
    the step's bits do not depend on them, grad_norm is the global-norm
    clip's norm of the same gradients, and a poisoned group is named."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import sentinels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import telemetry

    cfg = LlamaConfig.tiny()
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    runs = {}
    for mode in ("off", "summary"):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        opt = AdamW(1e-3, parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, opt, lambda x, y, m=model: m(x, labels=y)[0], numerics=mode)
        before = sentinels.tensor_stats.launches
        losses = [step(ids, ids).item() for _ in range(3)]
        launched = sentinels.tensor_stats.launches - before
        runs[mode] = (losses, [p.detach().clone() for p in model.parameters()], launched, step)
    assert runs["off"][0] == runs["summary"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["off"][1], runs["summary"][1]))
    assert (runs["off"][2], runs["summary"][2]) == (0, 3)
    step = runs["summary"][3]
    model = step.model
    loss = model(ids, labels=ids)[0].float()
    grads = torch.autograd.grad(loss, [p for p in model.parameters()])
    want = torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
                          for g in grads)).item()
    telemetry.reset()
    step(ids, ids)
    assert telemetry.gauge("train.grad_norm").value == pytest.approx(want, rel=1e-3)
    with torch.no_grad():
        model.lm_head.weight[0, 0] = float("nan")
    step(ids, ids)
    assert step._num_watchdog.last_event["groups"]["lm_head"]["param"] == 1


def test_profiler_gpu_target_times_the_kernels_under_each_span(dev, tmp_path):
    """Profiler(targets=[CPU, GPU]) on the card: the kernels of a flash
    call run under a span are in the trace by name and linked to it."""
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget, spans

    q, k, v = (torch.randn(1, 512, 4, 64, device=dev, dtype=torch.bfloat16) for _ in range(3))
    fa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    with Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU]) as prof:
        with spans.span("jit.dispatch"):
            fa.flash_attention_fwd(q, k, v, True)
            (q.float() @ k.float().transpose(-1, -2)).sum()
        torch.cuda.synchronize()
    summary = prof.device_trace_summary(("jit.dispatch",))
    row = summary["annotations"]["jit.dispatch"]
    assert row["kernels"] >= 2 and row["device_ms"] > 0
    assert row["device_ms"] == pytest.approx(summary["device_ms"], rel=0.05)
    names = {e["name"] for e in __import__("json").load(open(prof.export(
        str(tmp_path / "t.json"))))["traceEvents"]}
    assert any("flash_fwd_kernel" in n for n in names)
