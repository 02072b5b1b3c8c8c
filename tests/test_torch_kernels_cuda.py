"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (sm_90a) with nvcc; without one they skip.
Run them on the card with::

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

They cover shapes chip_smoke.py does not: other block sizes, head dims
and GQA ratios, f32 attention, ragged M and odd K/N for the GEMM, and the
checks that refuse what a kernel does not take.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda

# attention: the plain version rounds probabilities to q's dtype before the
# weighted sum, the kernel keeps f32; outputs mix N(0, 1) rows.
ATTN_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# GEMM: the same f32 sum in another order, rounded once to bf16.
GEMM_RTOL, GEMM_ATOL_FRAC = 2.0 ** -7, 1e-3


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
