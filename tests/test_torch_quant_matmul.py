"""PyTorch port: int8 weight-only matmul and decode-weight quantization.

The port's plain version ``int8_matmul_ref`` (what the wrapper runs on CPU
tensors) is held against the reference's Pallas kernel in interpret mode
and against its composed ``int8_matmul_xla``; the port's
``quantize_decode_weights`` must give bit-identical int8 values and
scales. The CUDA kernel itself is held against ``int8_matmul_ref`` on the
card (tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import llama as ref_llama
from paddle_tpu.ops.pallas import quant_matmul as ref_qm
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.ops import quant_matmul as port_qm

# f32: exact products, sums over K <= 256 in another order; outputs reach
# ~1e2, so 1e-5 relative plus 1e-4 absolute covers the reassociation.
F32_RTOL, F32_ATOL = 1e-5, 1e-4
# bf16 activations: the same f32 sum, rounded once to bf16 on both sides;
# a different summation order may flip that rounding by one step (2^-7
# relative at most).
BF16_RTOL = 2.0 ** -7


def _case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (np.abs(rng.randn(n)) * 0.1 + 1e-3).astype(np.float32)
    return x, w, s


def _port(x, w, s):
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (8, 128, 48), (24, 32, 16),
                                   (64, 256, 128)])
def test_ref_matches_pallas_interpret_and_xla(m, k, n):
    x, w, s = _case(m, k, n, seed=m * 7 + k + n)
    want_pallas = np.asarray(ref_qm.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(s)))
    want_xla = np.asarray(ref_qm.int8_matmul_xla(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.asarray(s)))
    got = port_qm.int8_matmul_ref(*_port(x, w, s)).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(got, want_xla, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("m", [1, 3, 8, 17])
def test_ref_bf16_matches_xla_any_m(m):
    """The port takes any M (the reference gate declines m % 8 != 0 and
    falls back to int8_matmul_xla, which is what this compares with)."""
    x, w, s = _case(m, 64, 48, seed=100 + m)
    xb = torch.from_numpy(x).bfloat16()
    got = port_qm.int8_matmul_ref(xb, torch.from_numpy(w), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    want = ref_qm.int8_matmul_xla(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(w), jnp.asarray(s))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=0)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    x, w, s = _case(5, 32, 16, seed=1)
    before = port_qm.int8_matmul.launches
    got = port_qm.int8_matmul(*_port(x, w, s))
    want = port_qm.int8_matmul_ref(*_port(x, w, s))
    assert torch.equal(got, want)
    assert port_qm.int8_matmul.launches == before


@pytest.mark.parametrize("bad, err", [
    (dict(x_dtype=torch.float64), TypeError),
    (dict(k=24), ValueError),
    (dict(n=40), ValueError),
    (dict(transpose_x=True), ValueError),
    (dict(w_dtype=torch.uint8), TypeError),
])
def test_card_checks_reject_what_the_kernel_does_not_take(bad, err):
    """The checks run before any launch on the card; on a CPU tensor they
    can be exercised directly."""
    k, n = bad.get("k", 32), bad.get("n", 32)
    x = torch.zeros((4, k), dtype=bad.get("x_dtype", torch.bfloat16))
    if bad.get("transpose_x"):
        x = torch.zeros((k, 4), dtype=torch.bfloat16).t()
    w = torch.zeros((k, n), dtype=bad.get("w_dtype", torch.int8))
    s = torch.ones((n,), dtype=torch.float32)
    with pytest.raises(err):
        port_qm._check(x, w, s)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 9, 16, 64])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 128256), (32, 16)])
def test_split_plan_covers_k_once(M, K, N):
    """The weight stream's schedule (``stream_plan``): every K row in exactly
    one slice of whole 128-row blocks, every slice non-empty, at most 8
    slices (one portable cluster a column tile), K cut only where the
    column tiles leave more than a quarter of the 132 SMs idle, and then
    the grid at most 1.75 blocks an SM."""
    kc, ksplit, blocks = port_qm.stream_plan(M, K, N, sms=132)
    tiles = -(-N // 128)
    assert kc % 128 == 0 and 1 <= ksplit <= 8
    assert kc * ksplit >= K > kc * (ksplit - 1)      # every row once, every slice non-empty
    rows = sorted(r for q in range(ksplit) for r in range(q * kc, min(K, (q + 1) * kc)))
    assert rows == list(range(K))
    assert blocks == tiles * ksplit
    if tiles >= 0.75 * 132:
        assert ksplit == 1
    else:
        assert blocks <= 1.75 * 132


# the weight stream's sum order (int8_matmul_blocked) against the reference:
# f32 x sums the same exact products (its three bf16 pieces' products add
# up to x * w exactly) in another order: an f32 sum over K = 1040 carries a
# few ulps of its largest partial sums, so 1e-5 relative plus 1e-5 of the
# largest output (chip_smoke.py's GEMM_F32_RTOL / GEMM_F32_ATOL_FRAC).
# bf16 x: one bf16 rounding of f32 sums taken in another order on each side,
# a step apart at most (2^-7 relative), plus 1e-3 of the largest output for
# the sums that cancel near zero (GEMM_RTOL / GEMM_ATOL_FRAC).
BLOCKED_F32_ATOL_FRAC, BLOCKED_ATOL_FRAC = 1e-5, 1e-3


@pytest.mark.parametrize("M", [1, 3, 8, 16, 33, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_sum_order_matches_reference(M, dtype):
    """K = 1040, N = 384: three column tiles, so the plan cuts K into 5
    slices of 256 rows, the last of 16 (a quarter of a 64-row stage); the
    reference's Pallas kernel (interpret mode) takes M % 8 == 0, its
    composed int8_matmul_xla the other M."""
    K, N = 1040, 384
    x, w, s = _case(M, K, N, seed=M + (dtype == "float32"))
    kc, ksplit, _ = port_qm.stream_plan(M, K, N, sms=132)
    assert (kc, ksplit) == (256, 5)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = port_qm.int8_matmul_blocked(xt, torch.from_numpy(w), torch.from_numpy(s)).float()
    xj = jnp.asarray(xt.float().numpy(), getattr(jnp, dtype))
    ref = ref_qm.int8_matmul if M % 8 == 0 else ref_qm.int8_matmul_xla
    want = np.asarray(ref(xj, jnp.asarray(w), jnp.asarray(s)).astype(jnp.float32))
    plain = port_qm.int8_matmul_ref(xt, torch.from_numpy(w), torch.from_numpy(s)).float()
    if dtype == "float32":
        atol = BLOCKED_F32_ATOL_FRAC * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=atol)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_RTOL, atol=atol)
    else:
        atol = BLOCKED_ATOL_FRAC * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL, atol=atol)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=BF16_RTOL, atol=atol)


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)

    def mat(k, n):
        return rng.randn(k, n).astype(np.float32)

    layers = []
    for _ in range(2):
        lw = {"input_ln": np.ones(16, np.float32), "post_ln": np.ones(16, np.float32),
              "q": mat(16, 16), "k": mat(16, 8), "v": mat(16, 8), "o": mat(16, 16),
              "gate": mat(16, 32), "up": mat(16, 32), "down": mat(32, 16)}
        layers.append(lw)
    # a zero column (scale 1) and exact .5 ties under scale 1 (amax 127):
    # round-half-to-even must agree on both sides
    layers[0]["q"][:, 3] = 0.0
    layers[0]["q"][:6, 5] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0]
    layers[0]["q"][6:, 5] = 0.0
    return {"embed": mat(32, 16), "norm": np.ones(16, np.float32),
            "lm_head": mat(16, 32), "layers": layers}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_decode_weights_bit_identical(dtype):
    tree = _tree(5)
    port_tree = port_llama.weights_from_numpy(tree, device="cpu",
                                               dtype=getattr(torch, dtype))
    # the reference sees exactly the (possibly bf16-rounded) same values
    ref_tree = {
        "embed": jnp.asarray(port_tree["embed"].float().numpy(), dtype),
        "norm": jnp.asarray(port_tree["norm"].float().numpy(), dtype),
        "lm_head": jnp.asarray(port_tree["lm_head"].float().numpy(), dtype),
        "layers": [{k: jnp.asarray(v.float().numpy(), dtype) for k, v in lw.items()}
                   for lw in port_tree["layers"]],
    }
    want = ref_llama.quantize_decode_weights(ref_tree)
    got = port_llama.quantize_decode_weights(port_tree)
    pairs = [(got["lm_head"], want["lm_head"])]
    for gl, wl in zip(got["layers"], want["layers"]):
        pairs += [(gl[p], wl[p]) for p in ("q", "k", "v", "o", "gate", "up", "down")]
    for g, w in pairs:
        assert g["qw"].dtype == torch.int8 and g["scale"].dtype == torch.float32
        np.testing.assert_array_equal(g["qw"].numpy(), np.asarray(w["qw"]))
        np.testing.assert_array_equal(g["scale"].numpy().view(np.uint32),
                                      np.asarray(w["scale"]).view(np.uint32))
    q5 = got["layers"][0]["q"]["qw"][:6, 5].tolist()
    assert q5 == [0, 2, 2, 0, -2, 127]
    assert got["layers"][0]["q"]["scale"][3].item() == 1.0
    assert got["embed"] is port_tree["embed"]
