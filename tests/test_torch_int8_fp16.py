"""PyTorch port: int8 weight-only matmul with fp16 activations and at
shapes the kernels do not take, on the CPU.

Two routes meet here, each the reference's:

- ``nn.quant.weight_only_linear`` sends an int8 call to the kernels only
  where the reference's gate sends it to its own (``nn/quant.py:158-164``:
  f32 or bf16 x, shapes the kernel takes; here K and N multiples of 16,
  ``quant_matmul.kernel_takes``); fp16 and other shapes stay on the
  composed dequantize-then-matmul (the reference's ``_wol_xla``). The
  gate's route is held on stand-ins for CUDA tensors (the gate reads only
  dtype and shape), and the composed results, forward and dX, against the
  reference's ``weight_only_linear``;
- the serving path (``decode_matmul`` -> ``int8_matmul``, the reference's
  ``matmul_gate``, which has no dtype rule) sends an fp16 engine's
  projections to the kernels: the weight stream (M <= 64) and the
  tensor-core kernel (M > 64) now have fp16 instantiations (fp16 products,
  f32 sums). Their plain versions and the stream's sum order
  (``int8_matmul_blocked``) are held against the reference's composed
  ``int8_matmul_xla`` in fp16 at the decode shapes' M; the kernels against
  them on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: the same exact products (an int8 weight is exact in fp16, an
fp16 x int8 product exact in f32) summed in f32 in another order, then
one rounding to fp16 on each side: one fp16 step (2^-10 relative) plus
1e-3 of the output's largest magnitude (f32 partial sums); in bf16 one
bf16 step (2^-7); f32 as tests/test_torch_int8_f32.py holds it. Where the
reference's gate takes a bf16 shape the port's does not (K or N a
multiple of 8 but not of 16: its rule off a TPU), its kernel's dX rounds
each ``dout * s`` to bf16 first, and dX is held to 2^-8 of the sum of the
terms' magnitudes besides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.nn import quant as ref_q
from paddle_tpu.ops.pallas import quant_matmul as ref_qm
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.nn import quant as port_q
from paddle_tpu_torch.ops import quant_matmul as port_qm

RTOL = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
ATOL_FRAC = {torch.float16: 1e-3, torch.bfloat16: 1e-3, torch.float32: 1e-5}


def _case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (np.abs(rng.randn(n)) * 0.01 + 1e-3).astype(np.float32)
    dout = rng.randn(m, n).astype(np.float32)
    return x, w, s, dout


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=ATOL_FRAC[dtype] * np.abs(want).max())


class _CudaLike:
    """What the gate reads of a CUDA tensor: device, dtype and shape."""

    def __init__(self, dtype, shape):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, torch.Size(shape)


@pytest.mark.parametrize("dtype,k,n,want", [
    (torch.bfloat16, 4096, 1024, True), (torch.float32, 64, 48, True),
    (torch.float16, 4096, 1024, False),            # fp16: composed, as the reference
    (torch.bfloat16, 24, 48, False),               # K not a multiple of 16
    (torch.float32, 64, 40, False),                # N not a multiple of 16
    (torch.float64, 64, 48, False),
])
def test_gate_route_on_cuda_stand_ins(dtype, k, n, want):
    assert port_qm.kernel_takes(_CudaLike(dtype, (8, k)), k, n) is want


@pytest.mark.parametrize("dtype,k,n,kernel", [
    (torch.bfloat16, 64, 48, True), (torch.float16, 64, 48, False),
    (torch.bfloat16, 24, 40, False), (torch.float32, 40, 24, False),
])
def test_weight_only_linear_takes_the_gates_route(monkeypatch, dtype, k, n, kernel):
    """The op a call reaches: the kernels' differentiable op where the gate
    sends it, the composed form elsewhere (which never calls it)."""
    seen = []
    real = port_qm.int8_matmul_frozen
    monkeypatch.setattr(port_qm, "int8_matmul_frozen",
                        lambda *a: seen.append(1) or real(*a))
    x, w, s, _ = _case(4, k, n, seed=k + n)
    port_q.weight_only_linear(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                              weight_scale=torch.from_numpy(s))
    assert bool(seen) is kernel


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.float16, 8, 64, 48), (torch.float16, 40, 128, 256), (torch.float16, 3, 24, 40),
    (torch.bfloat16, 8, 24, 40), (torch.float32, 5, 40, 24), (torch.float32, 16, 72, 8),
])
def test_composed_route_matches_the_reference(dtype, m, k, n):
    """fp16 and misaligned shapes through ``weight_only_linear``, forward
    and dX, against the reference's on the same inputs."""
    x, w, s, dout = _case(m, k, n, seed=7 * m + k)
    ref_dtype = {torch.float16: "float16", torch.bfloat16: "bfloat16",
                 torch.float32: "float32"}[dtype]
    xr = paddle.to_tensor(x).astype(ref_dtype)
    xr.stop_gradient = False
    out_r = ref_q.weight_only_linear(xr, paddle.to_tensor(w), weight_scale=paddle.to_tensor(s))
    (out_r.astype("float32") * paddle.to_tensor(dout)).sum().backward()
    xp = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out_p = port_q.weight_only_linear(xp, torch.from_numpy(w), weight_scale=torch.from_numpy(s))
    out_p.float().backward(torch.from_numpy(dout))
    assert out_p.dtype == dtype and out_p.shape == (m, n)
    _close(out_p.detach().float().numpy(), np.asarray(out_r._data, np.float32), dtype)
    got, want = xp.grad.float().numpy(), np.asarray(xr.grad._data, np.float32)
    if dtype == torch.bfloat16:
        # the reference's gate takes this shape (multiples of 8 off a TPU)
        # to its kernel, whose dX rounds each dout * s to bf16 before the
        # sum: up to 2^-8 of each term
        slack = 2.0 ** -8 * (np.abs(dout) * s) @ np.abs(w.astype(np.float32)).T
        assert np.all(np.abs(got - want) <= slack + RTOL[dtype] * np.abs(want))
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("m", [1, 8, 16, 64, 65, 200])
def test_fp16_plain_versions_match_the_reference(m):
    """What the fp16 kernels compute, on the CPU: the plain version (both
    kernels) and the weight stream's sum order (M <= 64) against the
    reference's composed ``int8_matmul_xla`` in fp16."""
    x, w, s, _ = _case(m, 256, 384, seed=m)
    x16 = x.astype(np.float16)
    want = np.asarray(ref_qm.int8_matmul_xla(jnp.asarray(x16), jnp.asarray(w), jnp.asarray(s)))
    args = (torch.from_numpy(x16), torch.from_numpy(w), torch.from_numpy(s))
    fns = [port_qm.int8_matmul, port_qm.int8_matmul_large_m]
    if m <= port_qm.LARGE_M:
        fns.append(port_qm.int8_matmul_blocked)
    for fn in fns:
        got = fn(*args)
        assert got.dtype == torch.float16
        _close(got.float().numpy(), want, torch.float16)
    assert port_qm.stream_warps(16, torch.float16) == port_qm.stream_warps(16, torch.bfloat16)


def test_fp16_decode_matmul_matches_the_reference():
    """An fp16 int8 engine's projection: the serving seam on both sides."""
    x, w, _, _ = _case(8, 128, 96, seed=3)
    wf = (np.random.RandomState(4).randn(128, 96) * 0.05).astype(np.float32)
    ref_leaf = ref_llama.quantize_decode_weights(
        {"embed": None, "norm": None, "lm_head": wf, "layers": []})["lm_head"]
    leaf = {k: torch.from_numpy(np.asarray(v)) for k, v in ref_leaf.items()}
    want = np.asarray(ref_llama.decode_matmul(jnp.asarray(x, jnp.float16), ref_leaf))
    got = port_llama.decode_matmul(torch.from_numpy(x).half(), leaf)
    assert got.dtype == torch.float16
    _close(got.float().numpy(), want, torch.float16)
