"""PyTorch port: int8 weight-only fine-tuning (``nn.quant``) and SwiGLU
against the reference, on the CPU.

The port runs its plain kernel versions (CPU tensors); the reference runs
its Pallas kernels in interpret mode (M a multiple of 8, so that its shape
gate picks the kernel). Inputs are numpy arrays from a seed, handed to
both. Checked here: the dX of the int8 GEMM and the scales' gradient; the
quantizers bit for bit (int8, int4, fp8, with ties and an all-zero
column); ``weight_dequantize``; ``weight_only_linear``'s output and dx for
the three weight types, with and without bias; ``QuantizedLinear``'s
state-dict keys; a tiny Llama in f32 with all 14 projections swapped for
``QuantizedLinear`` on both sides (logits, loss, every trainable gradient,
a 5-call ``TrainStep`` trajectory); and ``swiglu_2d``. The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.nn import quant as ref_q
from paddle_tpu.ops.pallas import fused_norm as ref_fn
from paddle_tpu.ops.pallas import quant_matmul as ref_qm
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import quant as port_q
from paddle_tpu_torch.ops import fused_norm as port_fn
from paddle_tpu_torch.ops import quant_matmul as port_qm
from paddle_tpu_torch.optimizer import AdamW

# f32: products exact or within f32 rounding, sums over <= 256 terms in
# another order; values reach ~1e2: 1e-5 relative plus 1e-4 absolute.
F32_RTOL, F32_ATOL = 1e-5, 1e-4
# bf16: the same f32 sums rounded once to bf16 on both sides; another
# summation order may flip that rounding by one step (2^-7 relative), plus
# 1e-3 of the largest magnitude for a sum that cancels near zero.
BF16_RTOL, BF16_ATOL_FRAC = 2.0 ** -7, 1e-3
# the tiny Llama, as tests/test_torch_llama_train.py holds the bf16-free
# f32 model: logits, loss, and every gradient within 2e-4 of its tensor's
# largest entry (f32 sums in another order through 2 layers); the 5-call
# trajectory with the same bounds as there (AdamW's step lr * g / (|g| +
# eps) turns an f32 rounding difference of a gradient near zero into up to
# a fifth of one step on a few elements).
LOGITS_RTOL, LOGITS_ATOL, LOSS_RTOL, GRAD_FRAC = 1e-4, 1e-4, 1e-5, 2e-4
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL = 1e-5, 2e-6
TRAJ_OUTLIER_FRAC, TRAJ_OUTLIER_ATOL = 2e-4, 2e-4
# SwiGLU in f32: the same elementwise f32 formula, the sigmoid computed by
# two libraries (a few f32 ulps).
SWIGLU_F32_RTOL, SWIGLU_F32_ATOL = 1e-6, 1e-6

_ALGOS = ("weight_only_int8", "weight_only_int4", "weight_only_fp8")
_DTYPES = {"weight_only_int8": "int8", "weight_only_int4": "int4", "weight_only_fp8": "fp8"}


def _gemm_case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = (np.abs(rng.randn(n)) * 0.1 + 1e-3).astype(np.float32)
    dout = rng.randn(m, n).astype(np.float32)
    return x, w, s, dout


def _bf16(a):
    """numpy f32 -> the bf16-rounded values as f32 (the same on both sides)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _assert_close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = BF16_RTOL * np.abs(want) + BF16_ATOL_FRAC * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (8, 128, 48), (24, 32, 272)])
def test_dx_ref_matches_jax_grad_through_pallas(dtype, m, k, n):
    x, w, s, dout = _gemm_case(m, k, n, seed=m + k + n)
    if dtype == "bfloat16":
        x, dout = _bf16(x), _bf16(dout)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda xx: ref_qm.int8_matmul(xx, jnp.asarray(w), jnp.asarray(s)),
                     jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(dout, jdt))
    tdt = getattr(torch, dtype)
    got = port_qm.int8_matmul_dx_ref(torch.from_numpy(dout).to(tdt), torch.from_numpy(w),
                                     torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (m, k)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        _assert_close_bf16(got.float().numpy(), want)


def test_dx_ref_rounds_the_scaled_dout_before_the_sum():
    """In bf16 the product dO * bf16(s) rounds to bf16 before the f32 sum,
    as the TPU kernel does: the result differs from an f32 product."""
    rng = np.random.RandomState(3)
    dout = torch.from_numpy(rng.randn(8, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randint(-127, 128, (32, 64)).astype(np.int8))
    s = torch.from_numpy((rng.rand(64) * 0.01 + 1e-3).astype(np.float32))
    got = port_qm.int8_matmul_dx_ref(dout, w, s).float()
    rounded = (dout * s.bfloat16()).float() @ w.float().T
    unrounded = (dout.float() * s.bfloat16().float()) @ w.float().T
    assert torch.equal(got, rounded.bfloat16().float())
    assert not torch.equal(rounded, unrounded)


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (32, 48, 80)])
def test_train_scales_grads_match_reference(m, k, n):
    x, w, s, dout = _gemm_case(m, k, n, seed=7 * m + n)
    wj = jnp.asarray(w)
    _, vjp = jax.vjp(lambda xx, ss: ref_qm.int8_matmul_train_scales(xx, wj, ss),
                     jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(dout))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    out = port_qm.int8_matmul_train_scales(xt, torch.from_numpy(w), st)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=F32_RTOL,
                               atol=F32_ATOL)
    # d_scales sums m products of ~1e2: 1e-5 relative of the largest
    scale = np.abs(np.asarray(want_ds)).max()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_ds), rtol=F32_RTOL,
                               atol=1e-5 * scale)
    # the frozen op gives x its gradient and the scales none
    xt.grad, st.grad = None, None
    port_qm.int8_matmul_frozen(xt, torch.from_numpy(w), st).backward(torch.from_numpy(dout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=F32_RTOL,
                               atol=F32_ATOL)
    assert st.grad is None


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    x, w, s, dout = _gemm_case(72, 32, 16, seed=2)
    xt, wt, stt, dt = (torch.from_numpy(a) for a in (x, w, s, dout))
    counts = (port_qm.int8_matmul.launches, port_qm.int8_matmul_large_m.launches,
              port_qm.int8_matmul_dx.launches, port_fn.swiglu_fwd.launches,
              port_fn.swiglu_bwd.launches)
    assert torch.equal(port_qm.int8_matmul(xt, wt, stt), port_qm.int8_matmul_ref(xt, wt, stt))
    assert torch.equal(port_qm.int8_matmul_large_m(xt, wt, stt),
                       port_qm.int8_matmul_ref(xt, wt, stt))
    assert torch.equal(port_qm.int8_matmul_dx(dt, wt, stt),
                       port_qm.int8_matmul_dx_ref(dt, wt, stt))
    a, b = torch.from_numpy(x[:, :16]).contiguous(), torch.from_numpy(dout)
    assert torch.equal(port_fn.swiglu_fwd(a, b), port_fn.swiglu_fwd_ref(a, b))
    for g, r in zip(port_fn.swiglu_bwd(a, b, b), port_fn.swiglu_bwd_ref(a, b, b)):
        assert torch.equal(g, r)
    assert counts == (port_qm.int8_matmul.launches, port_qm.int8_matmul_large_m.launches,
                      port_qm.int8_matmul_dx.launches, port_fn.swiglu_fwd.launches,
                      port_fn.swiglu_bwd.launches)


@pytest.mark.parametrize("bad, err", [
    (dict(dtype=torch.float16), TypeError),
    (dict(k=24), ValueError),
    (dict(n=40), ValueError),
    (dict(width=48), ValueError),
    (dict(transpose=True), ValueError),
])
def test_dx_card_checks_reject_what_the_kernel_does_not_take(bad, err):
    """dX reads dout [M, N] against w [K, N]; the checks run before any
    launch and are exercised here on CPU tensors."""
    k, n = bad.get("k", 32), bad.get("n", 32)
    dout = torch.zeros((4, bad.get("width", n)), dtype=bad.get("dtype", torch.bfloat16))
    if bad.get("transpose"):
        dout = torch.zeros((n, 4), dtype=torch.bfloat16).t()
    w = torch.zeros((k, n), dtype=torch.int8)
    s = torch.ones((n,), dtype=torch.float32)
    with pytest.raises(err):
        port_qm._check(dout, w, s, "int8_matmul_dx", along=1)


def _weights(seed):
    """[64, 48] f32 weights with exact ties and an all-zero column for each
    algo: column 0 all zeros; column 1 with amax 127 (int8 scale 1: ties at
    .5); column 2 with amax 7 (int4 scale 1); column 3 with amax 448 (fp8
    scale 1: ties between e4m3 neighbours and subnormals)."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(64, 48) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = 0.0
    w[:6, 1] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0]
    w[:, 2] = 0.0
    w[:6, 2] = [0.5, 1.5, 2.5, -1.5, -6.5, 7.0]
    w[:, 3] = 0.0
    w[:8, 3] = [448.0, 1.0625, 1.1875, -1.0625, 2.0 ** -9 * 1.5, 2.0 ** -10, 3.0 * 2 ** -10, 0.1]
    return w


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.itemsize == 1 else a.view(np.uint32)


@pytest.mark.parametrize("algo", _ALGOS)
def test_weight_quantize_bit_identical(algo):
    w = _weights(11)
    rq, rs = ref_q.weight_quantize(w, algo=algo)
    pq, ps = port_q.weight_quantize(torch.from_numpy(w), algo=algo)
    want_q = np.asarray(rq.numpy())
    assert tuple(pq.shape) == want_q.shape and pq.dtype.itemsize == 1
    np.testing.assert_array_equal(_bits(pq.view(torch.uint8).numpy()), _bits(want_q))
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(np.asarray(rs.numpy())))
    # the ties rounded half to even, the zero column to zeros
    deq = port_q.weight_dequantize(pq, ps, algo).numpy()
    assert (deq[:, 0] == 0).all()
    if algo == "weight_only_int8":
        assert pq[:6, 1].tolist() == [0, 2, 2, 0, -2, 127]
    if algo == "weight_only_int4":
        assert deq[:6, 2].tolist() == [0.0, 2.0, 2.0, -2.0, -6.0, 7.0]
    if algo == "weight_only_fp8":
        assert deq[:4, 3].tolist() == [448.0, 1.0, 1.25, -1.0]
    # numpy input gives the same
    nq, ns = port_q.weight_quantize(w, algo=algo)
    assert torch.equal(nq.view(torch.uint8), pq.view(torch.uint8)) and torch.equal(ns, ps)


@pytest.mark.parametrize("algo", _ALGOS)
def test_weight_dequantize_matches_reference(algo):
    w = _weights(12)
    rq, rs = ref_q.weight_quantize(w, algo=algo)
    want = ref_q.weight_dequantize(rq, rs, algo=algo).numpy()
    pq, ps = port_q.weight_quantize(w, algo=algo)
    got = port_q.weight_dequantize(pq, ps, algo=algo)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quant_errors_match_reference():
    with pytest.raises(ValueError, match="quant algo"):
        port_q.weight_quantize(np.ones((4, 4), np.float32), algo="int4")
    with pytest.raises(ValueError, match="even K"):
        port_q.weight_quantize(np.ones((3, 4), np.float32), algo="weight_only_int4")
    with pytest.raises(ValueError, match="quant algo"):
        port_q.weight_dequantize(np.ones((4, 4), np.int8), np.ones(4, np.float32), "int8")
    x, q, s = torch.ones((4, 4)), torch.ones((4, 4), dtype=torch.int8), torch.ones(4)
    with pytest.raises(ValueError, match="int8, int4, or fp8"):
        port_q.weight_only_linear(x, q, weight_scale=s, weight_dtype="int2")
    with pytest.raises(ValueError, match="group-wise"):
        port_q.weight_only_linear(x, q, weight_scale=s, group_size=64)
    with pytest.raises(ValueError, match="weight_scale is required"):
        port_q.weight_only_linear(x, q)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("algo", _ALGOS)
def test_weight_only_linear_output_and_dx_match_reference(algo, with_bias):
    rng = np.random.RandomState(21)
    w = _weights(13)
    x = rng.randn(2, 8, 64).astype(np.float32)
    dout = rng.randn(2, 8, 48).astype(np.float32)
    bias = rng.randn(48).astype(np.float32) if with_bias else None
    rq, rs = ref_q.weight_quantize(w, algo=algo)
    xr = paddle.to_tensor(x, stop_gradient=False)
    out_r = ref_q.weight_only_linear(xr, rq, None if bias is None else paddle.to_tensor(bias),
                                     rs, weight_dtype=_DTYPES[algo])
    (out_r * paddle.to_tensor(dout)).sum().backward()
    pq, ps = port_q.weight_quantize(w, algo=algo)
    xp = torch.from_numpy(x).requires_grad_(True)
    out_p = port_q.weight_only_linear(xp, pq, None if bias is None else torch.from_numpy(bias),
                                      ps, weight_dtype=_DTYPES[algo])
    out_p.backward(torch.from_numpy(dout))
    assert out_p.shape == (2, 8, 48)
    np.testing.assert_allclose(out_p.detach().numpy(), out_r.numpy(), rtol=F32_RTOL,
                               atol=F32_ATOL)
    np.testing.assert_allclose(xp.grad.numpy(), xr.grad.numpy(), rtol=F32_RTOL, atol=F32_ATOL)


def test_weight_only_linear_int8_bf16_and_train_scales():
    """bf16 activations through the int8 ops (one bf16 rounding of each
    output and of dx on both sides), and train_scales giving the scales'
    gradient, against the reference's."""
    rng = np.random.RandomState(22)
    w = _weights(14)
    x = _bf16(rng.randn(16, 64).astype(np.float32))
    dout = _bf16(rng.randn(16, 48).astype(np.float32))
    rq, rs = ref_q.weight_quantize(w)
    pq, ps = port_q.weight_quantize(w)
    xr = paddle.to_tensor(x).astype("bfloat16")
    xr.stop_gradient = False
    out_r = ref_q.weight_only_linear(xr, rq, None, rs)
    out_r.backward(paddle.to_tensor(dout).astype("bfloat16"))
    xp = torch.from_numpy(x).bfloat16().requires_grad_(True)
    out_p = port_q.weight_only_linear(xp, pq, None, ps)
    out_p.backward(torch.from_numpy(dout).bfloat16())
    assert out_p.dtype == torch.bfloat16 and xp.grad.dtype == torch.bfloat16
    _assert_close_bf16(out_p.detach().float().numpy(), out_r.astype("float32").numpy())
    _assert_close_bf16(xp.grad.float().numpy(), xr.grad.astype("float32").numpy())
    # learned scales, f32
    x32 = rng.randn(16, 64).astype(np.float32)
    d32 = rng.randn(16, 48).astype(np.float32)
    sr = paddle.to_tensor(rs.numpy(), stop_gradient=False)
    out_r = ref_q.weight_only_linear(paddle.to_tensor(x32), rq, None, sr, train_scales=True)
    (out_r * paddle.to_tensor(d32)).sum().backward()
    sp = ps.clone().requires_grad_(True)
    port_q.weight_only_linear(torch.from_numpy(x32), pq, None, sp,
                              train_scales=True).backward(torch.from_numpy(d32))
    want = sr.grad.numpy()
    np.testing.assert_allclose(sp.grad.numpy(), want, rtol=F32_RTOL,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_linear_state_dict_keys_match_reference(with_bias):
    from paddle_tpu_torch.nn import Linear

    rl = paddle.nn.Linear(16, 8, bias_attr=None if with_bias else False)
    rql = ref_q.QuantizedLinear(rl)
    pl = Linear(16, 8, bias_attr=None if with_bias else False, device="cpu")
    with torch.no_grad():
        pl.weight.copy_(torch.from_numpy(np.array(rl.weight.numpy())))
    pql = port_q.QuantizedLinear(pl)
    assert sorted(pql.state_dict()) == sorted(rql.state_dict())
    assert list(pql.parameters()) == []
    assert pql.weight.dtype == torch.int8 and pql.weight_scale.dtype == torch.float32
    np.testing.assert_array_equal(pql.weight.numpy(), np.asarray(rql.weight.numpy()))
    assert (pql.bias is None) == (not with_bias)
    x = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    np.testing.assert_allclose(pql(torch.from_numpy(x)).numpy(),
                               rql(paddle.to_tensor(x)).numpy(), rtol=F32_RTOL, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# a tiny Llama with frozen int8 projections
# ---------------------------------------------------------------------------

_PROJ = (("self_attn", "q_proj"), ("self_attn", "k_proj"), ("self_attn", "v_proj"),
         ("self_attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
         ("mlp", "down_proj"))


def _swap(model, quantized_linear):
    n = 0
    for lyr in model.llama.layers:
        for block, name in _PROJ:
            parent = getattr(lyr, block)
            setattr(parent, name, quantized_linear(getattr(parent, name)))
            n += 1
    return n


def _quant_pair(seed):
    paddle.seed(seed)
    model = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny())
    assert _swap(model, ref_q.QuantizedLinear) == 14
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(), device="cpu", seed=99)
    assert _swap(pmodel, port_q.QuantizedLinear) == 14
    port_llama.load_reference_state_dict(pmodel, state)
    return model, pmodel


def _batch(seed, vocab=1024, b=2, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int64),
            rng.randint(0, vocab, (b, s)).astype(np.int64))


def test_quantized_llama_logits_loss_and_trainable_grads_match():
    model, pmodel = _quant_pair(seed=3)
    names = [n for n, _ in pmodel.named_parameters()]
    assert names == [n for n, _ in model.named_parameters()] and len(names) == 7
    assert pmodel.llama.layers[1].mlp.down_proj.weight.dtype == torch.int8
    ids, labels = _batch(1)
    loss_r, logits_r = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    grads_r = {n: p.grad.numpy() for n, p in model.named_parameters()}
    loss, logits = pmodel(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), logits_r.numpy(), rtol=LOGITS_RTOL,
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_r.numpy()), rtol=LOSS_RTOL)
    for n, p in pmodel.named_parameters():
        scale = np.abs(grads_r[n]).max()
        err = np.abs(p.grad.numpy() - grads_r[n]).max()
        assert err <= GRAD_FRAC * scale, (n, err, scale)


def test_quantized_llama_train_step_trajectory_matches_reference():
    model, pmodel = _quant_pair(seed=5)
    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    frozen = {k: v.clone() for k, v in pmodel.state_dict().items() if k not in start}
    batches = [_batch(10 + i) for i in range(5)]
    opt_r = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                   weight_decay=0.1,
                                   grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step_r = paddle.jit.TrainStep(model, opt_r, lambda x, y: model(x, labels=y)[0],
                                  accumulate_steps=2)
    losses_r = [float(step_r(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
                for x, y in batches]
    opt = AdamW(learning_rate=1e-3, parameters=pmodel.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(pmodel, opt, lambda x, y: pmodel(x, labels=y)[0], accumulate_steps=2)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))) for x, y in batches]
    np.testing.assert_allclose(losses, losses_r, rtol=TRAJ_LOSS_RTOL)
    assert opt._step_count == opt_r._step_count == 2
    params_r = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    for n, p in pmodel.named_parameters():
        got = p.detach().numpy()
        assert np.abs(got - start[n]).max() > 1e-3, n    # two updates moved it
        diff = np.abs(got - params_r[n])
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        outliers = int((diff > TRAJ_PARAM_ATOL).sum())
        assert outliers <= max(2, TRAJ_OUTLIER_FRAC * diff.size), (n, outliers, diff.size)
    # the int8 weights and scales stayed frozen
    for k, v in pmodel.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(16, 128), (24, 40)])
def test_swiglu_2d_matches_pallas_interpret(dtype, n, h):
    rng = np.random.RandomState(n + h)
    a = (rng.randn(n, h) * 3).astype(np.float32)
    b = rng.randn(n, h).astype(np.float32)
    dout = rng.randn(n, h).astype(np.float32)
    if dtype == "bfloat16":
        a, b, dout = _bf16(a), _bf16(b), _bf16(dout)
    jdt = getattr(jnp, dtype)
    want, vjp = jax.vjp(ref_fn.swiglu_2d, jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    want_da, want_db = vjp(jnp.asarray(dout, jdt))
    tdt = getattr(torch, dtype)
    at = torch.from_numpy(a).to(tdt).requires_grad_(True)
    bt = torch.from_numpy(b).to(tdt).requires_grad_(True)
    out = port_fn.swiglu_2d(at, bt)
    out.backward(torch.from_numpy(dout).to(tdt))
    pairs = ((out.detach(), want), (at.grad, want_da), (bt.grad, want_db))
    for got, ref in pairs:
        assert got.dtype == tdt and got.shape == (n, h)
        got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=SWIGLU_F32_RTOL, atol=SWIGLU_F32_ATOL)
        else:
            # the f32 values differ by ulps; their one bf16 rounding may
            # land one step apart
            np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=0)


def test_swiglu_2d_agrees_with_the_composed_functional():
    """The fused op computes the same function as the Llama's composed
    ``F.swiglu`` (f32, so the only difference is the order of two
    products)."""
    from paddle_tpu_torch.nn import functional as PF

    rng = np.random.RandomState(6)
    a, b = (torch.from_numpy(rng.randn(8, 32).astype(np.float32)) for _ in range(2))
    np.testing.assert_allclose(port_fn.swiglu_2d(a, b).numpy(), PF.swiglu(a, b).numpy(),
                               rtol=SWIGLU_F32_RTOL, atol=SWIGLU_F32_ATOL)
