"""PyTorch port: ``paddle_tpu_torch.amp`` against the reference's
``paddle_tpu.amp`` on the CPU.

- ``should_cast``'s policy for every op of both lists, an op of neither and
  custom lists, at O1 and O2, enabled or not; ``auto_cast`` nesting and its
  thread-local state.
- ``decorate``: dtypes of every parameter and buffer against the
  reference's, ``_multi_precision``, return shapes, parameter identity.
- ``GradScaler`` against ``tests/test_fused_optimizer.py``'s
  ``TestFusedUnscale`` and ``TestAmpClipFusedAcceptance`` in both regimes
  (``PADDLE_OPT_FUSED`` 1 and 0): the unscale bit for bit at scales 65536
  and 1000 (not a power of two: ``1/scale`` rounds), found-inf and the
  skipped step, a scripted scale trajectory, ``state_dict``, three clipped
  AdamW steps (fused = per-parameter bit for bit, both within 1e-6 of the
  reference).
- A tiny Llama under O1 (logits, loss, every gradient) and a 3-step O2 bf16
  trajectory (loss, bf16 parameters, f32 master weights) against the
  reference's eager loop, dtypes equal on both sides.

bf16 tolerances. Both sides round the same ops to bf16, but in other
orders (torch's CPU GEMM and the reference's XLA dot round their f32 sums
once each, after different accumulation), so about two of three bf16
logits differ by an ulp or two:
- O1 logits within 2^-6 of the largest |logit| (two bf16 ulps there), the
  f32 loss within 1e-3 relative, each gradient within 3e-2 of its
  tensor's largest entry (bf16 operands carry 2^-9 relative error per
  rounding through two layers and the head; measured up to 1.6e-2).
- O2: AdamW moves a weight by about lr a step whatever the gradient's size,
  so a gradient that differs in bf16 may move a weight up to 2 lr
  differently a step: after 3 steps masters within 6 lr, bf16 parameters
  within 6 lr plus one bf16 ulp of the weight, and at least 3/4 of each
  bf16 parameter's elements bit for bit the reference's (measured: 89%).
"""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as ramp
import paddle_tpu.optimizer as ropt
from paddle_tpu.models import llama as ref
import paddle_tpu_torch.amp as pamp
from paddle_tpu_torch import dtype as pdtype
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.quant import QuantizedLinear

O1_LOGITS_FRAC, O1_LOSS_RTOL, O1_GRAD_FRAC = 2.0 ** -6, 1e-3, 3e-2
O2_LR, O2_LOSS_RTOL, O2_MASTER_ATOL, O2_SAME_FRAC = 1e-3, 1e-3, 6e-3, 0.75


@contextlib.contextmanager
def regime(value: str):
    """PADDLE_OPT_FUSED for a block ("1" fused, "0" per parameter); both
    packages read it at every call."""
    old = os.environ.get("PADDLE_OPT_FUSED")
    os.environ["PADDLE_OPT_FUSED"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PADDLE_OPT_FUSED", None)
        else:
            os.environ["PADDLE_OPT_FUSED"] = old


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

OPS = sorted(ramp.WHITE_LIST | ramp.BLACK_LIST | {"swiglu", "embedding", "fused_rope", "moe",
                                                  "add"})
CUSTOM = {"none": (None, None),
          "custom": ({"swiglu", "softmax"}, {"linear", "embedding"})}


@pytest.mark.parametrize("custom", list(CUSTOM))
@pytest.mark.parametrize("enable", [True, False])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_should_cast_matches_reference(level, enable, custom):
    white, black = CUSTOM[custom]
    assert pamp.WHITE_LIST == ramp.WHITE_LIST and pamp.BLACK_LIST == ramp.BLACK_LIST
    with ramp.auto_cast(enable, white, black, level=level):
        want = {op: ramp.should_cast(op) for op in OPS}
    with pamp.auto_cast(enable, white, black, level=level):
        got = {op: pamp.should_cast(op) for op in OPS}
        state = pamp.amp_state()
        assert state.enabled == enable and state.level == level
        assert state.dtype == torch.bfloat16
    assert got == want
    assert not pamp.amp_state().enabled


def test_cast_inputs_follows_the_policy():
    """low: f32 to the amp dtype; high: bf16 and fp16 to f32; integer
    tensors and None pass; the gradient comes back in the input's dtype."""
    x = torch.ones(3, requires_grad=True)
    h = torch.ones(3, dtype=torch.float16)
    i = torch.arange(3)
    with pamp.auto_cast(level="O1", dtype="float16"):
        a, b, c, d = pamp.cast_inputs("linear", x, h, i, None)
        assert (a.dtype, b.dtype, c.dtype, d) == (torch.float16, torch.float16, i.dtype, None)
        e, f = pamp.cast_inputs("rms_norm", h, x)
        assert (e.dtype, f.dtype) == (torch.float32, torch.float32)
        assert pamp.cast_inputs("swiglu", x)[0] is x
    a.float().sum().backward()
    assert x.grad.dtype == torch.float32
    assert pamp.cast_inputs("linear", x)[0] is x          # outside auto_cast


def test_auto_cast_nests_restores_and_is_thread_local():
    seen = {}

    def other():
        seen["enabled"] = pamp.amp_state().enabled

    with pamp.auto_cast(level="O2", dtype="float16", custom_black_list={"matmul"}):
        with pamp.amp_guard(enable=False):
            assert not pamp.amp_state().enabled
            assert pamp.should_cast("linear") is None
        s = pamp.amp_state()
        assert (s.enabled, s.level, s.dtype) == (True, "O2", torch.float16)
        assert pamp.should_cast("matmul") == "high"
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == {"enabled": False}
    s = pamp.amp_state()
    assert (s.enabled, s.level, s.dtype, s.custom_black) == (False, "O1", torch.bfloat16, set())


@pytest.mark.parametrize("name", ["bf16", "bfloat16", "float16", "fp16", "half", "float32",
                                  "float", "float64", "double", "int64", "int8", "bool",
                                  "uint8", "complex128"])
def test_dtype_names_match_reference(name):
    from paddle_tpu import dtype as rdtype

    got, want = pdtype.convert_dtype(name), rdtype.convert_dtype(name)
    assert pdtype.dtype_name(got) == rdtype.dtype_name(want)
    assert pdtype.dtype_name(name) == rdtype.dtype_name(rdtype._STR_ALIASES[name])
    for fn in ("is_floating_point_dtype", "is_integer_dtype", "is_inexact_dtype"):
        assert getattr(pdtype, fn)(name) == bool(getattr(rdtype, fn)(want)), fn
    with pytest.raises(ValueError):
        pdtype.convert_dtype("float7")
    assert pdtype.get_default_dtype() == torch.float32


# ---------------------------------------------------------------------------
# decorate
# ---------------------------------------------------------------------------

def _pair(seed=3, **overrides):
    paddle.seed(seed)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny(**overrides))
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(**overrides), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    return model, pmodel


def _batch(seed, vocab=1024, b=2, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int64),
            rng.randint(0, vocab, (b, s)).astype(np.int64))


def _np_dtype(t):
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("level,dtype", [("O2", "bfloat16"), ("O2", "float16"),
                                         ("O1", "bfloat16")])
def test_decorate_matches_reference(level, dtype):
    model, pmodel = _pair()
    ro = ropt.AdamW(parameters=model.parameters())
    po = popt.AdamW(parameters=pmodel.parameters())
    before = [id(p) for p in pmodel.parameters()]
    got = pamp.decorate(pmodel, po, level=level, dtype=dtype)
    want = ramp.decorate(model, ro, level=level, dtype=dtype)
    assert got[0] is pmodel and got[1] is po and want[1] is ro
    assert po._multi_precision and ro._multi_precision
    assert [id(p) for p in pmodel.parameters()] == before
    assert [id(p) for p in po._parameter_list] == before
    rsd = model.state_dict()
    for k, v in pmodel.state_dict().items():
        assert _np_dtype(v) == str(rsd[k]._data.dtype), k


def test_decorate_return_shapes_and_quantized_scales():
    """Lists in, lists out; models alone; a QuantizedLinear's f32 scales
    (a buffer) cast at O2 while its int8 weight stays, the same tensors."""
    from paddle_tpu.nn import Linear as RLinear
    from paddle_tpu.nn.quant import QuantizedLinear as RQuantizedLinear
    from paddle_tpu_torch.nn.layer import Linear

    paddle.seed(0)
    rq = RQuantizedLinear(RLinear(8, 4))
    q = QuantizedLinear(Linear(8, 4, device="cpu"))
    scale, weight = q.weight_scale, q.weight
    assert pamp.decorate(q) is q
    ramp.decorate(rq)
    assert q.weight_scale is scale and q.weight is weight
    assert _np_dtype(q.weight_scale) == str(rq.weight_scale._data.dtype) == "bfloat16"
    assert _np_dtype(q.weight) == str(rq.weight._data.dtype) == "int8"
    a, b = Linear(2, 2, device="cpu"), Linear(2, 2, device="cpu")
    o1, o2 = popt.SGD(parameters=a.parameters()), popt.SGD(parameters=b.parameters())
    models, opts = pamp.decorate([a, b], [o1, o2], level="O1")
    assert models == [a, b] and opts == [o1, o2] and a.weight.dtype == torch.float32
    m, opts = pamp.decorate(a, [o1, o2])
    assert m is a and opts == [o1, o2] and a.weight.dtype == torch.bfloat16
    assert pamp.decorate([a], level="O1") == [a]


def test_quantized_linear_under_o2_matches_reference():
    """A decorated ``QuantizedLinear`` (bf16 scales) under
    ``auto_cast(level="O2")``: the reference's output, bit for bit (both
    multiply the int8 weights in f32 and scale by the bf16-rounded scales
    once)."""
    from paddle_tpu.nn import Linear as RLinear
    from paddle_tpu.nn.quant import QuantizedLinear as RQuantizedLinear
    from paddle_tpu_torch.nn.layer import Linear

    paddle.seed(1)
    rl = RLinear(64, 32)
    pl = Linear(64, 32, device="cpu")
    port.load_reference_state_dict(pl, {k: np.asarray(v._data)
                                        for k, v in rl.state_dict().items()})
    rq, pq = RQuantizedLinear(rl), QuantizedLinear(pl)
    ramp.decorate(rq)
    pamp.decorate(pq)
    x = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    with ramp.auto_cast(level="O2"):
        want = rq(paddle.to_tensor(x))
    with pamp.auto_cast(level="O2"):
        got = pq(torch.from_numpy(x))
    _same(got, want._data)


def test_decorate_after_the_optimizer_keeps_masters_as_the_reference():
    """An optimizer built before ``decorate`` makes its f32 masters from
    the bf16 parameters at its first step, as the reference's does: one
    SGD step equal on both sides, bit for bit, in both regimes."""
    for flag in ("1", "0"):
        model, pmodel = _pair(seed=2)
        ro = ropt.SGD(0.5, parameters=model.parameters())
        po = popt.SGD(0.5, parameters=pmodel.parameters())
        ramp.decorate(model, ro)
        pamp.decorate(pmodel, po)
        rng = np.random.RandomState(5)
        for r, p in zip(model.parameters(), pmodel.parameters()):
            g = rng.randn(*p.shape).astype(np.float32)
            r.grad = paddle.to_tensor(g, dtype="bfloat16")
            p.grad = torch.from_numpy(g).bfloat16()
        with regime(flag):
            ro.step()
            po.step()
        for r, p in zip(model.parameters(), pmodel.parameters()):
            assert po._master_weights[id(p)].dtype == torch.float32
            np.testing.assert_array_equal(po._master_weights[id(p)].numpy(),
                                          np.asarray(ro._master_weights[id(r)]))
            np.testing.assert_array_equal(p.detach().float().numpy(),
                                          np.asarray(r._data, np.float32))


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

SHAPES = [(4, 3), (7,), (2, 5), (3, 3, 2), (1,), (6, 2)]


def _params(dtype, seed=0):
    """The same parameters on both sides, in ``dtype``."""
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    rp = [paddle.Parameter(paddle.to_tensor(v, dtype=dtype)._data, name=f"p{i}")
          for i, v in enumerate(vals)]
    pp = [torch.nn.Parameter(torch.from_numpy(v).to(getattr(torch, dtype))) for v in vals]
    return rp, pp


def _grads(rp, pp, seed, scale, bad=None):
    rng = np.random.RandomState(seed)
    for i, (r, p) in enumerate(zip(rp, pp)):
        g = (rng.randn(*p.shape) * scale).astype(np.float32)
        if i == bad:
            g[0] = np.nan if i % 2 else np.inf
        r.grad = paddle.to_tensor(g, dtype=str(r._data.dtype))
        p.grad = torch.from_numpy(g).to(p.dtype)


def _same(p, r):
    np.testing.assert_array_equal(p.detach().float().numpy(), np.asarray(r, np.float32))
    assert _np_dtype(p) == str(np.asarray(r).dtype)


@pytest.mark.parametrize("flag", ["1", "0"])
@pytest.mark.parametrize("scale", [65536.0, 1000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unscale_bit_for_bit(flag, scale, dtype):
    rp, pp = _params(dtype)
    _grads(rp, pp, 7, scale if dtype != "float16" else 8.0)
    rs, ps = ramp.GradScaler(init_loss_scaling=scale), pamp.GradScaler(init_loss_scaling=scale)
    before = pamp.stats()["unscale_dispatches"]
    with regime(flag):
        rs.unscale_(ropt.SGD(0.1, parameters=rp))
        po = popt.SGD(0.1, parameters=pp)
        ps.unscale_(po)
        ps.unscale_(po)                                  # once a step
    assert pamp.stats()["unscale_dispatches"] - before == (1 if flag == "1" else len(pp))
    assert not ps._found_inf and not rs._found_inf
    for r, p in zip(rp, pp):
        _same(p.grad, r.grad._data)


@pytest.mark.parametrize("flag", ["1", "0"])
def test_found_inf_skips_the_step_and_backs_off(flag):
    rp, pp = _params("bfloat16")
    ro = ropt.AdamW(0.05, parameters=rp, weight_decay=0.1, multi_precision=True)
    po = popt.AdamW(0.05, parameters=pp, weight_decay=0.1, multi_precision=True)
    rs, ps = ramp.GradScaler(init_loss_scaling=4.0), pamp.GradScaler(init_loss_scaling=4.0)
    with regime(flag):
        for t, bad in enumerate((None, 1, None, 2)):
            _grads(rp, pp, 30 + t, 4.0, bad)
            snap = [p.detach().clone() for p in pp]
            masters = {k: v.clone() for k, v in po._master_weights.items()}
            moments = {k: {n: x.clone() for n, x in s.items()}
                       for k, s in po._accumulators.items()}
            count = po._step_count
            rs.step(ro)
            ps.step(po)
            assert ps._found_inf == rs._found_inf == (bad is not None)
            rs.update()
            ps.update()
            ro.clear_grad()
            po.clear_grad()
            assert ps.state_dict() == rs.state_dict()
            assert po._step_count == ro._step_count
            if bad is not None:
                assert po._step_count == count
                assert all(torch.equal(a, b) for a, b in zip(snap, pp))
                assert all(torch.equal(masters[k], v) for k, v in po._master_weights.items())
                assert all(torch.equal(moments[k][n], x)
                           for k, s in po._accumulators.items() for n, x in s.items())
            for r, p in zip(rp, pp):
                _same(p, r._data)
    assert ps.get_scale_ratio() == 1.0                  # 4 -> 2 -> 1


def test_scale_trajectory_and_state_dict_match_reference():
    """A scripted run of good and bad steps through ``update`` (the
    dynamic arithmetic: growth every 2 good steps, back-off after 2 bad
    ones, a floor of 1), then ``state_dict`` and ``load_state_dict``."""
    kw = dict(init_loss_scaling=1000.0, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    rs, ps = ramp.GradScaler(**kw), pamp.GradScaler(**kw)
    scales = []
    for bad in [0, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0]:
        rs._found_inf = ps._found_inf = bool(bad)
        rs.update()
        ps.update()
        assert ps.state_dict() == rs.state_dict()
        scales.append(ps.get_scale_ratio())
    assert min(scales) == 1.0 and scales[2] == 2000.0 and scales[-1] == 2.0
    assert ps.is_enable() and ps.is_use_dynamic_loss_scaling()
    other = pamp.GradScaler()
    other.load_state_dict(ps.state_dict())
    assert other.state_dict() == ps.state_dict()
    static = pamp.GradScaler(use_dynamic_loss_scaling=False, init_loss_scaling=8.0)
    static._found_inf = True
    static.update()
    assert static.get_scale_ratio() == 8.0 and not static._found_inf


def test_three_clipped_adamw_steps_with_the_scaler():
    """``TestAmpClipFusedAcceptance``'s configuration: AdamW with the
    global-norm clip and a scaler at 16, three steps. The port's fused
    regime equals its per-parameter one bit for bit (parameters and
    moments), as the reference's test holds for the reference; both are
    within 1e-6 of the reference's per-parameter regime (f32 updates of
    the same arithmetic, as ``test_torch_optimizer.py`` holds them)."""
    def run(lib, nn_lib, scaler_lib, params):
        o = lib.AdamW(0.05, parameters=params, weight_decay=0.1,
                      grad_clip=nn_lib.ClipGradByGlobalNorm(0.5))
        s = scaler_lib.GradScaler(init_loss_scaling=16.0)
        return o, s

    rp, pp = _params("float32", seed=3)
    _, pp0 = _params("float32", seed=3)
    ro, rs = run(ropt, paddle.nn, ramp, rp)
    po, ps = run(popt, pnn, pamp, pp)
    po0, ps0 = run(popt, pnn, pamp, pp0)
    for t in range(3):
        _grads(rp, pp, 300 + t, 16.0)
        _grads(rp, pp0, 300 + t, 16.0)
        for o, s, flag in ((ro, rs, "0"), (po, ps, "1"), (po0, ps0, "0")):
            with regime(flag):
                s.step(o)
                s.update()
            o.clear_grad()
    for r, p, p0 in zip(rp, pp, pp0):
        assert torch.equal(p, p0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r._data), rtol=0, atol=1e-6)
        for k, v in po._accumulators[id(p)].items():
            assert torch.equal(v, po0._accumulators[id(p0)][k])
            np.testing.assert_allclose(v.numpy(), np.asarray(ro._accumulators[id(r)][k]),
                                       rtol=0, atol=1e-6)


def test_disabled_scaler_and_minimize():
    rp, pp = _params("float32")
    po = popt.SGD(0.5, parameters=pp)
    ps = pamp.GradScaler(enable=False)
    x = torch.ones(())
    assert ps.scale(x) is x
    loss = sum((p.float() ** 2).sum() for p in pp)
    ps.minimize(po, ps.scale(loss))
    assert po._step_count == 1
    ps = pamp.GradScaler(init_loss_scaling=2.0)
    po.clear_grad()
    loss = sum((p.float() ** 2).sum() for p in pp)
    want = [p.detach() - 0.5 * 2 * p.detach() for p in pp]
    ps.minimize(po, ps.scale(loss))
    assert all(torch.allclose(p, w) for p, w in zip(pp, want))


def test_check_numerics_and_the_tensor_checker():
    ok = torch.ones(4)
    assert pamp.debugging.check_numerics(ok) == (0, 0)
    with pytest.raises(FloatingPointError, match="1 NaN, 2 Inf"):
        pamp.debugging.check_numerics(torch.tensor([float("nan"), float("inf"), -float("inf")]))
    for fn in (pamp.debugging.enable_tensor_checker, pamp.debugging.disable_tensor_checker):
        with pytest.raises(NotImplementedError, match="op surface"):
            fn()


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_tiny_llama_o1_matches_reference(tied):
    model, pmodel = _pair(tie_word_embeddings=tied)
    ids, labels = _batch(1)
    with ramp.auto_cast(level="O1"):
        loss_r, logits_r = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    with pamp.auto_cast(level="O1"):
        loss, logits = pmodel(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert _np_dtype(logits) == str(logits_r._data.dtype) == "bfloat16"
    assert _np_dtype(loss) == str(loss_r._data.dtype) == "float32"
    want = np.asarray(logits_r._data, np.float32)
    err = np.abs(logits.detach().float().numpy() - want).max()
    assert err <= O1_LOGITS_FRAC * np.abs(want).max(), err
    np.testing.assert_allclose(float(loss.detach()), float(loss_r.numpy()), rtol=O1_LOSS_RTOL)
    for (n, p), (_, r) in zip(pmodel.named_parameters(), model.named_parameters()):
        assert _np_dtype(p.grad) == str(r.grad._data.dtype) == "float32", n
        g, gr = p.grad.numpy(), np.asarray(r.grad._data)
        assert np.abs(g - gr).max() <= O1_GRAD_FRAC * np.abs(gr).max(), n


def test_tiny_llama_o2_three_steps_match_reference():
    """The reference's eager AMP loop (``decorate`` at O2, forward and loss
    under ``auto_cast(level="O2")``, ``GradScaler`` scale, backward, step,
    update), AdamW with the global-norm clip: the reference in its
    per-parameter regime, the port in its fused one."""
    model, pmodel = _pair(seed=7)
    batches = [_batch(20 + i) for i in range(3)]
    ro = ropt.AdamW(O2_LR, parameters=model.parameters(), weight_decay=0.1,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model, ro = ramp.decorate(model, ro, level="O2")
    po = popt.AdamW(O2_LR, parameters=pmodel.parameters(), weight_decay=0.1,
                    grad_clip=ClipGradByGlobalNorm(1.0))
    pmodel, po = pamp.decorate(pmodel, po, level="O2")
    rs, ps = ramp.GradScaler(), pamp.GradScaler()
    for x, y in batches:
        with regime("0"):
            with ramp.auto_cast(level="O2"):
                loss_r, _ = model(paddle.to_tensor(x), labels=paddle.to_tensor(y))
            rs.scale(loss_r).backward()
            rs.step(ro)
            rs.update()
            ro.clear_grad()
        with regime("1"):
            with pamp.auto_cast(level="O2"):
                loss, _ = pmodel(torch.from_numpy(x), labels=torch.from_numpy(y))
            ps.scale(loss).backward()
            ps.step(po)
            ps.update()
            po.clear_grad()
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss.detach()), float(loss_r.numpy()),
                                   rtol=O2_LOSS_RTOL)
    assert ps.state_dict() == rs.state_dict() and po._step_count == ro._step_count == 3
    for (n, p), (_, r) in zip(pmodel.named_parameters(), model.named_parameters()):
        assert _np_dtype(p) == str(r._data.dtype) == "bfloat16", n
        a, b = p.detach().float().numpy(), np.asarray(r._data, np.float32)
        assert np.all(np.abs(a - b) <= O2_MASTER_ATOL + 2.0 ** -8 * np.abs(b)), n
        assert (a == b).mean() >= O2_SAME_FRAC, (n, (a == b).mean())
        m, mr = po._master_weights[id(p)], np.asarray(ro._master_weights[id(r)])
        assert m.dtype == torch.float32 and mr.dtype == np.float32
        assert np.abs(m.numpy() - mr).max() <= O2_MASTER_ATOL, n
