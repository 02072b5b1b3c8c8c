"""PyTorch port: the Mixture-of-Experts layer against the reference, on the CPU.

The same seeded f32 logits go through the reference's routing functions
and the port's: masks, expert ids and buffer positions must be equal,
gates, combine weights and the load-balance loss within 1e-6 (f32
softmax and sums of a few terms). ``MoELayer`` is built by the
reference, its weights carried to the port by key, and both run the same
input with the same dispatch, top-1 and top-2, with ample capacity and
under pressure (``capacity_factor=0.25``, most choices dropped): output,
``aux_loss`` and the gradients of ``x``, the router and the three expert
weights within MOE_RTOL / MOE_ATOL (f32 products summed in another order,
the reference's tolerances for sort against dense). The port's sort and
dense paths make the same truncation decisions bit for bit. The probe of
the dispatch policy is run at a tiny shape (the reference marks its own
probe test slow); under ``amp`` the layer casts as the op ``moe``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import moe as rmoe
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.distributed.fleet import moe as pmoe
from paddle_tpu_torch.models import load_reference_state_dict

GATE_ATOL = 1e-6
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
# bf16 under amp O2: both sides round x, the logits and the weights to bf16
# and each product once; the sums of a few hundred bf16 products differ in
# order: 2^-7 of the largest output
AMP_ATOL_FRAC = 2.0 ** -7


def _logits(seed, T=40, E=4):
    return np.random.RandomState(seed).randn(T, E).astype(np.float32)


@pytest.mark.parametrize("capacity", [24, 5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_gating_matches_reference(top_k, capacity):
    lg = _logits(top_k + capacity)
    ref = rmoe.top1_gating if top_k == 1 else rmoe.top2_gating
    port = pmoe.top1_gating if top_k == 1 else pmoe.top2_gating
    c_r, d_r, a_r = ref(jnp.asarray(lg), capacity)
    c, d, a = port(torch.from_numpy(lg), capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_r), rtol=0, atol=GATE_ATOL)
    np.testing.assert_allclose(float(a), float(a_r), rtol=0, atol=GATE_ATOL)
    # capacity binds in the second case: some choice was dropped
    assert (d.sum().item() < top_k * lg.shape[0]) == (capacity == 5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_topk_routing_and_aux_loss_match_reference(top_k):
    lg = _logits(7)
    ids_r, gates_r, probs_r = rmoe.topk_routing(jnp.asarray(lg), top_k)
    ids, gates, probs = pmoe.topk_routing(torch.from_numpy(lg), top_k)
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), rtol=0, atol=GATE_ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_r), rtol=0, atol=GATE_ATOL)
    np.testing.assert_allclose(float(pmoe._aux_loss(probs, ids)),
                               float(rmoe._aux_loss(probs_r, ids_r)), rtol=0, atol=GATE_ATOL)


def test_ties_take_the_first_expert_as_the_reference():
    lg = np.zeros((6, 4), np.float32)
    lg[3] = [1.0, 2.0, 2.0, 0.5]
    ids_r, _, _ = rmoe.topk_routing(jnp.asarray(lg), 2)
    ids, _, _ = pmoe.topk_routing(torch.from_numpy(lg), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    assert ids[:, 3].tolist() == [1, 2] and ids[:, 0].tolist() == [0, 1]


@pytest.mark.parametrize("C", [16, 3])
def test_sort_dispatch_matches_reference(C):
    rng = np.random.RandomState(11)
    x = rng.randn(24, 8).astype(np.float32)
    lg = _logits(12, T=24)
    ids_r, gates_r, _ = rmoe.topk_routing(jnp.asarray(lg), 2)
    want = rmoe.sort_dispatch_moe(jnp.asarray(x), ids_r, gates_r, 4, C,
                                  lambda e: e * 2.0 + 1.0)
    ids, gates, _ = pmoe.topk_routing(torch.from_numpy(lg), 2)
    got = pmoe.sort_dispatch_moe(torch.from_numpy(x), ids, gates, 4, C,
                                 lambda e: e * 2.0 + 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _pair(seed, d_model=16, d_hidden=32, E=4, top_k=2, cf=1.25, dispatch=None):
    paddle.seed(seed)
    ref = rmoe.MoELayer(d_model, d_hidden, E, top_k=top_k, capacity_factor=cf,
                        dispatch=dispatch)
    port = pmoe.MoELayer(d_model, d_hidden, E, top_k=top_k, capacity_factor=cf,
                         dispatch=dispatch, device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v._data)
                                     for k, v in ref.state_dict().items()})
    return ref, port


_WEIGHTS = ("gate.gate.weight", "w_up", "w_gate", "w_down")


def _ref_run(ref, x):
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = ref(xt)
    (out.sum() + ref.aux_loss).backward()
    grads = dict(ref.named_parameters())
    return (out.numpy(), float(ref.aux_loss.numpy()), xt.grad.numpy(),
            {n: grads[n].grad.numpy() for n in _WEIGHTS})


def _port_run(port, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out.sum() + port.aux_loss).backward()
    grads = dict(port.named_parameters())
    got = (out.detach().numpy(), float(port.aux_loss.detach()), xt.grad.numpy(),
           {n: grads[n].grad.numpy().copy() for n in _WEIGHTS})
    port.zero_grad(set_to_none=True)
    return got


def _assert_close(got, want):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=MOE_RTOL, atol=MOE_ATOL)
    assert sorted(got[3]) == sorted(want[3])
    for n in want[3]:
        np.testing.assert_allclose(got[3][n], want[3][n], rtol=MOE_RTOL, atol=MOE_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["ample", "pressure"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["dense", "sort"])
def test_layer_matches_reference(dispatch, top_k, cf):
    ref, port = _pair(3, top_k=top_k, cf=cf, dispatch=dispatch)
    x = np.random.RandomState(4).randn(2, 16, 16).astype(np.float32)
    got = _port_run(port, x)
    assert got[0].shape == (2, 16, 16) and port.capacity(32) == max(int(cf * 32 * top_k / 4), 4)
    _assert_close(got, _ref_run(ref, x))


@pytest.mark.parametrize("top_k", [1, 2])
def test_sort_matches_dense_in_the_port(top_k):
    _, port = _pair(5, top_k=top_k, cf=0.5)
    x = np.random.RandomState(6).randn(64, 16).astype(np.float32)
    port.dispatch = "dense"
    dense = _port_run(port, x)
    port.dispatch = "sort"
    _assert_close(_port_run(port, x), dense)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_and_sort_make_the_same_decisions(top_k):
    """Every (token, expert, slot) the sort path keeps is the dense
    dispatch mask's, and the weights it combines with are the dense
    combine's, bit for bit."""
    lg = torch.from_numpy(_logits(8, T=64))
    for C in (40, 9, 4):
        combine, dispatch, _ = (pmoe.top1_gating if top_k == 1 else pmoe.top2_gating)(lg, C)
        ids, gates, _ = pmoe.topk_routing(lg, top_k)
        order, se, stok, cpos, valid = pmoe.sort_slots(ids, 4, C)
        mask = torch.zeros_like(dispatch)
        mask[stok[valid], se[valid], cpos[valid]] = True
        assert torch.equal(mask, dispatch), C
        sg = pmoe.sort_gates(gates, order, valid)
        assert torch.equal(combine[stok[valid], se[valid], cpos[valid]], sg[valid])


def test_dispatch_mode_rule_cache_and_flag():
    pmoe._DISPATCH_CHOICE.clear()
    assert pmoe.dispatch_mode(64, 4, 8, 16) == "dense"
    assert pmoe.dispatch_mode(64, 4, 8, 16, torch.bfloat16, dh=32, top_k=1) == "dense"
    assert pmoe._DISPATCH_CHOICE == {(64, 4, 8, 16, "float32", 64, 2): "dense",
                                     (64, 4, 8, 16, "bfloat16", 32, 1): "dense"}
    assert pflags.get_flag("moe_dispatch") == ""
    pflags.set_flags({"moe_dispatch": "sort"})
    try:
        assert pmoe.dispatch_mode(64, 4, 8, 16) == "sort"
    finally:
        pflags.set_flags({"moe_dispatch": ""})
    assert pmoe.dispatch_mode(64, 4, 8, 16) == "dense"


def test_probe_times_both_paths_and_caches_its_choice(monkeypatch):
    monkeypatch.setattr(pmoe, "_SMALL", 0)
    monkeypatch.setattr(pmoe, "_DISPATCH_CHOICE", {})
    monkeypatch.setattr(pmoe, "_PROBE_TIMES", {})
    choice = pmoe.dispatch_mode(48, 4, 12, 16, dh=24, device="cpu")
    key = (48, 4, 12, 16, "float32", 24, 2)
    times = pmoe._PROBE_TIMES[key]
    assert pmoe._DISPATCH_CHOICE == {key: choice}
    assert choice == ("dense" if times["dense_s"] <= times["sort_s"] else "sort")
    assert times["dense_s"] > 0 and times["sort_s"] > 0


def test_probe_falls_back_to_sort_only_when_dense_runs_out_of_memory(monkeypatch):
    def oom(*args):
        raise torch.cuda.OutOfMemoryError("out of memory")

    def broken(*args):
        raise RuntimeError("a fault of the dense path")

    monkeypatch.setattr(pmoe, "_PROBE_TIMES", {})
    monkeypatch.setitem(pmoe._MOE, "dense", oom)
    assert pmoe._probe_dispatch(32, 4, 8, 16, torch.float32, 24, device="cpu") == "sort"
    assert set(pmoe._PROBE_TIMES[(32, 4, 8, 16, "float32", 24, 2)]) == {"sort_s"}
    monkeypatch.setitem(pmoe._MOE, "dense", broken)
    with pytest.raises(RuntimeError, match="fault of the dense path"):
        pmoe._probe_dispatch(32, 4, 8, 16, torch.float32, 24, device="cpu")


def test_layer_takes_and_ignores_gate_and_activation():
    layer = pmoe.MoELayer(8, 16, 2, gate="switch", activation="relu", device="cpu")
    assert layer.w_up.shard_axes == {0: ("ep", "dp")}
    assert layer(torch.ones(3, 8)).shape == (3, 8) and layer.aux_loss.dtype == torch.float32
    with pytest.raises(ValueError, match="dispatch"):
        pmoe.MoELayer(8, 16, 2, dispatch="ragged", device="cpu")


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_casts_moe_inputs_as_the_reference(level):
    """At O2 ``moe`` (on neither list) casts x, the logits and the expert
    weights to bf16, so the output is bf16; at O1 it is left alone, and
    only the router's Linear (white-listed) runs in bf16."""
    ref, port = _pair(9, dispatch="dense")
    x = np.random.RandomState(10).randn(32, 16).astype(np.float32)
    with paddle.amp.auto_cast(level=level):
        want = ref(paddle.to_tensor(x))
    with pamp.auto_cast(level=level):
        got = port(torch.from_numpy(x))
    assert pamp.should_cast("moe") is None
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == (
        "bfloat16" if level == "O2" else "float32")
    w = np.asarray(want.astype("float32").numpy())
    np.testing.assert_allclose(got.float().detach().numpy(), w, rtol=0,
                               atol=AMP_ATOL_FRAC * np.abs(w).max())


def test_a_probe_inside_a_selective_recompute_region_changes_nothing(monkeypatch):
    """The first call of a shape class probes inside the forward; under the
    selective policy that forward runs in a checkpoint region whose
    dispatch mode keeps the products' outputs for the recompute. The
    probe's own products stay out of it: the gradients equal the plain
    call's bit for bit."""
    import importlib

    prec = importlib.import_module("paddle_tpu_torch.distributed.recompute")
    _, port = _pair(12, cf=0.5)
    x0 = torch.from_numpy(np.random.RandomState(13).randn(40, 16).astype(np.float32))
    monkeypatch.setattr(pmoe, "_DISPATCH_CHOICE", {})
    monkeypatch.setattr(pmoe, "_PROBE_TIMES", {})
    monkeypatch.setattr(pmoe, "_SMALL", 0)
    runs = []
    for call in (lambda x: prec.recompute(port, x, checkpoint_policy="selective"), port):
        x = x0.clone().requires_grad_(True)
        (call(x).square().sum() + port.aux_loss).backward()
        runs.append([x.grad] + [p.grad.clone() for p in port.parameters()])
        port.zero_grad(set_to_none=True)
    assert len(pmoe._PROBE_TIMES) == 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))
