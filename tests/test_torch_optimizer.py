"""PyTorch port: the eager optimizers against the reference, on the CPU.

A small MLP (Linear 16->32, tanh, Linear 32->4, mean squared error) is
built by the reference; its ``state_dict()`` goes to the port through numpy
(``load_reference_state_dict``). Both run the eager Paddle loop
``loss.backward(); opt.step(); opt.clear_grad()`` on the same seeded
batches, the reference in its per-parameter regime (``PADDLE_OPT_FUSED=0``,
the regime ROADMAP queue 3 holds the port against). Parameters, the step
count and the learning rate are compared after every step. Tolerance: f32
updates of the same arithmetic, 1e-6 absolute on weights of order 0.1-1.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models.llama import load_reference_state_dict
from paddle_tpu_torch.nn.layer import Linear

ATOL = 1e-6


@pytest.fixture(autouse=True)
def per_param_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_OPT_FUSED", "0")


def _models(seed=0, dtype=None):
    """The reference's MLP and the port's, with the same weights (in bf16
    with ``dtype``)."""
    paddle.seed(seed)
    ref = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.Tanh(),
                               paddle.nn.Linear(32, 4))
    state = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = torch.nn.Sequential(Linear(16, 32, device="cpu"), torch.nn.Tanh(),
                               Linear(32, 4, device="cpu"))
    load_reference_state_dict(port, state)
    if dtype is not None:
        for p in ref.parameters():
            p._data = p._data.astype(paddle.bfloat16)
        port.to(torch.bfloat16)
    return ref, port


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 16).astype(np.float32), rng.randn(8, 4).astype(np.float32))
            for _ in range(n)]


def _ref_step(model, opt, x, y):
    loss = ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy())


def _port_step(model, opt, x, y):
    loss = (model(torch.from_numpy(x)) - torch.from_numpy(y)).square().mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _assert_params(port, ref):
    for (n, p), (_, r) in zip(port.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(r._data, np.float32), rtol=0, atol=ATOL,
                                   err_msg=n)


def _run(make_ref, make_port, steps=5):
    """Train both for ``steps`` steps, comparing after each."""
    ref, port = _models()
    ro, po = make_ref(ref), make_port(port)
    for x, y in _batches(steps):
        lr, lp = _ref_step(ref, ro, x, y), _port_step(port, po, x, y)
        np.testing.assert_allclose(lp, lr, rtol=1e-5)
        assert po._step_count == ro._step_count
        assert po.get_lr() == ro.get_lr()
        _assert_params(port, ref)
    return ref, port, ro, po


def _warmup_cosine(lib):
    return lib.lr.LinearWarmup(lib.lr.CosineAnnealingDecay(0.05, T_max=6), warmup_steps=3,
                               start_lr=0.0, end_lr=0.05)


def _clip(lib, kind):
    return {"global": lambda: lib.ClipGradByGlobalNorm(0.5),
            "norm": lambda: lib.ClipGradByNorm(0.2),
            "value": lambda: lib.ClipGradByValue(0.05),
            None: lambda: None}[kind]()


@pytest.mark.parametrize("algo,clip", [("SGD", "value"), ("SGD", None), ("Adam", "norm"),
                                       ("AdamW", "global"), ("AdamW", None)])
def test_eager_trajectory_matches_reference(algo, clip):
    kw = {"SGD": dict(weight_decay=0.01), "Adam": dict(weight_decay=0.01),
          "AdamW": dict(weight_decay=0.1)}[algo]

    def make(lib, nn_lib):
        def build(model):
            sched = _warmup_cosine(lib)
            return getattr(lib, algo)(learning_rate=sched, parameters=model.parameters(),
                                      grad_clip=_clip(nn_lib, clip), **kw)
        return build

    ref, port, ro, po = _run(make(paddle.optimizer, paddle.nn), make(popt, pnn), steps=6)
    # the scheduler is the caller's to step; step it on both and go on
    ro._learning_rate.step()
    po._learning_rate.step()
    for x, y in _batches(2, seed=9):
        _ref_step(ref, ro, x, y)
        _port_step(port, po, x, y)
    _assert_params(port, ref)


def test_apply_decay_param_fun_matches_reference():
    """Parameters named ``*bias*`` are exempt from AdamW's decay; the names
    are Paddle's (``p.name`` in the reference, ``p.paddle_name`` in the
    port), set alike on both sides."""
    def name_params(model, lib):
        attr = "name" if lib is paddle.optimizer else "paddle_name"
        for i, p in enumerate(model.parameters()):
            setattr(p, attr, f"linear_{i // 2}." + ("b_0_bias" if i % 2 else "w_0"))

    def make(lib):
        def build(model):
            name_params(model, lib)
            return lib.AdamW(0.01, parameters=model.parameters(), weight_decay=0.5,
                             apply_decay_param_fun=lambda n: "bias" not in n)
        return build

    _run(make(paddle.optimizer), make(popt), steps=3)
    # one step from the same start: the exempt biases move as without decay,
    # the weights do not
    (_, named), (_, plain) = _models(), _models()
    opts = (make(popt)(named), popt.AdamW(0.01, parameters=plain.parameters(), weight_decay=0.0))
    for model, o in zip((named, plain), opts):
        _port_step(model, o, *_batches(1)[0])
    for i in (0, 2):
        assert torch.equal(named[i].bias, plain[i].bias)
        assert not torch.equal(named[i].weight, plain[i].weight)


def test_param_groups_match_reference():
    def make(lib):
        def build(model):
            first, second = list(model[0].parameters()), list(model[2].parameters())
            return lib.AdamW(0.01, weight_decay=0.1, parameters=[
                {"params": first, "learning_rate": 0.03, "weight_decay": 0.0},
                {"params": second}])
        return build

    _, port, _, po = _run(make(paddle.optimizer), make(popt), steps=4)
    assert po.get_lr() == 0.01
    po.set_lr(0.002)
    assert po.get_lr() == 0.002


def test_multi_precision_bf16_matches_reference():
    """bf16 parameters with f32 master weights: the update runs on the
    master copy and the parameter is its bf16 rounding. Both sides get the
    same bf16 gradients (a bf16 forward would round differently on each
    side), so the masters agree to f32 rounding of the updates."""
    ref, port = _models(dtype=torch.bfloat16)
    ro = paddle.optimizer.AdamW(0.01, parameters=ref.parameters(), weight_decay=0.1,
                                multi_precision=True)
    po = popt.AdamW(0.01, parameters=port.parameters(), weight_decay=0.1,
                    multi_precision=True)
    rng = np.random.RandomState(2)
    for _ in range(3):
        for p, r in zip(port.parameters(), ref.parameters()):
            g = rng.randn(*p.shape).astype(np.float32)
            r.grad = paddle.to_tensor(g, dtype="bfloat16")
            p.grad = torch.from_numpy(g).bfloat16()
        ro.step()
        po.step()
    for p, r in zip(port.parameters(), ref.parameters()):
        assert p.dtype == torch.bfloat16
        mp, mr = po._master_weights[id(p)], ro._master_weights[id(r)]
        assert mp.dtype == torch.float32 and str(mr.dtype) == "float32"
        np.testing.assert_allclose(mp.numpy(), np.asarray(mr), rtol=0, atol=ATOL)
        assert torch.equal(p.detach(), mp.to(torch.bfloat16))
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(r._data, np.float32))


def test_state_dict_round_trip_and_keys():
    ref, port, ro, po = _run(
        lambda m: paddle.optimizer.AdamW(_warmup_cosine(paddle.optimizer),
                                         parameters=m.parameters()),
        lambda m: popt.AdamW(_warmup_cosine(popt), parameters=m.parameters()), steps=2)
    sd, sd_r = po.state_dict(), ro.state_dict()
    assert sorted(sd) == sorted(sd_r)
    assert sorted(sd["states"]) == sorted(sd_r["states"]) == [f"param_{i}" for i in range(4)]
    for key, slots in sd_r["states"].items():
        assert sorted(sd["states"][key]) == sorted(slots) == ["m", "v"]
        for slot, val in slots.items():
            np.testing.assert_allclose(sd["states"][key][slot].numpy(), np.asarray(val),
                                       rtol=0, atol=ATOL)
    assert sd["LR_Scheduler"] == sd_r["LR_Scheduler"]
    # a fresh optimizer loaded from the numpy form continues as the first
    as_numpy = dict(sd, states={k: {s: v.numpy() for s, v in d.items()}
                                for k, d in sd["states"].items()})
    _, twin = _models()
    twin.load_state_dict(port.state_dict())
    po2 = popt.AdamW(_warmup_cosine(popt), parameters=twin.parameters())
    po2.set_state_dict(as_numpy)
    assert po2._step_count == 2 and po2.get_lr() == po.get_lr()
    for x, y in _batches(2, seed=4):
        _port_step(port, po, x, y)
        _port_step(twin, po2, x, y)
    for a, b in zip(port.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def test_lr_schedulers_match_reference():
    for make in (_warmup_cosine,
                 lambda lib: lib.lr.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01),
                 lambda lib: lib.lr.LinearWarmup(0.3, warmup_steps=4, start_lr=0.01,
                                                 end_lr=0.3)):
        ref, port = make(paddle.optimizer), make(popt)
        seq_r, seq_p = [], []
        for _ in range(12):
            seq_r.append(ref())
            seq_p.append(port())
            ref.step()
            port.step()
        assert seq_p == seq_r
        port.step(2)
        ref.step(2)
        assert port() == ref()
        state = port.state_dict()
        assert state == {k: v for k, v in ref.state_dict().items()}
