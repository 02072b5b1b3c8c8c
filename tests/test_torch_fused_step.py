"""PyTorch port: the fused optimizer step, on the CPU.

``Optimizer.step()`` in its default (fused) regime gathers every parameter
group into one multi-tensor update (``optimizer/fused_step.py``); on the
CPU that update is the kernel's plain version, the composed per-parameter
update. Checked here:

- the port's fused regime against its per-parameter regime
  (``PADDLE_OPT_FUSED=0``): parameters, master weights and every state
  tensor equal bit for bit, over 3 steps, in every case below;
- the port's fused regime against the reference's, with the reference's
  own cases (``tests/test_fused_optimizer.py``) and the other optimizer
  classes, at 1e-6 absolute on f32 weights of order 1 (the same f32
  arithmetic; the norms and the bias corrections are rounded by other
  libraries); the bf16 master-weight case holds its bf16 parameters to one
  bf16 step of their magnitude, its f32 masters to 1e-6. The norm and value
  clips are held against the reference's per-parameter regime, since the
  reference's two regimes disagree there;
- the step layout cache (hits, misses, a changed set of gradients), the
  per-parameter loop for a clip callable of its own, the routes by class,
  state dicts that copy rather than alias the state the update now writes
  in place, and a ``TrainStep`` trajectory on ``LlamaConfig.tiny()`` equal
  bit for bit to the per-parameter loop.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as ropt
from paddle_tpu import nn as rnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.clip import clip_descriptor, functional_clip_leaves
from paddle_tpu_torch.optimizer import fused_step

ATOL = 1e-6
SHAPES = [(4, 3), (7,), (2, 5), (3, 3, 2), (1,), (6, 2)]
STEPS = 3


def _values(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _port_params(shapes, dtype=torch.float32, clipped=()):
    ps = []
    for i, v in enumerate(_values(0, shapes)):
        p = torch.nn.Parameter(torch.from_numpy(v).to(dtype))
        p.paddle_name = f"p{i}"
        if i in clipped:
            p.need_clip = False
        ps.append(p)
    return ps


def _ref_params(shapes, bf16=False, clipped=()):
    import jax.numpy as jnp

    ps = []
    for i, v in enumerate(_values(0, shapes)):
        p = paddle.Parameter(v, name=f"p{i}")
        if bf16:
            p._data = p._data.astype(jnp.bfloat16)
        if i in clipped:
            p.need_clip = False
        ps.append(p)
    return ps


def _grads(t, shapes):
    return _values(100 + t, shapes)


# case: (build(lib, nn, ps), options); lib is the optimizer package, nn the
# clips' package, both the reference's or the port's
CASES = {
    "sgd": (lambda lib, nn, ps: lib.SGD(0.1, parameters=ps), {}),
    "sgd_l2": (lambda lib, nn, ps: lib.SGD(0.1, parameters=ps, weight_decay=0.01), {}),
    "momentum_nesterov": (lambda lib, nn, ps: lib.Momentum(0.1, 0.9, parameters=ps,
                                                           use_nesterov=True), {}),
    "momentum_l2": (lambda lib, nn, ps: lib.Momentum(0.1, 0.9, parameters=ps,
                                                     weight_decay=0.01), {}),
    "adam": (lambda lib, nn, ps: lib.Adam(0.05, parameters=ps), {}),
    "adam_l2": (lambda lib, nn, ps: lib.Adam(0.05, parameters=ps, weight_decay=0.01), {}),
    "adamw": (lambda lib, nn, ps: lib.AdamW(0.05, parameters=ps, weight_decay=0.1), {}),
    "adamw_decay_param_fun": (lambda lib, nn, ps: lib.AdamW(
        0.05, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=lambda n: not n.endswith("1")), {}),
    "global_norm_clip": (lambda lib, nn, ps: lib.AdamW(
        0.05, parameters=ps, grad_clip=nn.ClipGradByGlobalNorm(0.25)), {}),
    "global_norm_clip_need_clip_false": (lambda lib, nn, ps: lib.Momentum(
        0.1, 0.9, parameters=ps, grad_clip=nn.ClipGradByGlobalNorm(0.25)),
        {"clipped": (1, 3)}),
    "param_groups": (lambda lib, nn, ps: lib.AdamW(0.05, weight_decay=0.01, parameters=[
        {"params": ps[:3], "learning_rate": 1.0, "weight_decay": 0.2},
        {"params": ps[3:], "learning_rate": 0.1}]), {}),
    "grads_appear_disappear": (lambda lib, nn, ps: lib.Adam(0.05, parameters=ps),
                               {"skips": {1: (0, 4)}}),
    "bf16_master_weights": (lambda lib, nn, ps: lib.AdamW(
        0.05, parameters=ps, multi_precision=True, grad_clip=nn.ClipGradByGlobalNorm(0.5)),
        {"bf16": True}),
    "lr_scheduler": (lambda lib, nn, ps: lib.SGD(lib.lr.StepDecay(0.1, step_size=1, gamma=0.5),
                                                 parameters=ps), {"sched": True}),
    "adagrad": (lambda lib, nn, ps: lib.Adagrad(0.1, parameters=ps, weight_decay=0.01), {}),
    "rmsprop_centered": (lambda lib, nn, ps: lib.RMSProp(0.01, momentum=0.5, centered=True,
                                                         parameters=ps), {}),
    "adadelta": (lambda lib, nn, ps: lib.Adadelta(0.5, parameters=ps), {}),
    "adamax": (lambda lib, nn, ps: lib.Adamax(0.05, parameters=ps), {}),
    "lamb": (lambda lib, nn, ps: lib.Lamb(0.05, parameters=ps, exclude_from_weight_decay_fn=(
        lambda p: (getattr(p, "paddle_name", None) or p.name).endswith("2"))), {}),
    "lars": (lambda lib, nn, ps: lib.Lars(0.1, parameters=ps, lars_weight_decay=0.01,
                                          exclude_from_weight_decay=["p3"]), {}),
    "norm_clip": (lambda lib, nn, ps: lib.SGD(0.1, parameters=ps,
                                              grad_clip=nn.ClipGradByNorm(0.3)),
                  {"ref_regime": "0"}),
    "value_clip": (lambda lib, nn, ps: lib.SGD(0.1, parameters=ps,
                                               grad_clip=nn.ClipGradByValue(0.02)),
                   {"ref_regime": "0"}),
}


def _run_port(case, regime, monkeypatch):
    build, opts = CASES[case]
    monkeypatch.setenv("PADDLE_OPT_FUSED", regime)
    ps = _port_params(SHAPES, torch.bfloat16 if opts.get("bf16") else torch.float32,
                      opts.get("clipped", ()))
    o = build(popt, pnn, ps)
    for t in range(STEPS):
        skip = opts.get("skips", {}).get(t, ())
        for i, (p, g) in enumerate(zip(ps, _grads(t, SHAPES))):
            p.grad = None if i in skip else torch.from_numpy(g).to(p.dtype)
        o.step()
        if opts.get("sched"):
            o._learning_rate.step()
    return ps, o


def _run_ref(case, regime, monkeypatch):
    build, opts = CASES[case]
    monkeypatch.setenv("PADDLE_OPT_FUSED", regime)
    ps = _ref_params(SHAPES, opts.get("bf16", False), opts.get("clipped", ()))
    o = build(ropt, rnn, ps)
    for t in range(STEPS):
        skip = opts.get("skips", {}).get(t, ())
        for i, (p, g) in enumerate(zip(ps, _grads(t, SHAPES))):
            p.grad = None if i in skip else paddle.to_tensor(g, dtype=str(p.dtype))
        o.step()
        if opts.get("sched"):
            o._learning_rate.step()
    return ps, o


@pytest.mark.parametrize("case", list(CASES))
def test_fused_regime_equals_per_parameter_regime(case, monkeypatch):
    """Bit for bit: parameters, masters and every state tensor."""
    p1, o1 = _run_port(case, "1", monkeypatch)
    p2, o2 = _run_port(case, "0", monkeypatch)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
        sa, sb = o1._accumulators[id(a)], o2._accumulators[id(b)]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        if id(a) in o1._master_weights:
            assert torch.equal(o1._master_weights[id(a)], o2._master_weights[id(b)])
    assert o1._step_count == o2._step_count == STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_fused_regime_matches_reference(case, monkeypatch):
    ps, o = _run_port(case, "1", monkeypatch)
    rs, ro = _run_ref(case, CASES[case][1].get("ref_regime", "1"), monkeypatch)
    bf16 = CASES[case][1].get("bf16", False)
    for p, r in zip(ps, rs):
        got, want = p.detach().float().numpy(), np.asarray(r._data, np.float32)
        # bf16: one bf16 step (2^-8 of the magnitude) where the masters
        # straddle a rounding boundary
        atol = 2.0 ** -8 * np.abs(want).max() if bf16 else ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=r.name)
        sp, sr = o._accumulators[id(p)], ro._accumulators[id(r)]
        assert sorted(sp) == sorted(sr)
        for k in sr:
            np.testing.assert_allclose(sp[k].float().numpy(), np.asarray(sr[k], np.float32),
                                       rtol=0, atol=ATOL, err_msg=f"{r.name} {k}")
        if bf16:
            np.testing.assert_allclose(o._master_weights[id(p)].numpy(),
                                       np.asarray(ro._master_weights[id(r)]), rtol=0,
                                       atol=ATOL)
    assert o.get_lr() == ro.get_lr()


def _adam(ps):
    return popt.Adam(0.05, parameters=ps)


def _set_grads(ps, t, skip=()):
    for i, (p, g) in enumerate(zip(ps, _grads(t, SHAPES))):
        p.grad = None if i in skip else torch.from_numpy(g)


def test_cache_hits_and_a_changed_set_of_gradients_is_a_miss():
    fused_step.clear_cache()
    ps = _port_params(SHAPES)
    o = _adam(ps)
    before = fused_step.stats()
    _set_grads(ps, 0)
    o.step()
    for t in range(1, 4):
        _set_grads(ps, t)
        o.step()
    s = fused_step.stats()
    assert s["fused_cache_misses"] - before["fused_cache_misses"] == 1
    assert s["fused_cache_hits"] - before["fused_cache_hits"] == 3
    _set_grads(ps, 4, skip=(2,))
    o.step()
    _set_grads(ps, 5, skip=(2,))
    o.step()
    after = fused_step.stats()
    assert after["fused_cache_misses"] - s["fused_cache_misses"] == 1
    assert after["fused_cache_hits"] - s["fused_cache_hits"] == 1
    assert after["fused_steps"] - before["fused_steps"] == 6
    assert after["dispatches"] - before["dispatches"] == 6


def test_custom_clip_callable_takes_the_per_parameter_loop(monkeypatch):
    monkeypatch.setenv("PADDLE_OPT_FUSED", "1")
    ps = _port_params(SHAPES[:2])
    o = popt.SGD(0.1, parameters=ps,
                 grad_clip=lambda pg: [(p, g * 0.5) for p, g in pg])
    _set_grads(ps, 0)
    before = fused_step.stats()
    o.step()
    after = fused_step.stats()
    assert after["dispatches"] - before["dispatches"] == len(ps)
    assert after["fused_steps"] == before["fused_steps"]
    want = _values(0, SHAPES[:2])[0] - np.float32(0.1) * (_grads(0, SHAPES)[0] * np.float32(0.5))
    np.testing.assert_allclose(ps[0].detach().numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cls,route", [("SGD", "kernel"), ("Momentum", "kernel"),
                                       ("Adam", "kernel"), ("AdamW", "kernel"),
                                       ("Adagrad", "composed"), ("RMSProp", "composed"),
                                       ("Adadelta", "composed"), ("Adamax", "composed"),
                                       ("Lamb", "composed"), ("Lars", "composed")])
def test_route_is_fixed_by_class(cls, route):
    ps = _port_params(SHAPES)
    o = getattr(popt, cls)(0.01, parameters=ps)
    _set_grads(ps, 0)
    before = fused_step.stats()["by_route"]
    o.step()
    after = fused_step.stats()["by_route"]
    assert {k: after[k] - before[k] for k in after} == {
        "kernel": int(route == "kernel"), "composed": int(route == "composed")}


def test_state_dict_copies_the_state_the_update_writes_in_place():
    ps = _port_params(SHAPES)
    o = _adam(ps)
    for t in range(2):
        _set_grads(ps, t)
        o.step()
    sd = o.state_dict()
    saved = {k: {s: v.clone() for s, v in d.items()} for k, d in sd["states"].items()}
    state_before = {id(p): dict(o._accumulators[id(p)]) for p in ps}
    _set_grads(ps, 2)
    o.step()
    for k, d in sd["states"].items():
        for s, v in d.items():
            assert torch.equal(v, saved[k][s]), (k, s)
    # the step wrote the state in place: the same tensors, new values
    for p in ps:
        for s, v in o._accumulators[id(p)].items():
            assert v is state_before[id(p)][s]
    # a loaded state dict is copied too: stepping does not change it
    twin_ps = _port_params(SHAPES)
    twin = _adam(twin_ps)
    twin.set_state_dict(sd)
    _set_grads(twin_ps, 2)
    twin.step()
    for k, d in sd["states"].items():
        for s, v in d.items():
            assert torch.equal(v, saved[k][s]), (k, s)


def test_state_dict_round_trip_in_the_fused_regime(monkeypatch):
    monkeypatch.setenv("PADDLE_OPT_FUSED", "1")
    ps = _port_params(SHAPES)
    o = _adam(ps)
    for t in range(2):
        _set_grads(ps, t)
        o.step()
    sd = o.state_dict()
    twin_ps = _port_params(SHAPES)
    for a, b in zip(twin_ps, ps):
        a.data.copy_(b.detach())
    twin = _adam(twin_ps)
    twin.set_state_dict(sd)
    assert twin._step_count == 2
    for group in (ps, twin_ps):
        _set_grads(group, 2)
    o.step()
    twin.step()
    for a, b in zip(ps, twin_ps):
        assert torch.equal(a, b)
        for k, v in o._accumulators[id(a)].items():
            assert torch.equal(v, twin._accumulators[id(b)][k])


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_equals_the_per_parameter_loop(accumulate):
    """A TrainStep on tiny Llama (AdamW with decay 0.1 and global-norm
    clipping) against the per-parameter loop written out: the same
    gradients, the composed update of each parameter, bit for bit; the
    state is updated in place."""
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    twin = LlamaForCausalLM(cfg, device="cpu", seed=1)
    twin.load_state_dict(model.state_dict())

    def make_opt(m):
        return popt.AdamW(1e-3, parameters=m.parameters(), weight_decay=0.1,
                          grad_clip=pnn.ClipGradByGlobalNorm(1.0))

    step = TrainStep(model, make_opt(model), lambda x, y: model(x, labels=y)[0],
                     accumulate_steps=accumulate)
    opt = make_opt(twin)
    params = [p for p in twin.parameters() if p.requires_grad]
    states = [popt.AdamW.init_state(p.detach()) for p in params]
    rng = np.random.RandomState(7)
    acc, first_state = None, None
    for call in range(3 * accumulate):
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
        labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
        step(ids, labels)
        if first_state is None and step._opt_state is not None:
            first_state = [dict(s) for s in step._opt_state]
        loss = twin(ids, labels=labels)[0].float()
        grads = torch.autograd.grad(loss, params)
        if accumulate > 1:
            acc = [g.float() for g in grads] if acc is None else [
                a + g.float() for a, g in zip(acc, grads)]
            if (call + 1) % accumulate:
                continue
            grads, acc = [a / accumulate for a in acc], None
        opt._step_count += 1
        grads = functional_clip_leaves(clip_descriptor(opt._grad_clip), grads,
                                       [True] * len(grads))
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                new_p, states[i] = popt.AdamW.update(p.detach(), g.to(p.dtype), states[i],
                                                     opt.get_lr(), opt._step_count,
                                                     opt._hyper())
                p.copy_(new_p)
    for (n, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), n
    for s_step, s_loop, s_first in zip(step._opt_state, states, first_state):
        for k in s_loop:
            assert torch.equal(s_step[k], s_loop[k])
            assert s_step[k] is s_first[k]
