"""PyTorch port: activation recompute and ``TrainStep``'s remat policies, on
the CPU.

``recompute`` of a block gives the plain call's output and gradients bit
for bit under each policy (the forward is re-run, not changed), and the
recomputed forward takes the traced mark and the ``amp`` policy of the
forward it repeats. ``TrainStep`` on a tiny Llama (dense and MoE) under
``every_layer`` and ``selective`` gives the trajectory of ``"none"`` bit
for bit, and the reference's ``TrainStep`` with the same policy within the
tolerances of ``test_torch_llama_train.py``. The policy comes from the
keyword, else ``PADDLE_REMAT_POLICY``; an unknown one raises the
reference's ``ValueError``; ``remat_targets`` picks the blocks the
reference picks.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import tracing
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

from test_torch_llama_train import (TRAJ_LOSS_RTOL, TRAJ_OUTLIER_ATOL, TRAJ_OUTLIER_FRAC,
                                    TRAJ_PARAM_ATOL, _batch, _pair)

# the modules (both packages' ``distributed.recompute`` is the function)
rrec = importlib.import_module("paddle_tpu.distributed.recompute")
prec = importlib.import_module("paddle_tpu_torch.distributed.recompute")
POLICIES = ("every_layer", "selective")


@pytest.mark.parametrize("policy", [None, "every_layer", "selective"])
def test_recompute_of_a_block_is_the_plain_call(policy):
    _, pmodel = _pair(moe_num_experts=4)
    layer = pmodel.llama.layers[0]
    h0 = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 256).astype(np.float32))
    outs = []
    for run in (layer, lambda h: prec.recompute(layer, h, checkpoint_policy=policy)):
        h = h0.clone().requires_grad_(True)
        out = run(h)
        out.square().sum().backward()
        outs.append([out.detach(), h.grad] + [p.grad for p in layer.parameters()])
        layer.zero_grad(set_to_none=True)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert len(outs[0]) == 2 + 10


def test_the_recomputed_forward_takes_the_forward_s_marks():
    seen = []
    lin = torch.nn.Linear(4, 4)

    def block(x):
        s = pamp.amp_state()
        seen.append((tracing.is_traced(), s.enabled, s.level, s.dtype))
        return lin(x).relu()

    x = torch.randn(2, 4, requires_grad=True)
    with tracing.traced(), pamp.auto_cast(level="O2", dtype="float16"):
        y = prec.recompute(block, x)
    assert not tracing.is_traced() and not pamp.amp_state().enabled
    y.sum().backward()
    assert seen == [(True, True, "O2", torch.float16)] * 2
    with torch.no_grad():
        prec.recompute(block, x)
    assert len(seen) == 3


def test_recompute_sequential_is_the_plain_stack():
    torch.manual_seed(0)
    layers = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(5)])
    x = torch.randn(3, 8, requires_grad=True)
    want = layers(x)
    got = prec.recompute_sequential({"segments": 2}, layers, x)
    assert torch.equal(got, want)
    (g_want,) = torch.autograd.grad(want.sum(), x)
    (g_got,) = torch.autograd.grad(got.sum(), x)
    assert torch.equal(g_got, g_want)


def _ref_train(model, batches, policy):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1,
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(model, opt, lambda x, y: model(x, labels=y)[0],
                                recompute_policy=policy)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for x, y in batches]
    return losses, {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _port_train(pmodel, batches, policy=None):
    opt = AdamW(learning_rate=1e-3, parameters=pmodel.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(pmodel, opt, lambda x, y: pmodel(x, labels=y)[0],
                     recompute_policy=policy)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))) for x, y in batches]
    return losses, {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_train_step_policies_match_none_and_the_reference(moe):
    """Bit for bit "none" on both models; against the reference's
    ``selective`` step on the MoE model (the dense model's trajectory is
    held against the reference's in ``test_torch_llama_train.py``)."""
    batches = [_batch(20 + i, 1024) for i in range(3)]
    _, pmodel = _pair(seed=7, moe_num_experts=moe)
    init = {k: v.clone() for k, v in pmodel.state_dict().items()}
    losses_none, params_none = _port_train(pmodel, batches, "none")
    for policy in POLICIES:
        pmodel.load_state_dict(init)
        losses, params = _port_train(pmodel, batches, policy)
        assert losses == losses_none, policy
        assert all(np.array_equal(params[n], params_none[n]) for n in params), policy
        assert "forward" not in vars(pmodel.llama.layers[0])
    if not moe:
        return
    model, _ = _pair(seed=7, moe_num_experts=moe)
    losses_r, params_r = _ref_train(model, batches, "selective")
    np.testing.assert_allclose(losses, losses_r, rtol=TRAJ_LOSS_RTOL)
    for n in params_r:
        diff = np.abs(params[n] - params_r[n])
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        outliers = int((diff > TRAJ_PARAM_ATOL).sum())
        assert outliers <= max(2, TRAJ_OUTLIER_FRAC * diff.size), (n, outliers, diff.size)


def test_train_step_reads_the_policy_from_the_environment(monkeypatch):
    _, pmodel = _pair()
    ids, labels = (torch.from_numpy(a) for a in _batch(4, 1024))
    calls = []
    real = prec.recompute

    def counting(*a, **k):
        calls.append(k.get("checkpoint_policy"))
        return real(*a, **k)

    monkeypatch.setattr(prec, "recompute", counting)
    monkeypatch.setenv("PADDLE_REMAT_POLICY", "every_layer")
    step = TrainStep(pmodel, AdamW(parameters=pmodel.parameters()),
                     lambda x, y: pmodel(x, labels=y)[0])
    step(ids, labels)
    assert calls == ["every_layer"] * 2
    pinned = TrainStep(pmodel, AdamW(parameters=pmodel.parameters()),
                       lambda x, y: pmodel(x, labels=y)[0], recompute_policy="none")
    pinned(ids, labels)
    assert len(calls) == 2
    monkeypatch.setenv("PADDLE_REMAT_POLICY", "")
    step(ids, labels)
    assert len(calls) == 2


def test_unknown_policy_raises_the_reference_s_value_error():
    with pytest.raises(ValueError) as want:
        rrec.resolve_checkpoint_policy("full")
    with pytest.raises(ValueError) as got:
        prec.resolve_checkpoint_policy("full")
    assert str(got.value) == str(want.value)
    assert prec.CHECKPOINT_POLICIES == rrec.CHECKPOINT_POLICIES
    _, pmodel = _pair()
    step = TrainStep(pmodel, AdamW(parameters=pmodel.parameters()),
                     lambda x, y: pmodel(x, labels=y)[0], recompute_policy="full")
    with pytest.raises(ValueError, match="unknown recompute policy 'full'"):
        step(*(torch.from_numpy(a) for a in _batch(4, 1024)))
    assert "forward" not in vars(pmodel.llama.layers[0])


class _RefTwo(paddle.nn.Layer):
    def __init__(self, stack=False):
        super().__init__()
        self.a = paddle.nn.Linear(4, 4)
        self.act = paddle.nn.ReLU()
        self.b = (paddle.nn.Sequential(paddle.nn.Linear(4, 4), paddle.nn.ReLU(),
                                       paddle.nn.Linear(4, 2)) if stack
                  else paddle.nn.Linear(4, 2))


class _PortTwo(torch.nn.Module):
    def __init__(self, stack=False):
        super().__init__()
        self.a = torch.nn.Linear(4, 4)
        self.act = torch.nn.ReLU()
        self.b = (pnn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                 torch.nn.Linear(4, 2)) if stack
                  else torch.nn.Linear(4, 2))


def _names(model, targets, walk):
    names = {id(m): n for n, m in walk(model)}
    return [names[id(t)] for t in targets]


@pytest.mark.parametrize("kind", ["llama", "llama_moe", "sequential", "no_container"])
def test_remat_targets_are_the_reference_s(kind):
    if kind.startswith("llama"):
        model, pmodel = _pair(moe_num_experts=4 if kind == "llama_moe" else 0)
    else:
        model, pmodel = _RefTwo(kind == "sequential"), _PortTwo(kind == "sequential")
    want = _names(model, rrec.remat_targets(model), lambda m: m.named_sublayers())
    got = _names(pmodel, prec.remat_targets(pmodel), lambda m: m.named_modules())
    assert got == want and got
