"""PyTorch port: the slice as a whole on the CPU. ``OpsLlama``, the Llama
that ``chip_smoke.py`` writes as a Paddle user writes one (``nn.Layer``
subclasses, ``create_parameter`` with ``ParamAttr``, a forward of public
ops and ``nn.functional``), at ``LlamaConfig.tiny()`` in f32 against the
reference's ``LlamaForCausalLM``.

The script is loaded by path, as ``test_torch_isolation.py`` loads it. The
reference model's ``state_dict()`` goes into ``OpsLlama`` through
``set_state_dict`` from numpy; both compute the loss and every gradient on
the same seeded tokens, then run Paddle's eager loop (``loss.backward();
opt.step(); opt.clear_grad()``, AdamW with decay 0.1 and global-norm
clipping) for 3 steps, the reference in its per-parameter regime
(``PADDLE_OPT_FUSED=0``). Tolerances are ``test_torch_llama_train.py``'s:
f32 sums in another order through 2 layers.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu.models import llama as ref
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from torch_op_parity import port_globals  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_FRAC = 2e-4              # of each gradient's largest entry
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_ATOL = 2e-6        # the bulk of each tensor after 3 AdamW steps of lr 1e-3
TRAJ_OUTLIER_FRAC, TRAJ_OUTLIER_ATOL = 2e-4, 2e-4   # elements whose gradient sits near 0


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture
def per_param_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_OPT_FUSED", "0")


def _pair(seed=3):
    paddle.seed(seed)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny())
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    ops = SMOKE.ops_llama_class()(LlamaConfig.tiny())
    missing, unexpected = ops.set_state_dict(state)
    assert missing == [] and unexpected == []
    return model, ops


def _batch(seed, vocab=1024, b=2, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int64),
            rng.randint(0, vocab, (b, s)).astype(np.int64))


def test_ops_llama_is_a_layer_with_the_references_names():
    model, ops = _pair()
    assert isinstance(ops, port.nn.Layer) and isinstance(ops, torch.nn.Module)
    assert list(ops.state_dict()) == list(model.state_dict())
    w = ops.llama.layers[1].mlp.down_proj.weight
    assert isinstance(w, port.Parameter) and w.paddle_name == "llama.layers.1.mlp.down_proj.weight"
    assert w.device.type == "cpu" and w.dtype == torch.float32
    port.seed(0)
    fresh = SMOKE.ops_llama_class()(LlamaConfig.tiny())
    std = float(fresh.llama.embed_tokens.weight.detach().std())
    assert abs(std - SMOKE.OPS_INIT_STD) < 0.001, std
    port.seed(0)
    again = SMOKE.ops_llama_class()(LlamaConfig.tiny())
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), again.parameters()))


def test_loss_and_every_gradient_match_the_reference():
    model, ops = _pair()
    ids, labels = _batch(1)
    loss_r, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss_r.backward()
    grads_r = {n: p.grad.numpy() for n, p in model.named_parameters()}
    loss, _ = ops(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(loss_r.numpy()), rtol=LOSS_RTOL)
    grads = {n: p.grad.numpy() for n, p in ops.named_parameters()}
    assert sorted(grads) == sorted(grads_r)
    for n, want in grads_r.items():
        err = np.abs(grads[n] - want).max()
        assert err <= GRAD_FRAC * np.abs(want).max(), (n, err)


def test_ops_llama_equals_the_ports_llama_bit_for_bit():
    """The same weights through LlamaForCausalLM: the same ops in the same
    order, so the same bits (the card's step 1 holds the same in bf16)."""
    _, ops = _pair()
    plain = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    plain.set_state_dict(ops.state_dict())
    ids, labels = _batch(2)
    loss = ops(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0]
    want = plain(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0]
    assert float(loss) == float(want)


def test_eager_adamw_trajectory_matches_the_reference(per_param_reference):
    model, ops = _pair(seed=5)
    batches = [_batch(10 + i) for i in range(3)]
    ro = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                weight_decay=0.1, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    po = AdamW(learning_rate=1e-3, parameters=ops.parameters(), weight_decay=0.1,
               grad_clip=ClipGradByGlobalNorm(1.0))
    for x, y in batches:
        loss_r, _ = model(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss_r.backward()
        ro.step()
        ro.clear_grad()
        loss, _ = ops(torch.from_numpy(x), labels=torch.from_numpy(y))
        loss.backward()
        po.step()
        po.clear_grad()
        np.testing.assert_allclose(float(loss), float(loss_r.numpy()), rtol=TRAJ_LOSS_RTOL)
    got = {n: p.detach().numpy() for n, p in ops.named_parameters()}
    for n, p in model.named_parameters():
        diff = np.abs(got[n] - np.asarray(p._data))
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        assert int((diff > TRAJ_PARAM_ATOL).sum()) <= max(2, TRAJ_OUTLIER_FRAC * diff.size), n
