"""PyTorch port: context-parallel (ring) Llama training against the
reference, on the CPU.

The reference's tiny ring configuration (``tests/test_distributed.py``
:263-270: vocab 64, hidden 32, 2 layers, 4 heads, 2 KV heads, head_dim 8)
is built by the reference without context parallelism and carried to the
port's ring model (``context_parallel="ring"``) by
``load_reference_state_dict``. Under a one-process mesh whose ``sep`` axis
has 4 ranks, the port's ring (the composed ring on the CPU, and the
ring-flash schedule on the kernels' plain versions when the gate is sent
there) gives the reference's loss and every gradient; two ``TrainStep``
calls lower the loss; the ring refuses a mask and a cache. Tolerances as
``test_torch_llama_train.py``: f32 sums in another order through 2 layers.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.ops import ring_attention as ra
from paddle_tpu_torch.optimizer import AdamW

LOSS_RTOL = 1e-5
GRAD_FRAC = 2e-4
TINY_RING = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                 use_flash_attention=False)


def _batch():
    rng = np.random.RandomState(0)
    return rng.randint(0, 64, (2, 32)).astype(np.int64), rng.randint(0, 64, (2, 32)).astype(np.int64)


def _reference():
    """The reference's model without context parallelism, its numpy state
    and its loss and gradients on the batch."""
    paddle.seed(7)
    model = ref.LlamaForCausalLM(ref.LlamaConfig(**TINY_RING))
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    ids, labels = _batch()
    loss, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return state, float(loss.numpy()), grads


def _ring_model(state):
    model = port.LlamaForCausalLM(port.LlamaConfig(**TINY_RING, context_parallel="ring"),
                                  device="cpu")
    return port.load_reference_state_dict(model, state)


@pytest.fixture
def sep4():
    with dist.ProcessMesh(shape=[1, 4], dim_names=["dp", "sep"]) as mesh:
        yield mesh


@pytest.mark.parametrize("schedule", ["composed", "flash"])
def test_ring_model_gives_the_reference_loss_and_every_gradient(sep4, monkeypatch, schedule):
    if schedule == "flash":      # the gate, as it decides for CUDA bf16 tensors
        monkeypatch.setattr(ra, "flash_runs", lambda q: True)
    calls = []
    for name in ("_composed", "ring_flash_attention"):
        orig = getattr(ra, name)
        monkeypatch.setattr(ra, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n)
                            or _o(*a, **k))
    state, loss_r, grads_r = _reference()
    model = _ring_model(state)
    ids, labels = _batch()
    loss, _ = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    assert calls == ["_composed" if schedule == "composed" else "ring_flash_attention"] * 2
    np.testing.assert_allclose(float(loss.detach()), loss_r, rtol=LOSS_RTOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(grads_r)
    for n, want in grads_r.items():
        err, scale = np.abs(grads[n] - want).max(), np.abs(want).max()
        assert err <= GRAD_FRAC * scale, (n, err, scale)


def test_two_train_steps_lower_the_loss(sep4):
    state, loss_r, _ = _reference()
    model = _ring_model(state)
    model, opt = dist.parallelize(model, AdamW(learning_rate=0.01,
                                               parameters=model.parameters()), mesh=sep4)
    step = TrainStep(model, opt, lambda x, y: model(x, labels=y)[0])
    ids, labels = (torch.from_numpy(a) for a in _batch())
    l1 = float(step(ids, labels))
    np.testing.assert_allclose(l1, loss_r, rtol=LOSS_RTOL)
    l2 = float(step(ids, labels))
    assert l2 < l1


def test_ring_refuses_a_mask_and_a_cache(sep4):
    model = port.LlamaForCausalLM(port.LlamaConfig(**TINY_RING, context_parallel="ring"),
                                  device="cpu")
    attn = model.llama.layers[0].self_attn
    h = torch.randn(1, 8, 32)
    with pytest.raises(ValueError, match="attention_mask"):
        attn(h, attention_mask=torch.ones(1, 1, 8, 8, dtype=torch.bool))
    kv = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="past_key_value"):
        attn(h, past_key_value=(kv, kv))
    with pytest.raises(ValueError, match="divide evenly"):
        attn(torch.randn(1, 6, 32))                       # 6 positions over 4 ranks
