"""PyTorch port: the Mixture-of-Experts Llama against the reference, on the CPU.

``LlamaConfig.tiny(moe_num_experts=4)`` at 2 layers in f32: every decoder
layer's MLP is ``fleet.MoELayer`` (top-2, capacity factor 1.5). The
reference builds the model, its ``state_dict()`` goes to the port by key,
and both compute logits, the loss plus 0.02 times the layers' aux losses
(Mixtral's ``router_aux_loss_coef``) and every parameter's gradient on
the same seeded tokens, under the dense dispatch the policy picks at this
size and under sort (the ``moe_dispatch`` flag of each package); then a
3-call ``TrainStep`` (AdamW, decay 0.1, global-norm clipping) on both.
Tolerances are those of ``test_torch_llama_train.py``: f32 sums in
another order through 2 layers. Decoding an MoE model is refused, as the
reference refuses it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

from test_torch_llama_train import (GRAD_FRAC, LOGITS_ATOL, LOGITS_RTOL, LOSS_RTOL,
                                    TRAJ_LOSS_RTOL, TRAJ_OUTLIER_ATOL, TRAJ_OUTLIER_FRAC,
                                    TRAJ_PARAM_ATOL, _assert_grads, _batch)

AUX_COEF = 0.02
MOE = dict(moe_num_experts=4)


def _pair(seed=3):
    paddle.seed(seed)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny(**MOE))
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(**MOE), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    return model, pmodel


def _aux(model):
    return sum(lyr.mlp.aux_loss for lyr in model.llama.layers)


def _ref_loss(model, x, y):
    return model(x, labels=y)[0] + AUX_COEF * _aux(model)


def _port_loss(pmodel, x, y):
    return pmodel(x, labels=y)[0] + AUX_COEF * _aux(pmodel)


def _loss_and_logits(model, x, y):
    ce, logits = model(x, labels=y)
    return ce + AUX_COEF * _aux(model), logits


@pytest.fixture(params=["dense", "sort"])
def dispatch(request):
    """Both packages' ``moe_dispatch`` flag set to the path for the test."""
    paddle.set_flags({"moe_dispatch": request.param})
    pflags.set_flags({"moe_dispatch": request.param})
    yield request.param
    paddle.set_flags({"moe_dispatch": ""})
    pflags.set_flags({"moe_dispatch": ""})


def test_logits_loss_and_every_gradient_match(dispatch):
    model, pmodel = _pair()
    assert type(pmodel.llama.layers[0].mlp).__name__ == "MoELayer"
    assert sorted(pmodel.state_dict()) == sorted(model.state_dict())
    ids, labels = _batch(1, 1024)
    loss_r, logits_r = _loss_and_logits(model, paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss_r.backward()
    grads_r = {n: p.grad.numpy() for n, p in model.named_parameters()}
    loss, logits = _loss_and_logits(pmodel, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in pmodel.named_parameters()}
    np.testing.assert_allclose(logits.detach().numpy(), logits_r.numpy(), rtol=LOGITS_RTOL,
                               atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_r.numpy()), rtol=LOSS_RTOL)
    for lyr, lyr_r in zip(pmodel.llama.layers, model.llama.layers):
        np.testing.assert_allclose(float(lyr.mlp.aux_loss.detach()),
                                   float(lyr_r.mlp.aux_loss.numpy()), rtol=1e-6)
    _assert_grads(grads, grads_r)
    assert pmodel.num_params() == sum(int(np.prod(p.shape)) for p in model.parameters())


def test_train_step_trajectory_matches_reference():
    model, pmodel = _pair(seed=5)
    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    batches = [_batch(10 + i, 1024) for i in range(3)]
    opt_r = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                   weight_decay=0.1,
                                   grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step_r = paddle.jit.TrainStep(model, opt_r, lambda x, y: _ref_loss(model, x, y))
    losses_r = [float(step_r(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
                for x, y in batches]
    opt = AdamW(learning_rate=1e-3, parameters=pmodel.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(pmodel, opt, lambda x, y: _port_loss(pmodel, x, y))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))) for x, y in batches]
    np.testing.assert_allclose(losses, losses_r, rtol=TRAJ_LOSS_RTOL)
    assert opt._step_count == 3
    params_r = {n: np.asarray(p._data) for n, p in model.named_parameters()}
    for n, p in pmodel.named_parameters():
        got = p.detach().numpy()
        assert np.abs(got - start[n]).max() > 1e-3, n
        diff = np.abs(got - params_r[n])
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        outliers = int((diff > TRAJ_PARAM_ATOL).sum())
        assert outliers <= max(2, TRAJ_OUTLIER_FRAC * diff.size), (n, outliers, diff.size)


def test_decode_refuses_moe_as_the_reference():
    cfg = dict(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
               num_attention_heads=2, num_key_value_heads=2, moe_num_experts=2)
    paddle.seed(0)
    with pytest.raises(ValueError, match="MoE") as want:
        ref.decode_weights(ref.LlamaForCausalLM(ref.LlamaConfig.tiny(**cfg)))
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(**cfg), device="cpu")
    with pytest.raises(ValueError, match="MoE") as got:
        port.decode_weights(pmodel)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(pmodel, device="cpu")
