"""PyTorch port: the Llama training path against the reference, on the CPU.

``LlamaConfig.tiny()`` in f32: the reference builds the model, its
``state_dict()`` goes to the port through numpy
(``load_reference_state_dict``), and both compute logits, the loss and
every parameter's gradient on the same seeded tokens; then a 5-call
``TrainStep`` (AdamW with decay 0.1, global-norm clipping, two micro-steps
per update) runs on both. The port runs its plain kernel versions (CPU
tensors). RoPE and cross entropy are held against their references on
their own. Tolerances are stated where used: f32 sums in another order
through 2 layers.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import fused_rotary_position_embedding as ref_rope
from paddle_tpu.models import llama as ref
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch.incubate.nn.functional import fused_rotary_position_embedding as rope
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import AdamW

LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
# gradients of a mean loss over 32 tokens: entries of 1e-6..1e-1; 2e-4 of
# each tensor's largest entry covers f32 sums in another order
GRAD_FRAC = 2e-4
# the 5-call trajectory: AdamW moves every weight by up to lr = 1e-3 per
# update. The bulk of each tensor agrees to f32 rounding of those steps
# (TRAJ_PARAM_ATOL); an element whose gradient sits near 0 takes the step
# lr * g / (|g| + eps), which turns a gradient difference of f32 rounding
# into up to lr / eps = 1e5 times as much step, so at most TRAJ_OUTLIER_FRAC
# of a tensor's elements (and at least 2 of a small tensor) may differ by
# more, and none by more than TRAJ_OUTLIER_ATOL (a fifth of one step).
TRAJ_LOSS_RTOL, TRAJ_PARAM_ATOL = 1e-5, 2e-6
TRAJ_OUTLIER_FRAC, TRAJ_OUTLIER_ATOL = 2e-4, 2e-4


def _batch(seed, vocab, b=2, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int64),
            rng.randint(0, vocab, (b, s)).astype(np.int64))


def _pair(seed=3, **overrides):
    paddle.seed(seed)
    cfg = ref.LlamaConfig.tiny(**overrides)
    model = ref.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(**overrides), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    return model, pmodel


def _ref_loss_grads(model, ids, labels):
    loss, logits = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    model.clear_gradients()
    return float(loss.numpy()), logits.numpy(), grads


def _port_loss_grads(pmodel, ids, labels):
    loss, logits = pmodel(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in pmodel.named_parameters()}
    pmodel.zero_grad(set_to_none=True)
    return float(loss.detach()), logits.detach().numpy(), grads


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        scale = np.abs(want[n]).max()
        err = np.abs(got[n] - want[n]).max()
        assert err <= GRAD_FRAC * scale, (n, err, scale)


@pytest.mark.parametrize("tied", [False, True])
def test_logits_loss_and_every_gradient_match(tied):
    model, pmodel = _pair(tie_word_embeddings=tied)
    assert (pmodel.lm_head is None) == tied
    ids, labels = _batch(1, 1024)
    loss_r, logits_r, grads_r = _ref_loss_grads(model, ids, labels)
    loss, logits, grads = _port_loss_grads(pmodel, ids, labels)
    np.testing.assert_allclose(logits, logits_r, rtol=LOGITS_RTOL, atol=LOGITS_ATOL)
    np.testing.assert_allclose(loss, loss_r, rtol=LOSS_RTOL)
    _assert_grads(grads, grads_r)
    assert pmodel.num_params() == sum(int(np.prod(p.shape)) for p in model.parameters())
    assert pmodel.flops_per_token(16) == model.flops_per_token(16)


def test_recompute_gives_the_same_result():
    _, pmodel = _pair()
    ids, labels = _batch(2, 1024)
    loss0, logits0, grads0 = _port_loss_grads(pmodel, ids, labels)
    for lyr in pmodel.llama.layers:
        lyr._recompute = True
    pmodel.train()
    loss1, logits1, grads1 = _port_loss_grads(pmodel, ids, labels)
    assert loss1 == loss0
    np.testing.assert_array_equal(logits1, logits0)
    for n in grads0:
        np.testing.assert_array_equal(grads1[n], grads0[n])


def test_state_dict_keys_are_checked():
    _, pmodel = _pair()
    state = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    port.load_reference_state_dict(pmodel, state)
    with pytest.raises(KeyError, match="missing"):
        port.load_reference_state_dict(pmodel, dict(list(state.items())[1:]))
    with pytest.raises(KeyError, match="extra"):
        port.load_reference_state_dict(pmodel, dict(state, extra=np.zeros(3)))
    for bad in ({"moe_num_experts": 4}, {"sequence_parallel": True},
                {"context_parallel": "ulysses"}):
        with pytest.raises(NotImplementedError, match="distributed slice"):
            port.LlamaForCausalLM(port.LlamaConfig.tiny(**bad), device="cpu")


@pytest.mark.parametrize("neox", [True, False])
def test_rope_matches_reference(neox):
    rng = np.random.RandomState(7)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    rq, rk, _ = ref_rope(paddle.to_tensor(q), paddle.to_tensor(k), None,
                         use_neox_rotary_style=neox, rotary_emb_base=500000.0)
    pq, pk, pv = rope(torch.from_numpy(q), torch.from_numpy(k), None,
                      use_neox_rotary_style=neox, rotary_emb_base=500000.0)
    assert pv is None
    np.testing.assert_allclose(pq.numpy(), rq.numpy(), atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), rk.numpy(), atol=1e-5)
    # given tables, [1, S, 1, D] as Paddle passes them
    ang = rng.rand(12, 16).astype(np.float32) * 3
    sin, cos = np.sin(ang)[None, :, None, :], np.cos(ang)[None, :, None, :]
    rq, _, _ = ref_rope(paddle.to_tensor(q), None, None, sin=paddle.to_tensor(sin),
                        cos=paddle.to_tensor(cos), use_neox_rotary_style=neox)
    pq, _, _ = rope(torch.from_numpy(q), None, None, sin=torch.from_numpy(sin),
                    cos=torch.from_numpy(cos), use_neox_rotary_style=neox)
    np.testing.assert_allclose(pq.numpy(), rq.numpy(), atol=1e-5)


def test_rope_rounds_sin_cos_to_bf16_at_long_positions():
    """In bf16 the tables are rounded to bf16 before the products, as the
    reference does; at positions up to 8191 that rounding shows. The port
    agrees with the reference on nearly every element and by far more than
    a version that multiplies in f32 and rounds once."""
    rng = np.random.RandomState(8)
    q = rng.randn(1, 8192, 1, 128).astype(np.float32)
    want = np.asarray(ref_rope(paddle.to_tensor(q).astype("bfloat16"),
                               rotary_emb_base=500000.0)[0].numpy(), np.float32)
    qb = torch.from_numpy(q).bfloat16()
    got = rope(qb, rotary_emb_base=500000.0)[0].float().numpy()
    s, c = port.rope_tables(torch.arange(8192), 500000.0, 128)
    x1, x2 = qb.float()[..., :64], qb.float()[..., 64:]
    s, c = s[None, :, None, :], c[None, :, None, :]
    once = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).bfloat16().float().numpy()
    same = np.mean(got == want)
    same_once = np.mean(once == want)
    assert same >= 0.999 and same_once < 0.99, (same, same_once)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)


@pytest.mark.parametrize("kind", ["ignore", "weight", "smoothing", "soft", "none"])
def test_cross_entropy_matches_reference(kind):
    rng = np.random.RandomState(9)
    logits = (rng.randn(12, 10) * 3).astype(np.float32)
    labels = rng.randint(0, 10, (12,)).astype(np.int64)
    labels[[1, 5]] = -100
    kw = {}
    if kind == "weight":
        kw["weight"] = rng.rand(10).astype(np.float32)
    if kind == "smoothing":
        kw["label_smoothing"] = 0.1
    if kind == "none":
        kw["reduction"] = "none"
    if kind == "soft":
        kw["soft_label"] = True
        soft = rng.rand(12, 10).astype(np.float32)
        labels = soft / soft.sum(-1, keepdims=True)

    def ref_args(a):
        return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a

    def port_args(a):
        return torch.from_numpy(a) if isinstance(a, np.ndarray) else a

    want = RF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(labels),
                            **{k: ref_args(v) for k, v in kw.items()}).numpy()
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = PF.cross_entropy(lt, torch.from_numpy(labels),
                           **{k: port_args(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    if kind == "ignore":
        got.backward()
        assert np.all(lt.grad.numpy()[[1, 5]] == 0)


def _ref_train(model, batches, steps):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1,
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(model, opt, lambda x, y: model(x, labels=y)[0],
                                accumulate_steps=2)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
              for x, y in batches[:steps]]
    return losses, {n: np.asarray(p._data) for n, p in model.named_parameters()}, opt


def _port_train(pmodel, batches, steps):
    opt = AdamW(learning_rate=1e-3, parameters=pmodel.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(pmodel, opt, lambda x, y: pmodel(x, labels=y)[0], accumulate_steps=2)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches[:steps]]
    return losses, {n: p.detach().numpy() for n, p in pmodel.named_parameters()}, opt


def test_train_step_trajectory_matches_reference():
    model, pmodel = _pair(seed=5)
    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    batches = [_batch(10 + i, 1024) for i in range(5)]
    losses_r, params_r, opt_r = _ref_train(model, batches, 5)
    losses, params, opt = _port_train(pmodel, batches, 5)
    np.testing.assert_allclose(losses, losses_r, rtol=TRAJ_LOSS_RTOL)
    assert opt._step_count == opt_r._step_count == 2
    # two updates of about lr each moved every weight
    assert all(np.abs(params[n] - start[n]).max() > 1e-3 for n in params)
    for n in params_r:
        diff = np.abs(params[n] - params_r[n])
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        outliers = int((diff > TRAJ_PARAM_ATOL).sum())
        assert outliers <= max(2, TRAJ_OUTLIER_FRAC * diff.size), (n, outliers, diff.size)


def test_train_step_refuses_what_it_does_not_do_and_eval_step_runs():
    _, pmodel = _pair()
    opt = AdamW(parameters=pmodel.parameters())
    for kw in ({"telemetry_export_every": 5}, {"recompute_policy": "full"},
               {"offload_optimizer": True}, {"numerics": "summary"},
               {"checkpoint_root": "ckpt"}, {"cast_fn": float}):
        with pytest.raises(NotImplementedError, match="slice of the port"):
            TrainStep(pmodel, opt, lambda: None, **kw)
    TrainStep(pmodel, opt, lambda: None, donate=False, numerics="off")
    ids, labels = _batch(4, 1024)
    out = EvalStep(pmodel, lambda x, y: pmodel(x, labels=y))(torch.from_numpy(ids),
                                                             torch.from_numpy(labels))
    assert len(out) == 2 and out[1].shape == (2, 16, 1024) and not out[0].requires_grad


def test_trained_model_still_serves():
    """After a training step the same module serves: decode_weights reads
    the trained parameters, and greedy decoding matches a fresh model
    loaded with them."""
    _, pmodel = _pair()
    opt = AdamW(1e-2, parameters=pmodel.parameters())
    TrainStep(pmodel, opt, lambda x, y: pmodel(x, labels=y)[0])(
        *(torch.from_numpy(a) for a in _batch(6, 1024)))
    fresh = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu", seed=99)
    fresh.load_decode_weights(port.decode_weights(pmodel))
    ids, plen = np.array([[3, 9, 27]], np.int32), np.array([3])
    a, _ = port.LlamaGreedyGenerator(pmodel, max_len=8)(ids, plen)
    b, _ = port.LlamaGreedyGenerator(fresh, max_len=8)(ids, plen)
    assert a.tolist() == b.tolist()
    # and the decode path agrees with the training forward on the prefix
    logits = pmodel(torch.from_numpy(ids.astype(np.int64))).detach()
    assert int(logits[0, -1].argmax()) == int(a[0, 3])
