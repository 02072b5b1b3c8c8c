"""PyTorch port: the ERNIE encoders against the reference, on the CPU.

``ErnieConfig.tiny()`` in f32: the reference builds each model, its
``state_dict()`` goes to the port through numpy
(``load_reference_state_dict``), and both run the same seeded tokens with a
padded tail:

- ``ErnieModel``'s ``sequence_output`` and ``pooled_output`` with the
  default pad mask, an explicit ``attention_mask``, token types, positions
  and the task-type embeddings; the mask's values and dtype;
- every head: sequence and token classification, question answering and
  the masked LM;
- the masked LM's tie: the decoder is the embedding's ``Parameter``, the
  reference's state-dict keys (no ``cls._tied``) load key for key, the
  table gets both gradients, and a ``TrainStep`` updates it once, as the
  reference's does;
- a 3-step ``TrainStep`` AdamW trajectory of the sequence classifier
  (losses and every parameter) against the reference's ``TrainStep``;
- under ``amp.auto_cast`` O2 (bf16 weights), the mask reaches the
  attention as bf16 on both sides and the outputs agree to bf16 rounding;
- construction from a seed (same seed, same weights) and dropout drawn
  from the model's one generator (same state, same loss).

Tolerances (as ``tests/test_torch_llama_train.py``): f32 sums in another
order through 2 layers: outputs within 1e-4 relative and absolute, losses
within 1e-5; after 3 AdamW updates of lr 1e-3 the bulk of each tensor
within 2e-6, at most 2e-4 of its elements (at least 2) past that and none
past 2e-4 (a gradient near 0 turns f32 rounding into up to lr / eps as
much step); the key projections' biases, whose gradient is 0 but for
rounding, within 1.1 lr a step of their start on each side. Under O2 both sides round the same ops to bf16 in other
orders: outputs within 2^-6 of the largest magnitude (two bf16 ulps
there).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as ramp
from paddle_tpu import models as ref
from paddle_tpu.nn import functional as RF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import models as port
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models._weights import reference_state_dict
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import attention as pattn
from paddle_tpu_torch.optimizer import AdamW

OUT_RTOL, OUT_ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
TRAJ_PARAM_ATOL, TRAJ_OUTLIER_FRAC, TRAJ_OUTLIER_ATOL = 2e-6, 2e-4, 2e-4
O2_FRAC = 2.0 ** -6
LR = 1e-3
# the key projection's bias shifts every logit of a query by one amount,
# which softmax cancels: its gradient is 0 but for rounding, and AdamW
# turns that noise into steps of up to about lr (1.1 lr with the decay's
# share), so it is held to that on each side and not against the other
ZERO_GRAD, ZERO_GRAD_STEPS = "self_attn.k_proj.bias", 1.1
HEADS = {"model": "ErnieModel", "seq": "ErnieForSequenceClassification",
         "token": "ErnieForTokenClassification", "qa": "ErnieForQuestionAnswering",
         "mlm": "ErnieForMaskedLM"}


def _ids(cfg, b=4, s=16, seed=0, pad=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (b, s)).astype(np.int64)
    ids[:, s - pad:] = cfg.pad_token_id
    return ids


def _pair(head="model", seed=3, **overrides):
    """(reference model, port model with its weights), both in eval mode."""
    paddle.seed(seed)
    cfg = ref.ErnieConfig.tiny(**overrides)
    kw = {"num_classes": 7} if head == "token" else {}
    model = getattr(ref, HEADS[head])(cfg, **kw)
    model.eval()
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = getattr(port, HEADS[head])(port.ErnieConfig.tiny(**overrides), device="cpu",
                                        **kw)
    port.load_reference_state_dict(pmodel, state)
    return model, pmodel.eval()


def _both(model, pmodel, *arrays, **kw):
    """Outputs of both on the same numpy inputs, as lists of numpy arrays."""
    want = model(*map(paddle.to_tensor, arrays),
                 **{k: paddle.to_tensor(v) for k, v in kw.items()})
    got = pmodel(*map(torch.from_numpy, arrays), **{k: torch.from_numpy(v)
                                                     for k, v in kw.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return ([g.detach().float().numpy() for g in got],
            [np.asarray(w.numpy(), np.float32) for w in want])


def _close(got, want, rtol=OUT_RTOL, atol=OUT_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_model_outputs_match_reference_with_padding():
    model, pmodel = _pair()
    cfg = pmodel.config
    ids = _ids(cfg)
    got, want = _both(model, pmodel, ids)
    assert got[0].shape == (4, 16, cfg.hidden_size) and got[1].shape == (4, cfg.hidden_size)
    _close(got, want)
    # an explicit mask, token types and positions
    mask = np.ones_like(ids)
    mask[:, -5:] = 0
    types = np.random.RandomState(1).randint(0, cfg.type_vocab_size, ids.shape)
    pos = np.tile(np.arange(16)[::-1].copy(), (4, 1)).astype(np.int64)
    got, want = _both(model, pmodel, ids, types, pos, mask)
    _close(got, want)
    # the pad tokens' values do not reach the real positions
    ids2 = ids.copy()
    ids2[:, -5:] = 7
    got2, _ = _both(model, pmodel, ids2, types, pos, mask)
    np.testing.assert_allclose(got2[0][:, :11], got[0][:, :11], rtol=1e-5, atol=1e-6)


def test_additive_mask():
    _, pmodel = _pair()
    ids = torch.from_numpy(_ids(pmodel.config, b=2, s=6, pad=2))
    mask = pmodel._additive_mask(ids, None)
    assert mask.shape == (2, 1, 1, 6) and mask.dtype == torch.float32
    assert torch.equal(mask[0, 0, 0], torch.tensor([0.0] * 4 + [-1e9] * 2))
    explicit = pmodel._additive_mask(ids, torch.tensor([[1, 1, 1, 0, 0, 0]] * 2))
    assert torch.equal(explicit[1, 0, 0], torch.tensor([0.0] * 3 + [-1e9] * 3))


def test_task_type_embeddings():
    model, pmodel = _pair(task_type_vocab_size=3)
    assert pmodel.embeddings.task_type_embeddings.weight.shape == (3, 32)
    ids = _ids(pmodel.config)
    _close(*_both(model, pmodel, ids))
    tasks = np.random.RandomState(2).randint(0, 3, ids.shape)
    _close(*_both(model, pmodel, ids, task_type_ids=tasks))


@pytest.mark.parametrize("head", ["seq", "token", "qa", "mlm"])
def test_head_outputs_match_reference(head):
    model, pmodel = _pair(head)
    ids = _ids(pmodel.ernie.config, seed=4)
    got, want = _both(model, pmodel, ids)
    shapes = {"seq": [(4, 2)], "token": [(4, 16, 7)], "qa": [(4, 16), (4, 16)],
              "mlm": [(4, 16, 128)]}[head]
    assert [g.shape for g in got] == shapes
    _close(got, want)


def test_mlm_head_is_tied_and_loads_the_references_keys():
    model, pmodel = _pair("mlm")
    table = pmodel.ernie.embeddings.word_embeddings.weight
    assert pmodel.cls._tied is table
    ref_keys = list(model.state_dict())
    # nn.Layer's state_dict lists each parameter once, as the reference's;
    # torch's own (called with its prefix) keeps the alias
    assert "cls._tied" not in ref_keys and "cls._tied" not in pmodel.state_dict()
    assert "cls._tied" in pmodel.state_dict(prefix="")
    assert list(reference_state_dict(pmodel)) == ref_keys
    assert sum(p is table for p in pmodel.parameters()) == 1
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        port.load_reference_state_dict(pmodel, {k: v for k, v in state.items()
                                                if k != "ernie.embeddings.word_embeddings"
                                                             ".weight"})
    with pytest.raises(KeyError, match="extra"):
        port.load_reference_state_dict(pmodel, dict(state, **{"cls._tied": state[
            "ernie.embeddings.word_embeddings.weight"]}))
    # the table gets the decoder's gradient and the lookup's
    ids = torch.from_numpy(_ids(pmodel.ernie.config))
    loss = PF.cross_entropy(pmodel(ids).reshape(-1, 128), ids.reshape(-1))
    (g_all,) = torch.autograd.grad(loss, [table])
    with torch.no_grad():
        detached = torch.nn.Parameter(table.detach().clone())
    pmodel.cls._tied = detached
    loss = PF.cross_entropy(pmodel(ids).reshape(-1, 128), ids.reshape(-1))
    g_lookup, g_decoder = torch.autograd.grad(loss, [table, detached])
    pmodel.cls._tied = table
    np.testing.assert_allclose(g_all.numpy(), (g_lookup + g_decoder).numpy(), rtol=1e-5,
                               atol=1e-7)
    assert g_decoder.abs().sum() > 0 and g_lookup.abs().sum() > 0


def _ref_steps(model, batches, loss_fn):
    opt = paddle.optimizer.AdamW(learning_rate=LR, parameters=model.parameters(),
                                 weight_decay=0.01)
    step = paddle.jit.TrainStep(model, opt, loss_fn(model, RF))
    losses = [float(step(*map(paddle.to_tensor, b)).numpy()) for b in batches]
    return losses, {n: np.asarray(p._data) for n, p in model.named_parameters()}


def _port_steps(pmodel, batches, loss_fn):
    opt = AdamW(learning_rate=LR, parameters=pmodel.parameters(), weight_decay=0.01)
    step = TrainStep(pmodel, opt, loss_fn(pmodel, PF))
    losses = [float(step(*map(torch.from_numpy, b))) for b in batches]
    return losses, {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}


def _assert_trajectory(got, want, start, moved=True):
    (losses, params), (losses_r, params_r) = got, want
    np.testing.assert_allclose(losses, losses_r, rtol=LOSS_RTOL)
    assert sorted(params) == sorted(params_r)
    for n in params_r:
        if n.endswith(ZERO_GRAD):
            # rounding noise on both sides, each step at most about lr
            for p in (params[n], params_r[n]):
                assert np.abs(p - start[n]).max() <= ZERO_GRAD_STEPS * len(losses) * LR, n
            continue
        if moved:
            assert np.abs(params[n] - start[n]).max() > 1e-4, n
        diff = np.abs(params[n] - params_r[n])
        assert diff.max() <= TRAJ_OUTLIER_ATOL, (n, diff.max())
        outliers = int((diff > TRAJ_PARAM_ATOL).sum())
        assert outliers <= max(2, TRAJ_OUTLIER_FRAC * diff.size), (n, outliers, diff.size)


def _classify(model, F):
    return lambda ids, y: F.cross_entropy(model(ids), y)


def test_train_step_trajectory_matches_reference():
    model, pmodel = _pair("seq", seed=5)
    model.train()
    pmodel.train()
    cfg = pmodel.ernie.config
    rng = np.random.RandomState(6)
    batches = [(_ids(cfg, seed=10 + i), rng.randint(0, 2, 4).astype(np.int64))
               for i in range(3)]
    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    want = _ref_steps(model, batches, _classify)
    got = _port_steps(pmodel, batches, _classify)
    assert len(got[1]) == 41
    _assert_trajectory(got, want, start)
    # EvalStep: the trained classifier's logits, without gradients
    ids = torch.from_numpy(batches[0][0])
    out = EvalStep(pmodel, lambda x: pmodel(x))(ids)
    assert len(out) == 1 and out[0].shape == (4, 2) and not out[0].requires_grad


def test_tied_table_takes_one_update_in_a_train_step():
    model, pmodel = _pair("mlm", seed=7)
    ids = _ids(pmodel.ernie.config, seed=8)

    def mlm_loss(m, F):
        return lambda x: F.cross_entropy(m(x).reshape([-1, 128]), x.reshape([-1]))

    start = {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}
    got = _port_steps(pmodel, [(ids,)], mlm_loss)
    want = _ref_steps(model, [(ids,)], mlm_loss)
    assert "cls._tied" not in got[1]
    _assert_trajectory(got, want, start, moved=False)
    assert pmodel.cls._tied is pmodel.ernie.embeddings.word_embeddings.weight


def test_o2_casts_the_mask_as_the_reference_does(monkeypatch):
    model, pmodel = _pair("seq", seed=9)
    ids = _ids(pmodel.ernie.config, seed=11)
    ramp.decorate(model, level="O2", dtype="bfloat16")
    pamp.decorate(pmodel, level="O2", dtype="bfloat16")
    seen = []
    sdpa = pattn.sdpa_ref
    monkeypatch.setattr(pattn, "sdpa_ref",
                        lambda q, k, v, mask, *a, **kw: seen.append(mask.dtype)
                        or sdpa(q, k, v, mask, *a, **kw))
    with ramp.auto_cast(level="O2", dtype="bfloat16"):
        want = model(paddle.to_tensor(ids))
    with pamp.auto_cast(level="O2", dtype="bfloat16"):
        got = pmodel(torch.from_numpy(ids))
    assert seen == [torch.bfloat16] * 2
    assert got.dtype == torch.bfloat16 and str(want.dtype).endswith("bfloat16")
    w = np.asarray(want.astype("float32").numpy())
    np.testing.assert_allclose(got.detach().float().numpy(), w, atol=O2_FRAC * np.abs(w).max())
    seen.clear()
    pmodel.float()
    pmodel(torch.from_numpy(ids))
    assert seen == [torch.float32] * 2


def test_seeded_construction_and_dropout_from_the_models_generator():
    cfg = port.ErnieConfig.tiny(hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.2)
    a = port.ErnieForSequenceClassification(cfg, device="cpu", seed=1)
    b = port.ErnieForSequenceClassification(cfg, device="cpu", seed=1)
    c = port.ErnieForSequenceClassification(cfg, device="cpu", seed=2)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.classifier.weight, c.classifier.weight)
    # every dropout of the model draws from its one generator
    gens = {id(m.generator) for m in a.modules() if hasattr(m, "generator")
            and isinstance(getattr(m, "generator"), torch.Generator)}
    assert gens == {id(a.generator)}
    ids = torch.from_numpy(_ids(cfg))
    a.train()
    state = a.generator.get_state()
    first = a(ids)
    a.generator.set_state(state)
    assert torch.equal(a(ids), first)
    assert not torch.equal(a(ids), first)
    a.eval()
    assert torch.equal(a(ids), a(ids))
