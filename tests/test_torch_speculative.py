"""PyTorch port: speculative decoding (draft decode and verify) against the
reference's.

Tolerances, stated per check: key bits (``fold_in``, ``spec_key``) and
every token and count are exact. One draft call's q and dense caches and
one verify call's pages and logits are f32 on both sides, computed in
another order, and agree within 1e-5 (q, caches, pages: values of order
1) and 1e-4 (logits). The engines serve the reference's tiny GQA Llama and
a smaller draft in f32 (weights carried through numpy) on the CPU, where
the port runs its three programs eagerly: greedy speculation gives the
non-speculative engine's tokens at every k, with a self-draft and a real
one; sampled speculation replays bit for bit and gives the reference's
sampled tokens at ``tests/test_serving_spec.py``'s seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.inference.serving import speculative as ref_spec
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch import random as R
from paddle_tpu_torch.inference import serving as port_serving
from paddle_tpu_torch.inference.serving import (
    SamplingParams, ServeConfig, ServingEngine, speculative as port_spec,
)
from paddle_tpu_torch.inference.serving.speculative import DraftConfig
from paddle_tpu_torch.models import llama as port_llama

VOCAB = 61
MAX_NEW = 6
KW = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=84, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)
DKW = dict(vocab_size=VOCAB, hidden_size=16, intermediate_size=44, num_hidden_layers=1,
           num_attention_heads=2, num_key_value_heads=2)
CFG = dict(num_lanes=4, block_size=4, max_seq_len=32, prefill_chunk=3)


def _port_model(model, kw):
    tree = jax.tree_util.tree_map(np.asarray, ref_llama.decode_weights(model))
    pm = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(**kw), device="cpu")
    return pm.load_decode_weights(port_llama.weights_from_numpy(tree, device="cpu"))


def _serve(serving, model, prompts, sampling_every=None, **cfg_kw):
    """The reference test's ``_serve``: every prompt at once, every
    ``sampling_every``-th request sampled with seed 100 + i."""
    cfg = dict(CFG, **cfg_kw)
    if sampling_every is not None:
        cfg.setdefault("sampling", True)
    kw = {} if serving is ref_serving else {"device": "cpu"}
    eng = serving.ServingEngine(model, serving.ServeConfig(**cfg), **kw)
    reqs = []
    for i, p in enumerate(prompts):
        sp = None
        if sampling_every is not None and i % sampling_every == 0:
            sp = serving.SamplingParams(temperature=0.9, top_k=7, top_p=0.9, seed=100 + i)
        reqs.append(eng.submit(p, MAX_NEW, sampling=sp))
    eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return eng, [tuple(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def zoo():
    """The reference test's target and draft (seeds 7 and 21), their port
    copies, its prompts, and the reference spec engine's greedy and
    sampled tokens with the real draft at k = 3."""
    paddle.seed(7)
    target = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(use_flash_attention=False,
                                                                   **KW))
    target.eval()
    paddle.seed(21)
    draft = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(use_flash_attention=False,
                                                                  **DKW))
    draft.eval()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (3, 7, 1, 5, 9, 2, 6, 4)]
    rdc = ref_spec.DraftConfig(model=draft, k=3)
    _, ref_greedy = _serve(ref_serving, target, prompts, draft=rdc)
    _, ref_sampled = _serve(ref_serving, target, prompts, sampling_every=2, draft=rdc)
    return dict(target=target, draft=draft, pt=_port_model(target, KW),
                pd=_port_model(draft, DKW), prompts=prompts, ref_greedy=ref_greedy,
                ref_sampled=ref_sampled)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -5])
def test_fold_in_gives_the_reference_bits(seed):
    datas = [0, 1, 2, 17, 255, 2 ** 31 - 1, 2 ** 32 - 1, 123456789]
    key = R.prng_key(seed)
    got = R.fold_in(key[None, :].expand(len(datas), 2), torch.tensor(datas))
    for d, g in zip(datas, got.tolist()):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(d)))
        assert g == want.tolist()
        assert R.fold_in(key, d).tolist() == want.tolist()


def test_spec_key_gives_the_reference_bits():
    base = np.asarray(jax.random.PRNGKey(42))
    for length, tag, j in [(0, 0, 0), (5, 1, 3), (1000, 2, 4), (77, 0, 1)]:
        want = np.asarray(ref_spec.spec_key(jnp.asarray(base), length, tag, j))
        got = port_spec.spec_key(torch.tensor(base.astype(np.int64)), length, tag, j)
        assert got.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------

def _accept_inputs(rng, b, k, V, greedy_hits):
    lg = rng.randn(b, k + 1, V).astype(np.float32) * 2.0
    q = rng.dirichlet(np.ones(V), size=(b, k)).astype(np.float32)
    q[0, 0, :] = 0.0                                   # q == 0: never accept
    q[0, 0, 1:] = 1.0 / (V - 1)
    toks = rng.randint(0, V, (b, k + 1)).astype(np.int32)
    for i in range(b):                                 # some proposals are the argmax
        for c in range(min(greedy_hits[i], k)):
            toks[i, c + 1] = int(np.argmax(lg[i, c]))
    toks[0, 1] = 0
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in range(10, 10 + b)])
    ln = rng.randint(0, 30, b).astype(np.int32)
    temp = np.array([0.9, 1.0, 0.5, 1.3][:b], np.float32)
    topk = np.array([7, 0, 3, 0][:b], np.int32)
    topp = np.array([0.9, 1.0, 1.0, 0.8][:b], np.float32)
    return lg, toks, q, keys, ln, temp, topk, topp


_REF_ACCEPT: dict = {}


def _ref_accept(k):
    """The reference's per-lane rule vmapped over lanes, compiled once."""
    if k not in _REF_ACCEPT:
        _REF_ACCEPT[k] = jax.jit(lambda *a: jax.vmap(
            ref_spec._accept_lane, in_axes=(0, 0, 0, 0, 0, None, 0, 0, 0, 0, None))(*a, k))
    return _REF_ACCEPT[k]


@pytest.mark.parametrize("n_draft", [1, 2, 4])
@pytest.mark.parametrize("sampled", [False, True])
def test_accept_matches_the_reference(n_draft, sampled):
    """The port's batched acceptance against the reference's per-lane rule
    (vmapped) on injected logits and q: tokens and counts exact."""
    k, V, b = 4, 11, 4
    rng = np.random.RandomState(n_draft + 10 * sampled)
    for trial in range(4):
        lg, toks, q, keys, ln, temp, topk, topp = _accept_inputs(
            rng, b, k, V, greedy_hits=[trial, k, 1, 2])
        do = np.array([sampled, sampled, not sampled, sampled])
        want_out, want_n = _ref_accept(k)(
            jnp.asarray(lg), jnp.asarray(toks), jnp.asarray(q), jnp.asarray(keys),
            jnp.asarray(ln), jnp.asarray(n_draft, jnp.int32), jnp.asarray(temp),
            jnp.asarray(topk), jnp.asarray(topp), jnp.asarray(do))
        t = torch.from_numpy
        out, n = port_spec.accept(
            t(lg), t(toks.astype(np.int64)), t(q), t(keys.astype(np.int64)),
            t(ln.astype(np.int64)), torch.tensor([n_draft]), t(temp), t(topk), t(topp),
            t(do), k)
        assert out.tolist() == np.asarray(want_out).tolist()
        assert n.tolist() == np.asarray(want_n).tolist()
        assert (n.numpy() <= n_draft + 1).all()


# ---------------------------------------------------------------------------
# one draft call, one verify call
# ---------------------------------------------------------------------------

def _lane_state(rng, lanes, V):
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in range(lanes)])
    temp = np.array([0.9, 1.0, 0.7], np.float32)[:lanes]
    topk = np.array([7, 0, 0], np.int32)[:lanes]
    topp = np.array([0.9, 1.0, 1.0], np.float32)[:lanes]
    do = np.array([True, False, True])[:lanes]
    return keys, temp, topk, topp, do


def test_one_draft_call_matches_the_reference(zoo):
    """Column j = 2 of a round: the input comes from toks[:, 2]; one lane
    write-protected. toks exact; q and the dense caches within 1e-5."""
    draft, pd = zoo["draft"], zoo["pd"]
    k, lanes, DL = 3, 3, 12
    rng = np.random.RandomState(0)
    dcfg = draft.config
    hd = dcfg.hidden_size // dcfg.num_attention_heads
    caches = [(rng.randn(lanes, DL, dcfg.num_key_value_heads, hd).astype(np.float32),
               rng.randn(lanes, DL, dcfg.num_key_value_heads, hd).astype(np.float32))
              for _ in range(dcfg.num_hidden_layers)]
    toks = rng.randint(1, VOCAB, (lanes, k + 1)).astype(np.int32)
    qbuf = np.zeros((lanes, k, VOCAB), np.float32)
    pos = np.array([4, 9, 6], np.int32)
    adv = np.array([True, False, True])
    keys, temp, topk, topp, do = _lane_state(rng, lanes, VOCAB)
    tok_push = np.array([5, 6, 7], np.int32)
    j, rs = 2, pos - 2
    dw = jax.tree_util.tree_map(jnp.asarray, ref_llama.decode_weights(draft))
    fn = jax.jit(ref_spec.build_draft_fn(dcfg, k, DL))
    w_toks, w_q, w_caches = fn(dw, jnp.asarray(tok_push), jnp.asarray(toks), jnp.asarray(qbuf),
                               [tuple(map(jnp.asarray, c)) for c in caches], jnp.asarray(pos),
                               jnp.asarray(adv), jnp.asarray(keys), jnp.asarray(rs),
                               jnp.asarray(j, jnp.int32), jnp.asarray(temp), jnp.asarray(topk),
                               jnp.asarray(topp), jnp.asarray(do))
    t = torch.from_numpy
    p_toks, p_q = t(toks.astype(np.int64)), t(qbuf.copy())
    p_caches = [(t(a.copy()), t(b.copy())) for a, b in caches]
    pfn = port_spec.build_draft_fn(pd.config, k, DL)
    with torch.no_grad():
        pfn(port_llama.decode_weights(pd), t(tok_push.astype(np.int64)), p_toks, p_q, p_caches,
            t(pos.astype(np.int64)), t(adv), t(keys.astype(np.int64)),
            t(rs.astype(np.int64)), torch.tensor([j]), t(temp), t(topk), t(topp), t(do))
    assert p_toks.tolist() == np.asarray(w_toks).tolist()
    np.testing.assert_allclose(p_q.numpy(), np.asarray(w_q), rtol=1e-5, atol=1e-5)
    for (a, b), (wa, wb) in zip(p_caches, w_caches):
        np.testing.assert_allclose(a.numpy(), np.asarray(wa), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(wb), rtol=1e-5, atol=1e-5)
    assert np.array_equal(p_caches[0][0][1].numpy(), caches[0][0][1])   # protected lane


def test_one_verify_call_matches_the_reference(zoo, monkeypatch):
    """k + 1 = 4 positions a lane over fragmented pages, one lane inactive
    and one past its reservation: tokens and counts exact; the pages within
    1e-5; the logits (read by swapping each side's acceptance for one that
    returns them) within 1e-4."""
    target, pt = zoo["target"], zoo["pt"]
    k, lanes, bs, MB = 3, 3, 4, 4
    mc = target.config
    hd = mc.hidden_size // mc.num_attention_heads
    rng = np.random.RandomState(1)
    nb = 1 + lanes * MB
    shape = (mc.num_hidden_layers, nb, bs, mc.num_key_value_heads, hd)
    pk, pv = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, nb))[:lanes * MB].reshape(lanes, MB).astype(np.int32)
    ln = np.array([5, 9, 14], np.int32)            # lane 2's columns run past 16 slots
    ac = np.array([True, False, True])
    toks = rng.randint(1, VOCAB, (lanes, k + 1)).astype(np.int32)
    qbuf = rng.dirichlet(np.ones(VOCAB), size=(lanes, k)).astype(np.float32)
    keys, temp, topk, topp, do = _lane_state(rng, lanes, VOCAB)
    w = jax.tree_util.tree_map(jnp.asarray, ref_llama.decode_weights(target))
    fn = jax.jit(ref_spec.build_verify_fn(mc, k, bs, MB))
    args = (jnp.asarray(toks), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
            jnp.asarray(ln), jnp.asarray(ac), jnp.asarray(keys), jnp.asarray(qbuf),
            jnp.asarray(2, jnp.int32), jnp.asarray(temp), jnp.asarray(topk),
            jnp.asarray(topp), jnp.asarray(do))
    w_out, w_n, w_pk, w_pv = fn(w, *args)
    t = torch.from_numpy
    p_pk, p_pv = t(pk.copy()), t(pv.copy())
    pargs = (t(toks.astype(np.int64)), p_pk, p_pv, t(bt), t(ln), t(ac),
             t(keys.astype(np.int64)), t(qbuf), torch.tensor([2]), t(temp), t(topk), t(topp),
             t(do))
    pfn = port_spec.build_verify_fn(pt.config, k, bs, MB)
    pw = port_llama.decode_weights(pt)
    with torch.no_grad():
        out, n = pfn(pw, *pargs)
    assert out.tolist() == np.asarray(w_out).tolist() and n.tolist() == np.asarray(w_n).tolist()
    for got, want in ((p_pk, w_pk), (p_pv, w_pv)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-5, atol=1e-5)
    # the logits: each side's acceptance swapped for one returning them
    monkeypatch.setattr(ref_spec, "_accept_lane",
                        lambda lg, *a: (lg.astype(jnp.float32), jnp.int32(0)))
    monkeypatch.setattr(port_spec, "accept", lambda lg, *a: (lg.float(), None))
    w_lg = np.asarray(jax.jit(ref_spec.build_verify_fn(mc, k, bs, MB))(w, *args)[0])
    pargs[1].copy_(t(pk))
    pargs[2].copy_(t(pv))
    with torch.no_grad():
        p_lg = pfn(pw, *pargs)[0].numpy()
    np.testing.assert_allclose(p_lg[ac], w_lg[ac], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base(zoo):
    """The port's non-speculative engine's greedy tokens."""
    return _serve(port_serving, zoo["pt"], zoo["prompts"])[1]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("which", ["self", "real"])
def test_greedy_speculation_gives_the_plain_engine_tokens(zoo, base, which, k):
    draft = zoo["pt"] if which == "self" else zoo["pd"]
    eng, spec = _serve(port_serving, zoo["pt"], zoo["prompts"], draft=DraftConfig(draft, k))
    assert spec == base
    st = eng.stats()
    assert st["captures"] == {"draft_decode": 0, "verify": 0, "prefill": 0}
    assert set(st["program_calls"]) == {"draft_decode", "verify", "prefill"}
    sp = st["spec"]
    assert sp["rounds"] > 0 and sp["proposed"] > 0 and sp["k"] == k
    if which == "self":
        # a self-draft proposes the target's argmax: every column a lane
        # uses is accepted. As in the reference, a round's count also takes
        # the columns past a lane's last token, whose positions lie past its
        # reservation (their K/V rows go to the trash block), so a few of
        # those may be rejected
        assert sp["accept_rate"] >= 0.9
    assert st["tokens"] == sum(len(t) for t in spec)


def test_greedy_speculation_equals_the_reference_spec_engine(zoo, base):
    _, spec = _serve(port_serving, zoo["pt"], zoo["prompts"], draft=DraftConfig(zoo["pd"], 3))
    assert spec == zoo["ref_greedy"] == base


def test_sampled_speculation_replays_and_equals_the_reference(zoo, base):
    dc = DraftConfig(zoo["pd"], 3)
    _, a = _serve(port_serving, zoo["pt"], zoo["prompts"], sampling_every=2, draft=dc)
    _, b = _serve(port_serving, zoo["pt"], zoo["prompts"], sampling_every=2, draft=dc)
    assert a == b == zoo["ref_sampled"]
    assert a != base                        # the sampled half does sample
    assert [a[i] for i in range(1, 8, 2)] == [base[i] for i in range(1, 8, 2)]


def test_prefix_cache_with_speculation_hit_equals_cold(zoo):
    """The reference's ``test_speculative_hit_matches_cold``: a cold miss
    and a hit through a speculative engine give the plain cold tokens."""
    rng = np.random.RandomState(5)
    pre = rng.randint(1, VOCAB, 8).tolist()
    prompts = [pre + rng.randint(1, VOCAB, 2).tolist(), list(pre)]
    cfg = dict(num_lanes=2, block_size=4, max_seq_len=16, prefill_chunk=4)
    plain = ServingEngine(zoo["pt"], ServeConfig(**cfg), device="cpu")
    cold = []
    for p in prompts:
        r = plain.submit(p, 5)
        plain.run()
        cold.append(r.generated)
    eng = ServingEngine(zoo["pt"], ServeConfig(prefix_cache=True,
                                              draft=DraftConfig(zoo["pd"], 2), **cfg),
                        device="cpu")
    got = []
    for p in prompts + prompts:
        r = eng.submit(p, 5)
        eng.run()
        got.append(r.generated)
    assert got == cold + cold
    st = eng.stats()["prefix_cache"]
    assert st["hits"] == 3 and st["forks"] >= 1
    eng._kv.audit(eng._prefix.cached_blocks)


def test_validation(zoo):
    with pytest.raises(ValueError, match="DraftConfig"):
        ServeConfig(draft=object())
    with pytest.raises(ValueError, match="k must be >= 1"):
        DraftConfig(zoo["pd"], 0)
    with pytest.raises(ValueError, match="nan_guard"):
        ServeConfig(nan_guard=True, draft=DraftConfig(zoo["pd"], 2))
    other = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(**dict(DKW, vocab_size=50)),
                                        device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        ServingEngine(zoo["pt"], ServeConfig(draft=DraftConfig(other, 2), **CFG), device="cpu")
    eng = ServingEngine(zoo["pt"], ServeConfig(draft=DraftConfig(zoo["pd"], 2), **CFG),
                        device="cpu")
    req = eng.submit([3, 4], 4, sampling=SamplingParams(temperature=0.8, seed=3))
    eng.run()
    assert req.status == "done" and len(req.generated) == 4
