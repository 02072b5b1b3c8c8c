"""PyTorch port: the serving engine's two programs, its sampling head and
its NaN guard, on the CPU, against the reference engine.

Both engines serve one tiny GQA Llama (the reference's weights, carried to
the port through numpy) in f32. On the CPU the port runs its decode and
prefill programs eagerly (on the card each is one CUDA graph; the card
tests hold the graphs against this eager step bit for bit):

- a sampling engine (``ServeConfig(sampling=True)``) serving mixed greedy
  and sampled requests, with admissions between steps and a cancel, gives
  the reference's tokens exactly. The draw is the reference's threefry
  draw bit for bit, except that the Gumbel noise may differ by an f32 ulp
  (tests/test_torch_sampling.py); a token decided by two noisy logits
  within an ulp could then differ. No token of this trace is: equality is
  asserted, and where it would fail the filtered distributions of that
  step would be the thing to compare;
- replay: two runs are identical, and each request's stream does not
  depend on the lane count (its key is a function of its seed and its
  token index); ``top_k=1`` and greedy requests in a sampling engine give
  the greedy engine's tokens;
- the NaN guard (reference ``tests/test_numerics.py:505-533``): one lane's
  K pages poisoned with NaN mid-run, that request fails with "nonfinite
  logits" and the survivors' streams equal those of a clean guarded run
  (and the reference's, poisoned the same way);
- the validation rules (reference ``test_serving_sampling.py:129-137`` and
  ``engine.py:235-237``), and the program bookkeeping: captures and calls
  counted per program, a replay adding nothing to a wrapper's launch count
  (held with stand-ins for the CUDA graph API).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch.inference.serving import (
    SamplingParams, ServeConfig, ServingEngine, engine as port_engine,
)
from paddle_tpu_torch.inference.serving.kv_cache import Staged
from paddle_tpu_torch.models import llama as port_llama

VOCAB = 61
MAX_NEW = 5
CFG = dict(num_lanes=4, block_size=4, max_seq_len=16, prefill_chunk=3)


@pytest.fixture(scope="module")
def zoo():
    paddle.seed(7)
    kw = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=84, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2)
    model = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(use_flash_attention=False,
                                                                  **kw))
    model.eval()
    tree = jax.tree_util.tree_map(np.asarray, ref_llama.decode_weights(model))
    pmodel = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(**kw), device="cpu")
    pmodel.load_decode_weights(port_llama.weights_from_numpy(tree, device="cpu"))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (3, 7, 1, 5, 9, 2, 6, 4)]
    return model, pmodel, prompts


def _params(i):
    """Every other request samples, with its own strategy and seed."""
    if i % 2:
        return None
    return SamplingParams(temperature=0.9 - 0.1 * (i % 3), top_k=(0, 7, 3)[i % 3],
                          top_p=(0.9, 1.0, 0.6)[i % 3], seed=100 + i)


def _drive(serving, model, prompts, *, staggered=True, lanes=4, **kw):
    """Mixed greedy and sampled requests; with ``staggered`` three come
    first, three more after two steps, the second is cancelled after three
    more steps, then the rest."""
    cfg = serving.ServeConfig(sampling=True, **{**CFG, "num_lanes": lanes})
    eng = serving.ServingEngine(model, cfg, **kw)

    def submit(i):
        sp = _params(i)
        if sp is not None:
            sp = serving.SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                        top_p=sp.top_p, seed=sp.seed)
        return eng.submit(prompts[i], MAX_NEW, sampling=sp)

    if not staggered:
        reqs = [submit(i) for i in range(len(prompts))]
        eng.run(max_steps=500)
        return [(r.status, tuple(r.generated)) for r in reqs]
    reqs = [submit(i) for i in (0, 1, 2)]
    for _ in range(2):
        eng.step()
    reqs += [submit(i) for i in (3, 4, 5)]
    for _ in range(3):
        eng.step()
    eng.cancel(reqs[1])
    reqs += [submit(i) for i in (6, 7)]
    eng.run(max_steps=500)
    return [(r.status, tuple(r.generated)) for r in reqs]


def test_sampling_engine_matches_the_reference(zoo):
    model, pmodel, prompts = zoo
    want = _drive(ref_serving, model, prompts)
    got = _drive(port_engine, pmodel, prompts, device="cpu")
    assert [s for s, _ in want].count("done") == 7
    assert got == want


def test_replay_is_deterministic_and_independent_of_the_schedule(zoo):
    _, pmodel, prompts = zoo
    first = _drive(port_engine, pmodel, prompts, staggered=False, device="cpu")
    again = _drive(port_engine, pmodel, prompts, staggered=False, device="cpu")
    fewer_lanes = _drive(port_engine, pmodel, prompts, staggered=False, lanes=2,
                         device="cpu")
    assert first == again == fewer_lanes
    assert all(s == "done" for s, _ in first)


def test_greedy_and_top_k_one_equal_the_greedy_engine(zoo):
    _, pmodel, prompts = zoo
    plain = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
    refs = [plain.submit(p, MAX_NEW) for p in prompts]
    plain.run(max_steps=500)
    eng = ServingEngine(pmodel, ServeConfig(sampling=True, **CFG), device="cpu")
    reqs = [eng.submit(p, MAX_NEW, sampling=None if i % 2 else
                       SamplingParams(top_k=1, temperature=0.5, seed=i))
            for i, p in enumerate(prompts)]
    eng.run(max_steps=500)
    assert [r.generated for r in reqs] == [r.generated for r in refs]


def _guarded(serving, model, prompts, poison, **kw):
    """The reference's guard test: three requests on three lanes, lane 1's
    K pages set to NaN before the fourth step."""
    eng = serving.ServingEngine(model, serving.ServeConfig(
        num_lanes=3, block_size=4, max_seq_len=16, prefill_chunk=3, nan_guard=True), **kw)
    reqs = [eng.submit(p, 8) for p in prompts]
    for i in range(4):
        if i == 3 and poison:
            blocks = eng._kv.lane_blocks(reqs[1].lane)
            if isinstance(eng._kv.pages_k, torch.Tensor):
                eng._kv.pages_k[:, blocks] = float("nan")
            else:
                pk = np.array(eng._kv.pages_k)
                pk[:, blocks] = np.nan
                eng._kv.pages_k = jnp.asarray(pk)
        eng.step()
    eng.run()
    return reqs


def test_nan_guard_evicts_only_the_poisoned_lane(zoo):
    model, pmodel, prompts = zoo
    three = prompts[:3]
    reqs = _guarded(port_engine, pmodel, three, poison=True, device="cpu")
    assert reqs[1].status == "failed" and reqs[1].error == "nonfinite logits"
    clean = _guarded(port_engine, pmodel, three, poison=False, device="cpu")
    assert all(r.status == "done" for r in clean)
    for i in (0, 2):
        assert reqs[i].status == "done" and reqs[i].generated == clean[i].generated
    ref = _guarded(ref_serving, model, three, poison=True)
    assert [(r.status, r.generated) for r in reqs] == [(r.status, r.generated) for r in ref]


def test_validation_rules(zoo):
    _, pmodel, prompts = zoo
    eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="sampling=True"):
        eng.submit(prompts[0], MAX_NEW, sampling=SamplingParams(temperature=0.7, seed=1))
    req = eng.submit(prompts[0], 2, sampling=SamplingParams(do_sample=False))
    eng.run(max_steps=200)
    assert req.status == "done"
    with pytest.raises(ValueError, match="nan_guard"):
        ServeConfig(nan_guard=True, draft=object())
    assert ServeConfig().nan_guard is False and ServeConfig().sampling is False


def test_cpu_runs_the_programs_eagerly(zoo):
    _, pmodel, prompts = zoo
    eng = ServingEngine(pmodel, ServeConfig(sampling=True, nan_guard=True, **CFG),
                        device="cpu")
    reqs = [eng.submit(p, MAX_NEW) for p in prompts[:3]]
    eng.run()
    assert all(r.status == "done" for r in reqs)
    assert eng.stats()["captures"] == {"decode": 0, "prefill": 0}


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_program_counts_captures_and_calls(monkeypatch):
    """A graphed program runs its function once eagerly (the warm-up),
    captures it once and then only replays. A wrapper counts where it
    calls the launch, so the warm-up and the capture add to its count and
    a replay adds nothing; the program counts its calls."""
    from paddle_tpu_torch.ops import paged_attention as pa

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: torch.no_grad())
    monkeypatch.setattr(pa.paged_decode_attention, "launches", 0)
    calls = []

    class Owner:                   # a program holds its engine's method weakly
        def fn(self):
            calls.append(1)
            pa.paged_decode_attention.launches += 3

    owner = Owner()
    fn = owner.fn
    prog = port_engine._Program("decode", fn, graphed=True)
    prog()
    assert (len(calls), prog.captures, pa.paged_decode_attention.launches) == (2, 1, 6)
    for _ in range(4):
        prog()
    assert (len(calls), prog.captures, pa.paged_decode_attention.launches) == (2, 1, 6)
    assert (prog._graph.replays, prog.calls) == (4, 5)
    eager = port_engine._Program("prefill", fn, graphed=False)
    eager()
    eager()
    assert (len(calls), eager.captures, eager.calls) == (4, 0, 2)


def test_an_engine_is_freed_with_its_last_reference(zoo):
    """No reference cycle through the programs: the engine (its page pool,
    and on the card its graphs' memory) goes with its last reference."""
    import weakref

    _, pmodel, prompts = zoo
    eng = ServingEngine(pmodel, ServeConfig(sampling=True, **CFG), device="cpu")
    eng.submit(prompts[0], 2)
    eng.run()
    gone = weakref.ref(eng)
    del eng
    assert gone() is None


def test_staged_buffers_copy_in_order():
    host = np.arange(6, dtype=np.int32).reshape(2, 3)
    flags = np.zeros(2, np.bool_)
    st = Staged(torch.device("cpu"), t=host, f=flags)
    dev_t = st.dev["t"]
    st.push()
    host[0, 0] = 40
    flags[1] = True
    assert dev_t[0, 0].item() == 0 and st.dev["t"] is dev_t
    st.push("f")
    assert dev_t[0, 0].item() == 0 and st.dev["f"].tolist() == [False, True]
    st.push()
    assert dev_t[0, 0].item() == 40 and st.dev["f"].dtype == torch.bool
