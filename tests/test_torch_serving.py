"""PyTorch port: the continuous-batching serving engine against the
reference ``ServingEngine``.

Both engines serve one tiny GQA model (the reference's weights, carried
to the port through numpy) on the CPU, in f32, over one seeded staggered
trace: more requests than lanes, prompts whose prefill ends in a partial
chunk, admissions between steps and a cancel mid-flight. Greedy tokens
must be IDENTICAL for ``weight_dtype="bf16"`` (no quantization) and
``"int8"``. Plus the allocator, cancel, submit validation (a non-greedy
request needs a sampling engine), the fields that later slices serve, and
the default device.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch.inference.serving import (
    PagedKVCache, Request, SamplingParams, ServeConfig, ServingEngine,
)
from paddle_tpu_torch.models import llama as port_llama

VOCAB = 61
CFG = dict(num_lanes=3, block_size=4, max_seq_len=16, prefill_chunk=3)


@pytest.fixture(scope="module")
def zoo():
    paddle.seed(7)
    cfg = ref_llama.LlamaConfig.tiny(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=84,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        use_flash_attention=False)
    model = ref_llama.LlamaForCausalLM(cfg)
    model.eval()
    tree = jax.tree_util.tree_map(np.asarray, ref_llama.decode_weights(model))
    pmodel = port_llama.LlamaForCausalLM(
        port_llama.LlamaConfig.tiny(
            vocab_size=VOCAB, hidden_size=32, intermediate_size=84,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
        device="cpu")
    pmodel.load_decode_weights(port_llama.weights_from_numpy(tree, device="cpu"))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB, n).tolist() for n in (5, 1, 7, 4, 8, 2, 6, 3)]
    return model, pmodel, prompts


def _drive(engine, prompts):
    """The staggered trace: two requests, two steps, three more, three
    steps, cancel the second one mid-flight, three more, run to the end."""
    def submit(i):
        return engine.submit(prompts[i], 14 - len(prompts[i]))

    reqs = [submit(0), submit(1)]
    for _ in range(2):
        engine.step()
    reqs += [submit(i) for i in (2, 3, 4)]
    for _ in range(3):
        engine.step()
    engine.cancel(reqs[1])
    reqs += [submit(i) for i in (5, 6, 7)]
    engine.run(max_steps=500)
    return [(r.status, list(r.generated)) for r in reqs]


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_same_greedy_tokens_as_reference_engine(zoo, weight_dtype):
    model, pmodel, prompts = zoo
    want = _drive(ref_serving.ServingEngine(
        model, ref_serving.ServeConfig(weight_dtype=weight_dtype, **CFG)), prompts)
    got = _drive(ServingEngine(pmodel, ServeConfig(weight_dtype=weight_dtype, **CFG),
                               device="cpu"), prompts)
    assert [s for s, _ in want].count("done") == 7
    assert got == want


def test_matches_dense_generator_oracle(zoo):
    _, pmodel, prompts = zoo
    eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
    reqs = [eng.submit(p, 14 - len(p)) for p in prompts]
    eng.run()
    ids = np.zeros((len(prompts), 8), np.int32)
    plen = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    out, glen = port_llama.LlamaGreedyGenerator(pmodel, max_len=14)(ids, plen)
    for i, r in enumerate(reqs):
        assert r.tokens == out[i, :glen[i]].tolist()
    assert eng.stats()["tokens"] == sum(len(r.generated) for r in reqs)


class TestPagedKVCache:
    def _cache(self, num_blocks=10):
        return PagedKVCache(2, 2, 8, num_blocks=num_blocks, block_size=4,
                            num_lanes=3, max_blocks_per_lane=4, device="cpu")

    def test_block_zero_reserved(self):
        kv = self._cache()
        seen = []
        for lane in range(3):
            kv.allocate_lane(lane, 10)      # 3 blocks each
            seen += kv.lane_blocks(lane)
        assert 0 not in seen
        assert len(set(seen)) == 9 == len(seen)
        assert kv.free_blocks == 0 and not kv.can_admit(1)

    def test_lifo_reuse_fragments_tables(self):
        kv = self._cache()
        for lane in range(3):
            kv.allocate_lane(lane, 10)
        old = kv.lane_blocks(1)
        kv.free_lane(1)
        assert kv.free_blocks == 3
        assert kv.block_table[1].tolist() == [0, 0, 0, 0]
        kv.allocate_lane(1, 12)
        # the last block freed is the first handed out again
        assert kv.lane_blocks(1) == old[::-1]
        assert kv.block_table[1, :3].tolist() == old[::-1]

    def test_capacity_and_errors(self):
        kv = self._cache(num_blocks=32)
        assert kv.lane_capacity == 16
        assert not kv.can_admit(17) and kv.can_admit(16)
        kv.allocate_lane(0, 4)
        with pytest.raises(RuntimeError):
            kv.allocate_lane(0, 4)
        with pytest.raises(RuntimeError):
            kv.allocate_lane(1, 17)
        with pytest.raises(ValueError):
            PagedKVCache(2, 2, 8, num_blocks=1, block_size=4, num_lanes=1,
                         max_blocks_per_lane=1, device="cpu")

    def test_device_tables_copy_with_pinned_dtypes(self):
        kv = self._cache()
        kv.allocate_lane(2, 5)
        bt, ln, ac = kv.device_tables()
        assert (bt.dtype, ln.dtype, ac.dtype) == (torch.int32, torch.int32, torch.bool)
        assert tuple(bt.shape) == (3, 4) and tuple(kv.pages_k.shape) == (2, 10, 4, 2, 8)
        kv.lengths[2] = 3
        assert ln[2].item() == 0


class TestLifecycle:
    def test_cancel_waiting_request_never_takes_a_lane(self, zoo):
        _, pmodel, prompts = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        live = [eng.submit(prompts[i], 4) for i in (0, 1, 2)]
        eng.step()
        waiter = eng.submit(prompts[3], 4)
        assert waiter.status == "waiting"
        eng.cancel(waiter)
        assert waiter.status == "cancelled" and waiter.lane is None
        eng.run()
        assert waiter.generated == [] and all(r.status == "done" for r in live)

    def test_cancel_running_frees_its_blocks(self, zoo):
        _, pmodel, prompts = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        free0 = eng.stats()["free_blocks"]
        req = eng.submit(prompts[4], 6)
        for _ in range(4):
            eng.step()
        assert req.status == "running" and eng.stats()["free_blocks"] < free0
        eng.cancel(req)
        assert req.status == "cancelled" and req.lane is None
        assert eng.stats()["free_blocks"] == free0 and not eng.pending()

    def test_drain_returns_waiting_and_finishes_in_flight(self, zoo):
        _, pmodel, prompts = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        reqs = [eng.submit(p, 3) for p in prompts[:5]]
        eng.step()
        stranded = eng.drain()
        assert stranded == reqs[3:]
        assert all(r.status == "waiting" for r in stranded)
        assert all(r.status == "done" for r in reqs[:3])

    def test_enqueue_keeps_identity(self, zoo):
        _, pmodel, prompts = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        req = eng.enqueue(Request(id=41, prompt=prompts[0], max_new_tokens=3,
                                  priority=0))
        assert eng.submit(prompts[1], 3).id == 42
        eng.run()
        assert req.status == "done" and len(req.generated) == 3

    def test_eos_retires_lane_early(self, zoo):
        _, pmodel, prompts = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        first = eng.submit(prompts[0], 5)
        eng.run()
        eos = first.generated[0]
        eng = ServingEngine(pmodel, ServeConfig(eos_token_id=eos, **CFG), device="cpu")
        req = eng.submit(prompts[0], 5)
        eng.run()
        assert req.status == "done" and req.generated == [eos]


class TestValidation:
    def test_submit_validation(self, zoo):
        _, pmodel, _ = zoo
        eng = ServingEngine(pmodel, ServeConfig(**CFG), device="cpu")
        with pytest.raises(ValueError):
            eng.submit(list(range(1, 9)), 100)       # 8 + 100 > 16 slots
        with pytest.raises(ValueError):
            eng.submit([])
        with pytest.raises(ValueError):
            eng.submit([1, 2], 0)
        with pytest.raises(ValueError, match="sampling=True"):
            eng.submit([1, 2], 3, sampling=SamplingParams(temperature=0.8))
        greedy = eng.submit([1, 2], 3, sampling=SamplingParams(do_sample=False))
        eng.run()
        assert greedy.status == "done"

    def test_config_xor_overrides(self, zoo):
        _, pmodel, _ = zoo
        with pytest.raises(ValueError):
            ServingEngine(pmodel, ServeConfig(), device="cpu", num_lanes=2)
        with pytest.raises(ValueError, match="weight_dtype"):
            ServeConfig(weight_dtype="int4")

    @pytest.mark.parametrize("field, value, slice_name", [
        ("lane_shards", 2, "sharding"), ("weight_shards", 2, "sharding"),
        ("draft", object(), "speculative"), ("prefix_cache", True, "prefix-cache"),
        ("host_kv_blocks", 4, "prefix-cache"),
    ])
    def test_later_slice_fields_raise(self, field, value, slice_name):
        with pytest.raises(NotImplementedError, match=slice_name):
            ServeConfig(**{field: value})

    def test_default_device_needs_cuda(self, zoo):
        _, pmodel, _ = zoo
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(pmodel, ServeConfig(**CFG))
        with pytest.raises(RuntimeError, match="CUDA"):
            port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny())
