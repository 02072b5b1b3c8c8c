"""PyTorch port: the prefix cache (copy-on-write paged KV, host tier)
against the reference's.

Tolerances: every comparison here is exact. The allocator and the cache
are host bookkeeping, so refcounts, free lists, tables, plans, forks and
evictions must equal the reference's after the same operations; chain
keys must be byte-equal. The engines serve one tiny GQA Llama in f32 (the
reference's weights carried through numpy) on the CPU, where the port
runs its programs eagerly: a cache hit, a fork, an evict-restore and a
drop must give the port's cache-cold tokens bit for bit, and the
reference engine's tokens.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.inference.serving import kv_cache as ref_kv
from paddle_tpu.inference.serving import prefix_cache as ref_pc
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch.inference.serving import (
    PagedKVCache, PrefixCache, ServeConfig, ServingEngine, prefix_cache as port_pc,
)
from paddle_tpu_torch.models import llama as port_llama

VOCAB = 61
BS = 4
MAX_NEW = 5
KW = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=84, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)
SMALL = dict(num_lanes=2, block_size=BS, max_seq_len=16, prefill_chunk=BS)
PRESSURE = dict(num_lanes=2, block_size=BS, max_seq_len=28, num_blocks=8, prefill_chunk=BS)


@pytest.fixture(scope="module")
def zoo():
    """The reference's tiny model and the port's with its weights; prompts
    sharing an 8-token (2-block) prefix ("f" is the prefix alone: a COW
    fork), and the pressure trace's shared and big prompts."""
    paddle.seed(7)
    model = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(use_flash_attention=False,
                                                                  **KW))
    model.eval()
    tree = jax.tree_util.tree_map(np.asarray, ref_llama.decode_weights(model))
    pmodel = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(**KW), device="cpu")
    pmodel.load_decode_weights(port_llama.weights_from_numpy(tree, device="cpu"))
    rng = np.random.RandomState(5)
    pre = rng.randint(1, VOCAB, 2 * BS).tolist()
    prompts = {"a": pre + rng.randint(1, VOCAB, 2).tolist(),
               "b": pre + rng.randint(1, VOCAB, 1).tolist(),
               "f": list(pre),
               "c": rng.randint(1, VOCAB, 7).tolist()}
    rng = np.random.RandomState(9)
    shared = rng.randint(1, VOCAB, 18).tolist()
    big = rng.randint(1, VOCAB, 24).tolist()
    return model, pmodel, prompts, shared, big


def _one(eng, prompt, max_new=MAX_NEW):
    r = eng.submit(prompt, max_new)
    eng.run(max_steps=300)
    assert r.status == "done"
    return tuple(r.generated)


def _port(pmodel, **cfg):
    return ServingEngine(pmodel, ServeConfig(**cfg), device="cpu")


def _audit(eng):
    eng._kv.audit(eng._prefix.cached_blocks)


# ---------------------------------------------------------------------------
# the allocator: one operation sequence on both
# ---------------------------------------------------------------------------

def _caches(num_blocks=10, lanes=3):
    port = PagedKVCache(2, 2, 8, num_blocks=num_blocks, block_size=BS, num_lanes=lanes,
                        max_blocks_per_lane=4, device="cpu")
    ref = ref_kv.PagedKVCache(2, 2, 8, num_blocks=num_blocks, block_size=BS,
                              num_lanes=lanes, max_blocks_per_lane=4)
    return port, ref


def _state(kv):
    return (kv._ref.tolist(), [list(f) for f in kv._free], kv.block_table.tolist(),
            [kv.lane_blocks(i) for i in range(kv.num_lanes)], kv.shared_blocks,
            kv.free_blocks)


def _sequence(kv, log):
    """Shared prefixes, owned rows, a COW swap, credit probes and frees."""
    kv.allocate_lane(0, 10)
    shared = kv.lane_blocks(0)[:2]
    kv.allocate_lane(1, 10, prefix=shared, prefix_owned=(False, False))
    log.append(("refs", [kv.refcount(0, b) for b in shared]))
    log.append(("admit", [kv.can_admit(n, shared=c) for n in (4, 8, 12, 16, 17)
                          for c in (0, 1, 2, 5)]))
    nb = kv.take_block(0)
    log.append(("swap", kv.swap_block(1, 0, nb), kv.refcount(0, nb)))
    owned = kv.take_block(0)
    kv.allocate_lane(2, 6, prefix=[owned], prefix_owned=(True,))
    log.append(("owned", kv.refcount(0, owned), kv.can_admit(4), kv.can_admit(4, shared=1)))
    kv.audit()
    kv.free_lane(0)
    log.append(("after-free-0", _state(kv)))
    kv.free_lane(2)
    kv.free_lane(1)
    kv.audit()
    with pytest.raises(RuntimeError):
        kv.allocate_lane(0, 4, prefix=[1, 2], prefix_owned=(False, False))
    kv.allocate_lane(0, 16)


def test_allocator_refcounts_credit_and_swap_match_the_reference():
    port, ref = _caches()
    got, want = [], []
    _sequence(port, got)
    _sequence(ref, want)
    assert got == want
    assert _state(port) == _state(ref)
    assert port.shared_blocks == 0 and port.free_blocks == 5


def test_audit_flags_drift_and_strands_as_the_reference():
    for kv in _caches():
        kv.allocate_lane(0, 10)
        kv._ref[0, kv.lane_blocks(0)[0]] += 1
        with pytest.raises(AssertionError, match="refcount drift"):
            kv.audit()
        kv._ref[0, kv.lane_blocks(0)[0]] -= 1
        b = kv._free[0].pop()
        with pytest.raises(AssertionError, match="stranded"):
            kv.audit()
        kv.audit(cached_blocks=lambda s: {b})


def test_no_hooks_keep_the_unshared_allocator():
    port, _ = _caches()
    port.allocate_lane(0, 10)
    blocks = port.lane_blocks(0)
    port.free_lane(0)
    port.allocate_lane(1, 12)
    assert port.lane_blocks(1) == blocks[::-1]
    assert port.shared_blocks == 0 and set(np.unique(port._ref)) <= {0, 1}
    assert port.num_shards == 1 and port.shard_of(2) == 0


@pytest.mark.parametrize("parent_len, sizes", [(0, (1, 4, 16)), (8, (4, 7)), (8, (0,))])
def test_chain_keys_are_the_reference_bytes(parent_len, sizes):
    rng = np.random.RandomState(parent_len + len(sizes))
    parent = bytes(rng.randint(0, 256, parent_len).tolist())
    for n in sizes:
        chunk = tuple(int(t) for t in rng.randint(-3, 2 ** 31 - 1, n))
        assert port_pc._chain_key(parent, chunk) == ref_pc._chain_key(parent, chunk)
        assert len(port_pc._chain_key(parent, chunk)) == 8


# ---------------------------------------------------------------------------
# the cache over a bare pool, fake device callbacks
# ---------------------------------------------------------------------------

def _pair(mod_kv, mod_pc, num_blocks=10, host_blocks=0, **kw):
    if mod_kv is ref_kv:
        kv = mod_kv.PagedKVCache(2, 2, 8, num_blocks=num_blocks, block_size=BS, num_lanes=2,
                                 max_blocks_per_lane=8)
    else:
        kv = mod_kv(2, 2, 8, num_blocks=num_blocks, block_size=BS, num_lanes=2,
                    max_blocks_per_lane=8, device="cpu")
    pc = mod_pc(kv, prefill_chunk=kw.get("chunk", BS), host_blocks=host_blocks)
    log = []
    pc.copy = lambda s, src, dst: log.append(("copy", s, src, dst))
    if host_blocks:
        pc.offload = lambda s, b: log.append(("offload", s, b)) or ("pay", b)
        pc.restore = lambda s, pay, b: log.append(("restore", s, pay, b))
    return kv, pc, log


def _plan(plan):
    if plan is None:
        return None
    return (plan.tokens, plan.fork, plan.credit, plan.idle, plan.shard,
            [e.key for e in plan.entries])


def _cycle(kv, pc, lane, prompt, total):
    kv.allocate_lane(lane, total)
    blocks = kv.lane_blocks(lane)
    pc.insert(prompt, 0, blocks)
    kv.free_lane(lane)
    return blocks


def _unit_script(kv, pc, prompts, out):
    """Insert, match, take with a fork, a collision probe, pool pressure
    (leaf-first LRU eviction to the host or a drop), a restore."""
    a, f, c = prompts["a"], prompts["f"], prompts["c"]
    out.append(("blocks", _cycle(kv, pc, 0, a, 10)))
    out.append(("stats", {k: pc.stats()[k] for k in
                          ("entries", "device_blocks", "idle_blocks", "host_blocks")}))
    out.append(("miss", _plan(pc.match(c, 12, 0))))
    swapped = a[:BS] + c[:BS]
    out.append(("partial", _plan(pc.match(swapped, len(swapped) + 2, 0))))
    plan = pc.match(a, 10, 0)
    out.append(("hit", _plan(plan), pc.admissible(plan, 10)))
    prefix, owned = pc.take(plan)
    kv.allocate_lane(1, 10, prefix=prefix, prefix_owned=owned)
    out.append(("take", prefix, owned, [kv.refcount(0, b) for b in prefix]))
    kv.audit(pc.cached_blocks)
    kv.free_lane(1)
    plan = pc.match(f, 8 + MAX_NEW, 0)
    out.append(("fork", _plan(plan)))
    prefix, owned = pc.take(plan)
    kv.allocate_lane(0, 8 + MAX_NEW, prefix=prefix, prefix_owned=owned)
    out.append(("forked", prefix, owned, sorted(pc.cached_blocks(0)), pc.stats()["idle_blocks"]))
    kv.audit(pc.cached_blocks)
    kv.free_lane(0)
    # pressure: a request as large as the pool evicts every cached block
    kv.allocate_lane(0, BS * min(kv.num_blocks - 1, kv.max_blocks_per_lane))
    out.append(("pressure", kv.lane_blocks(0), {k: pc.stats()[k] for k in
                ("entries", "device_blocks", "idle_blocks", "host_blocks")}))
    kv.audit(pc.cached_blocks)
    kv.free_lane(0)
    plan = pc.match(a, 10, 0)
    out.append(("after", _plan(plan)))
    if plan is not None:
        prefix, owned = pc.take(plan)
        kv.allocate_lane(1, 10, prefix=prefix, prefix_owned=owned)
        out.append(("restored", prefix, owned, pc.stats()["host_blocks"],
                    pc.stats()["device_blocks"]))
        kv.audit(pc.cached_blocks)
        kv.free_lane(1)
    # a forged collision: the digests say hit, the chunks say no
    saved = {k: e.chunk for k, e in pc._entries[0].items()}
    for e in pc._entries[0].values():
        e.chunk = tuple(reversed(e.chunk))
    out.append(("collision", _plan(pc.match(a, 10, 0))))
    for k, e in pc._entries[0].items():
        e.chunk = saved[k]
    # a matched chain dropped wholesale, its subtree with it
    plan = pc.match(prompts["b"], 10, 0)
    if plan is not None:
        pc.invalidate(plan)
    out.append(("invalidated", _plan(pc.match(a, 10, 0)), pc.stats()["entries"]))
    kv.audit(pc.cached_blocks)
    out.append(("free", [list(x) for x in kv._free], kv._ref.tolist()))


@pytest.mark.parametrize("num_blocks, host_blocks", [(10, 0), (6, 0), (6, 4), (6, 1)])
def test_cache_unit_matches_the_reference(zoo, num_blocks, host_blocks):
    """The same plans, takes, forks, evictions (leaf-first LRU; to the
    host within its budget, else dropped) and restores as the reference's
    PrefixCache, and the same device callbacks in the same order."""
    prompts = zoo[2]
    got, want = [], []
    kv, pc, log = _pair(PagedKVCache, PrefixCache, num_blocks, host_blocks)
    rkv, rpc, rlog = _pair(ref_kv, ref_pc.PrefixCache, num_blocks, host_blocks)
    _unit_script(kv, pc, prompts, got)
    _unit_script(rkv, rpc, prompts, want)
    assert got == want
    assert log == rlog
    st = pc.stats()
    assert st["forks"] >= 1 and st["inserts"] >= 2
    if num_blocks == 6:
        evicted = st["evictions_host"] + st["evictions_drop"]
        assert evicted >= 2
        assert (st["evictions_host"] >= 1) == (host_blocks > 0)
        assert (st["restores"] >= 2) == (host_blocks >= 2)


def test_hit_length_rounds_to_the_prefill_grid(zoo):
    """A 3-token prefill chunk: a 2-block (8-token) match leaves a tail
    off the chunk grid, so the hit rounds down, as the reference's."""
    prompts = zoo[2]
    for chunk in (3, 2, 8):
        plans = []
        for mod_kv, mod_pc in ((PagedKVCache, PrefixCache), (ref_kv, ref_pc.PrefixCache)):
            kv, pc, _ = _pair(mod_kv, mod_pc, chunk=chunk)
            _cycle(kv, pc, 0, prompts["a"], 10)
            plans.append(_plan(pc.match(prompts["a"] + [3, 4, 5], 16, 0)))
        assert plans[0] == plans[1]


# ---------------------------------------------------------------------------
# engines: bit-identical to the cold engine, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cold(zoo):
    """Cache-cold tokens of every prompt: the port's and the reference's."""
    model, pmodel, prompts, shared, big = zoo
    port = _port(pmodel, **SMALL)
    ref = ref_serving.ServingEngine(model, ref_serving.ServeConfig(**SMALL))
    out = {k: (_one(port, p), _one(ref, p)) for k, p in prompts.items()}
    pport = _port(pmodel, **PRESSURE)
    pref = ref_serving.ServingEngine(model, ref_serving.ServeConfig(**PRESSURE))
    out["shared"] = (_one(pport, shared), _one(pref, shared))
    return out


def test_cold_tokens_equal_the_reference(cold):
    for port, ref in cold.values():
        assert port == ref


def test_miss_hit_and_fork_are_bit_identical(zoo, cold):
    _, pmodel, prompts, _, _ = zoo
    eng = _port(pmodel, prefix_cache=True, **SMALL)
    assert _one(eng, prompts["a"]) == cold["a"][0]        # miss, then inserted
    assert _one(eng, prompts["a"]) == cold["a"][0]        # full hit
    assert _one(eng, prompts["b"]) == cold["b"][0]        # shared-prefix hit
    assert _one(eng, prompts["f"]) == cold["f"][0]        # COW fork
    assert _one(eng, prompts["c"]) == cold["c"][0]        # unrelated miss
    st = eng.stats()
    pcs = st["prefix_cache"]
    assert (pcs["hits"], pcs["misses"], pcs["forks"]) == (3, 2, 1)
    assert pcs["hit_frac"] == pytest.approx(0.6) and pcs["host_budget"] == 0
    assert st["kv_calls"] == {"kv_copy": 1, "kv_offload": 0, "kv_restore": 0}
    assert st["captures"] == {"decode": 0, "prefill": 0}
    _audit(eng)


def test_concurrent_hits_share_blocks_live(zoo, cold):
    _, pmodel, prompts, _, _ = zoo
    eng = _port(pmodel, prefix_cache=True, **SMALL)
    _one(eng, prompts["a"])
    r1, r2 = eng.submit(prompts["b"], MAX_NEW), eng.submit(prompts["b"], MAX_NEW)
    eng.step()
    assert eng._kv.shared_blocks >= 2 and eng.stats()["prefix_cache"]["shared_blocks"] >= 2
    eng.run(max_steps=300)
    assert tuple(r1.generated) == tuple(r2.generated) == cold["b"][0]
    assert eng._kv.shared_blocks == 0
    _audit(eng)


@pytest.mark.parametrize("host", [8, 0])
def test_evict_restore_and_drop_are_bit_identical(zoo, cold, host):
    """A 7-usable-block pool: the big prompt pushes the cached shared
    prompt out, to the host tier (then restored on the next hit) or
    dropped; tokens stay cold, as the reference engine's."""
    model, pmodel, _, shared, big = zoo
    want = cold["shared"][0]
    eng = _port(pmodel, prefix_cache=True, host_kv_blocks=host, **PRESSURE)
    ref = ref_serving.ServingEngine(model, ref_serving.ServeConfig(
        prefix_cache=True, host_kv_blocks=host, **PRESSURE))
    got = [_one(eng, shared), _one(eng, big, 3), _one(eng, shared),
           _one(eng, big, 3), _one(eng, shared)]
    assert got == [_one(ref, shared), _one(ref, big, 3), _one(ref, shared),
                   _one(ref, big, 3), _one(ref, shared)]
    assert got[0] == got[2] == got[4] == want
    st = eng.stats()["prefix_cache"]
    rst = ref.stats()["prefix_cache"]
    assert {k: st[k] for k in rst} == rst
    if host:
        assert st["evictions_host"] >= 4 and st["restores"] >= 4
        assert eng.stats()["kv_calls"]["kv_offload"] == st["evictions_host"]
        assert eng.stats()["kv_calls"]["kv_restore"] == st["restores"]
    else:
        assert st["evictions_drop"] >= 4 and st["restores"] == 0
        assert st["host_blocks"] == 0
    _audit(eng)


def test_offload_restore_round_trip_is_bitwise(zoo):
    _, pmodel, prompts, _, _ = zoo
    eng = _port(pmodel, prefix_cache=True, host_kv_blocks=2, **SMALL)
    g = torch.Generator().manual_seed(0)
    eng._kv.pages_k.copy_(torch.randn(eng._kv.pages_k.shape, generator=g))
    eng._kv.pages_v.copy_(torch.randn(eng._kv.pages_v.shape, generator=g))
    before = eng._kv.pages_k[:, 3].clone(), eng._kv.pages_v[:, 3].clone()
    pay = eng._prefix.offload(0, 3)
    eng._kv.pages_k[:, 5] = 0
    eng._kv.pages_v[:, 5] = 0
    eng._prefix.restore(0, pay, 5)
    eng._prefix.copy(0, 5, 6)
    for pages, b in zip((eng._kv.pages_k, eng._kv.pages_v), before):
        assert torch.equal(pages[:, 5], b) and torch.equal(pages[:, 6], b)
    assert eng.stats()["kv_calls"] == {"kv_copy": 1, "kv_offload": 1, "kv_restore": 1}


def test_two_hits_fit_where_cold_requests_serialize(zoo):
    """The reference's admission-capacity case: a 5-usable-block pool and
    two 3-block requests run one at a time cold, together as hits."""
    model, pmodel, prompts, _, _ = zoo
    p = prompts["a"][:9]
    cfg = dict(num_lanes=2, block_size=BS, max_seq_len=12, num_blocks=6, prefill_chunk=BS)
    cold_eng = _port(pmodel, **cfg)
    ra, rb = cold_eng.submit(p, 3), cold_eng.submit(p, 3)
    cold_eng.step()
    assert rb.status == "waiting"
    cold_eng.run(max_steps=200)
    cold_tok = tuple(ra.generated)
    assert tuple(rb.generated) == cold_tok
    eng = _port(pmodel, prefix_cache=True, **cfg)
    assert _one(eng, p, 3) == cold_tok
    ra, rb = eng.submit(p, 3), eng.submit(p, 3)
    eng.step()
    assert ra.status != "waiting" and rb.status != "waiting"
    assert eng._kv.shared_blocks >= 1
    eng.run(max_steps=200)
    assert tuple(ra.generated) == tuple(rb.generated) == cold_tok
    ref = ref_serving.ServingEngine(model, ref_serving.ServeConfig(prefix_cache=True, **cfg))
    _one(ref, p, 3)
    rra, rrb = ref.submit(p, 3), ref.submit(p, 3)
    ref.run(max_steps=200)
    assert tuple(rra.generated) == tuple(rrb.generated) == cold_tok
    _audit(eng)


def test_cancel_churn_strands_nothing(zoo, cold):
    _, pmodel, prompts, _, _ = zoo
    eng = _port(pmodel, prefix_cache=True, **SMALL)
    rng = np.random.RandomState(11)
    live, done = [], []
    for _ in range(30):
        k = ("a", "b", "f", "c")[rng.randint(4)]
        req = eng.submit(prompts[k], MAX_NEW)
        live.append(req)
        done.append((k, req))
        if rng.rand() < 0.4 and live:
            eng.cancel(live.pop(rng.randint(len(live))))
        eng.step()
        _audit(eng)
    eng.run(max_steps=400)
    _audit(eng)
    finished = [(k, r) for k, r in done if r.status == "done"]
    assert finished and all(tuple(r.generated) == cold[k][0] for k, r in finished)


# ---------------------------------------------------------------------------
# ServeConfig.host_kv_blocks
# ---------------------------------------------------------------------------

def test_host_kv_blocks_needs_the_cache_and_falls_back_to_the_env(zoo, monkeypatch):
    _, pmodel, _, _, _ = zoo
    eng = _port(pmodel, host_kv_blocks=4, **SMALL)      # ignored without the cache
    assert eng._prefix is None and "prefix_cache" not in eng.stats()
    monkeypatch.setenv("PADDLE_KV_HOST_BLOCKS", "6")
    eng = _port(pmodel, prefix_cache=True, **SMALL)
    assert eng.stats()["prefix_cache"]["host_budget"] == 6
    assert eng._prefix.offload is not None
    eng = _port(pmodel, prefix_cache=True, host_kv_blocks=0, **SMALL)
    assert eng.stats()["prefix_cache"]["host_budget"] == 0 and eng._prefix.offload is None
    monkeypatch.setenv("PADDLE_KV_HOST_BLOCKS", "x")
    assert _port(pmodel, prefix_cache=True, **SMALL).stats()["prefix_cache"]["host_budget"] == 0
    with pytest.raises(ValueError, match="host_kv_blocks"):
        ServeConfig(host_kv_blocks=-1)


def test_prefix_engine_is_freed_with_its_last_reference(zoo):
    import weakref

    _, pmodel, prompts, _, _ = zoo
    eng = _port(pmodel, prefix_cache=True, host_kv_blocks=2, **SMALL)
    _one(eng, prompts["a"])
    gone = weakref.ref(eng)
    del eng
    assert gone() is None


# ---------------------------------------------------------------------------
# paged decode attention over aliased block tables
# ---------------------------------------------------------------------------

def aliased_tables(rng, lanes: int, mb: int, shared: int, nb: int):
    """Block tables as the prefix cache leaves them: every lane's first
    ``shared`` entries are the same pages, lane 1 holds a private fork of
    the last shared page, the rest of each row private."""
    pages = rng.permutation(np.arange(1, nb))
    table = np.zeros((lanes, mb), np.int32)
    table[:, :shared] = pages[:shared]
    rest = pages[shared:]
    for b in range(lanes):
        table[b, shared:] = rest[b * (mb - shared):(b + 1) * (mb - shared)]
    table[1, shared - 1] = rest[lanes * (mb - shared)]          # the fork
    return table


@pytest.mark.parametrize("lengths, H, Hk", [([40, 33, 17, 70], 8, 2), ([63, 63, 20], 4, 4)])
def test_split_emulation_over_aliased_pages(lengths, H, Hk):
    """The kernel's schedule and merge (its CPU emulation) reads pages only
    through the table, and keys its scratch by (lane, KV head, pass): lanes
    whose tables alias the same pages give the plain version's output, and
    the reference's, at every grid. f32, within 1e-5 (outputs are convex
    combinations of N(0, 1) rows; the two sides sum in another order)."""
    from paddle_tpu.inference.serving import paged_attention as ref_pa
    from paddle_tpu_torch.ops import paged_attention as port_ops

    bs, mb, hd = 16, 5, 16
    rng = np.random.RandomState(len(lengths) + H)
    lanes = len(lengths)
    nb = 1 + lanes * mb + 1
    pk = rng.randn(nb, bs, Hk, hd).astype(np.float32)
    pv = rng.randn(nb, bs, Hk, hd).astype(np.float32)
    table = aliased_tables(rng, lanes, mb, 2, nb)
    ln = np.asarray(lengths, np.int32)
    q = rng.randn(lanes, H, hd).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, ln)]
    plain = port_ops.paged_decode_attention_ref(*args)
    for grid in (264, 37, 5, 1):
        got = port_ops.paged_decode_attention_split(*args, grid)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    kc = ref_pa.gather_lane_window(jax.numpy.asarray(pk), jax.numpy.asarray(table))
    vc = ref_pa.gather_lane_window(jax.numpy.asarray(pv), jax.numpy.asarray(table))
    visible = np.arange(mb * bs)[None, :] <= ln[:, None]
    want = np.asarray(ref_llama.masked_attend(jax.numpy.asarray(q), kc, vc,
                                              jax.numpy.asarray(visible)))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
