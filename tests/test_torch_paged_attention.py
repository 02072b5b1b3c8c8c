"""PyTorch port: paged decode attention, prefill attention and the paged
view, against the reference's composed path on the CPU (where the
reference's kernel gate declines).

Pools are random, block tables fragmented (a shuffled block order, with
stale blocks past each lane's length), lengths ragged with
``lengths % bs != 0``, and one lane inactive on trash block 0. All in f32:
the two sides compute the same products and softmax in another order, so
outputs (convex combinations of N(0, 1) rows) agree to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.serving import paged_attention as ref_pa
from paddle_tpu_torch.inference.serving import paged_attention as port_pa
from paddle_tpu_torch.ops import paged_attention as port_ops

ATOL = RTOL = 1e-5

L, BS, HK, HD, H, MB = 2, 4, 2, 8, 4, 5


def _state(seed, lengths, active):
    """Pools [L, nb, bs, Hk, hd], a fragmented table and per-lane state.
    Lanes with ``active`` False and length 0 keep an all-zero table row
    (the engine's free lane: trash block 0)."""
    rng = np.random.RandomState(seed)
    lanes = len(lengths)
    nb = 1 + lanes * MB
    pk = rng.randn(L, nb, BS, HK, HD).astype(np.float32)
    pv = rng.randn(L, nb, BS, HK, HD).astype(np.float32)
    order = rng.permutation(np.arange(1, nb))
    table = np.zeros((lanes, MB), np.int32)
    for b in range(lanes):
        if active[b] or lengths[b]:
            table[b] = order[b * MB:(b + 1) * MB]
    return (pk, pv, table, np.asarray(lengths, np.int32),
            np.asarray(active, np.bool_))


LENGTHS = [6, 0, 3, 4, 0, 19]
ACTIVE = [True, False, True, True, True, True]


def test_view_append_then_attend_matches_reference():
    pk, pv, table, lengths, active = _state(0, LENGTHS, ACTIVE)
    ref = ref_pa.PagedKVView(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
                             jnp.asarray(lengths), jnp.asarray(active), BS)
    port = port_pa.PagedKVView(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
                               torch.from_numpy(table), torch.from_numpy(lengths),
                               torch.from_numpy(active), BS)
    rng = np.random.RandomState(1)
    lanes = len(LENGTHS)
    for li in range(L):
        k = rng.randn(lanes, HK, HD).astype(np.float32)
        v = rng.randn(lanes, HK, HD).astype(np.float32)
        q = rng.randn(lanes, H, HD).astype(np.float32)
        ref.append(li, jnp.asarray(k), jnp.asarray(v))
        port.append(li, torch.from_numpy(k), torch.from_numpy(v))
        # one inactive lane, so the trash-block write is unambiguous:
        # the pools agree exactly after the scatter
        np.testing.assert_array_equal(port.pages_k.numpy(), np.asarray(ref.pages_k))
        np.testing.assert_array_equal(port.pages_v.numpy(), np.asarray(ref.pages_v))
        want = np.asarray(ref.attend(li, jnp.asarray(q)))
        got = port.attend(li, torch.from_numpy(q)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_paged_decode_attention_plain_matches_composed(seed):
    """ops.paged_attention on CPU tensors (the plain version) against the
    reference's gather_lane_window + masked_attend, with the reference's
    visible rule: slots 0..lengths[lane]."""
    from paddle_tpu.models.llama import masked_attend

    rng = np.random.RandomState(seed)
    lengths = [int(x) for x in rng.randint(0, MB * BS, 5)]
    lengths[0] = 0
    lengths[1] = MB * BS - 1          # full window
    pk, pv, table, ln, _ = _state(seed, lengths, [True] * 5)
    q = rng.randn(5, H, HD).astype(np.float32)
    kc = ref_pa.gather_lane_window(jnp.asarray(pk[1]), jnp.asarray(table))
    vc = ref_pa.gather_lane_window(jnp.asarray(pv[1]), jnp.asarray(table))
    vis = jnp.arange(MB * BS)[None, :] <= jnp.asarray(ln)[:, None]
    want = np.asarray(masked_attend(jnp.asarray(q), kc, vc, vis))
    before = port_ops.paged_decode_attention.launches
    got = port_ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk[1]), torch.from_numpy(pv[1]),
        torch.from_numpy(table), torch.from_numpy(ln)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert port_ops.paged_decode_attention.launches == before


def test_stale_slots_never_reach_the_output():
    """Poisoning every slot past a lane's length (in its last page and in
    later pages of its row) leaves the plain version's output unchanged."""
    lengths = [5, 9, 0]
    pk, pv, table, ln, _ = _state(7, lengths, [True, True, True])
    q = torch.from_numpy(np.random.RandomState(8).randn(3, H, HD).astype(np.float32))
    args = (torch.from_numpy(table), torch.from_numpy(ln))
    clean = port_ops.paged_decode_attention(q, torch.from_numpy(pk[0]),
                                            torch.from_numpy(pv[0]), *args)
    for b, n in enumerate(lengths):
        for s in range(n + 1, MB * BS):
            blk, off = table[b, s // BS], s % BS
            pk[0, blk, off] = 1e4
            pv[0, blk, off] = 1e4
    poisoned = port_ops.paged_decode_attention(q, torch.from_numpy(pk[0]),
                                               torch.from_numpy(pv[0]), *args)
    torch.testing.assert_close(poisoned, clean, rtol=0, atol=0)


def test_gather_lane_window_matches_reference():
    pk, _, table, _, _ = _state(9, [3, 7, 0], [True, True, False])
    want = np.asarray(ref_pa.gather_lane_window(jnp.asarray(pk[0]), jnp.asarray(table)))
    got = port_pa.gather_lane_window(torch.from_numpy(pk[0]), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start,C", [(0, 3), (5, 4), (13, 6)])
def test_prefill_attend_matches_reference(start, C):
    rng = np.random.RandomState(start + C)
    S = MB * BS
    q = rng.randn(1, C, H, HD).astype(np.float32)
    kc = rng.randn(1, S, HK, HD).astype(np.float32)
    vc = rng.randn(1, S, HK, HD).astype(np.float32)
    qpos = np.arange(start, start + C, dtype=np.int32)
    want = np.asarray(ref_pa.prefill_attend(jnp.asarray(q), jnp.asarray(kc),
                                            jnp.asarray(vc), jnp.asarray(qpos)))
    got = port_pa.prefill_attend(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad, err", [
    (dict(hd=24), ValueError),                 # not a multiple of 32
    (dict(hk=3), ValueError),                  # H % Hk != 0
    (dict(table_dtype=torch.int64), TypeError),
    (dict(q_dtype=torch.float16), TypeError),
])
def test_card_checks_reject_what_the_kernel_does_not_take(bad, err):
    hd, hk = bad.get("hd", 64), bad.get("hk", 2)
    q = torch.zeros((2, 4, hd), dtype=bad.get("q_dtype", torch.bfloat16))
    pages = torch.zeros((3, 4, hk, hd), dtype=torch.bfloat16)
    table = torch.zeros((2, 2), dtype=bad.get("table_dtype", torch.int32))
    lengths = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(err):
        port_ops._check(q, pages, pages, table, lengths)


@pytest.mark.parametrize("bs,hd,rep,esize", [(16, 128, 4, 2), (4, 64, 2, 4),
                                             (16, 256, 32, 4), (128, 128, 1, 2)])
def test_tile_is_whole_pages_within_shared_memory(bs, hd, rep, esize):
    ts = port_ops.tile_slots(bs, hd, rep, esize)
    assert ts % bs == 0 and ts >= bs and (ts <= 64 or ts == bs)
    assert ts == bs or port_ops.smem_bytes(ts, hd, rep, esize) <= 40 * 1024
    assert port_ops.tile_slots(16, 128, 4, 2) == 64   # Llama-3-8B serving shape
