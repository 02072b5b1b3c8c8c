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
    (dict(hd=1025), ValueError),               # past the wide kernel's 1024 by one
    (dict(hd=1032), ValueError),               # past the wide kernel's 1024
    (dict(hk=3), ValueError),                  # H % Hk != 0
    (dict(phd=32), ValueError),                # pages of another head dim
    (dict(table_dtype=torch.int64), TypeError),
    (dict(lengths_dtype=torch.int64), TypeError),
    (dict(q_dtype=torch.int8), TypeError),
])
def test_card_checks_reject_what_the_kernel_does_not_take(bad, err):
    hd, hk, bs = bad.get("hd", 64), bad.get("hk", 2), bad.get("bs", 4)
    q = torch.zeros((2, 4, hd), dtype=bad.get("q_dtype", torch.bfloat16))
    pages = torch.zeros((3, bs, hk, bad.get("phd", hd)), dtype=torch.bfloat16)
    table = torch.zeros((2, 2), dtype=bad.get("table_dtype", torch.int32))
    lengths = torch.zeros((2,), dtype=bad.get("lengths_dtype", torch.int32))
    with pytest.raises(err):
        port_ops._check(q, pages, pages, table, lengths)


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 128), (torch.float16, 80),
                                      (torch.float32, 80), (torch.float32, 96),
                                      (torch.bfloat16, 96), (torch.float16, 8),
                                      (torch.bfloat16, 20), (torch.float16, 100),
                                      (torch.float32, 6), (torch.bfloat16, 320),
                                      (torch.float32, 512), (torch.float16, 257)])
def test_card_checks_take_what_the_reference_serves(dtype, hd):
    """bf16, fp16 and f32 at any head_dim up to 1024: the reference's
    composed path serves them all, so the card takes them too (a head_dim
    whose rows TMA cannot map, such as 20, 100 or 6, through the kernel's
    copying producer; past 256 in the kernel's wide mode)."""
    q = torch.zeros((2, 8, hd), dtype=dtype)
    pages = torch.zeros((3, 16, 2, hd), dtype=dtype)
    port_ops._check(q, pages, pages, torch.zeros((2, 2), dtype=torch.int32),
                    torch.zeros((2,), dtype=torch.int32))
    assert port_ops.mode(hd, 16) == ("narrow" if hd <= 256 else "wide")
    assert port_ops.mode(64, 512) == "wide"


@pytest.mark.parametrize("hd,bs,want", [
    (128, 16, "narrow"), (256, 256, "narrow"), (6, 1, "narrow"), (257, 16, "wide"),
    (1024, 8, "wide"), (128, 257, "wide"), (128, 300, "wide"), (8, 512, "wide"),
    (520, 512, "wide"),
])
def test_mode_of_each_shape(hd, bs, want):
    """The wrapper's routing: head dims and pages up to 256 take the narrow
    mode, past either the wide one (both one launch of
    ``csrc/paged_attention.cu``, counted in ``by_route``)."""
    assert port_ops.mode(hd, bs) == want
    assert set(port_ops.paged_decode_attention.by_route) == set(port_ops.MODES)


# (hd, bs, element size) -> (slice columns, box rows): the card's geometry
@pytest.mark.parametrize("hd,bs,es,want", [
    (320, 16, 2, (80, 16)), (512, 16, 2, (128, 16)), (520, 16, 2, (136, 16)),
    (1024, 16, 2, (256, 16)), (1024, 8, 2, (256, 8)), (128, 512, 2, (32, 16)),
    (64, 512, 2, (16, 32)), (128, 300, 2, (32, 16)), (300, 16, 2, (80, 16)),
    (8, 512, 2, (8, 64)), (1024, 16, 4, (256, 8)), (128, 512, 4, (32, 8)),
    (6, 300, 4, (8, 32)),
])
def test_wide_geometry(hd, bs, es, want):
    """Each of the four slices is a multiple of 8 columns and together they
    cover the head dim; a box's width stays within TMA's 256; a box is whole
    16-row groups (f32: 8) unless the page is shorter."""
    wc, rows = port_ops.wide_geometry(hd, bs, es)
    assert (wc, rows) == want
    assert wc % 8 == 0 and port_ops.SLICES * wc >= hd and wc - 8 < -(-hd // port_ops.SLICES)
    assert rows == bs or rows % (16 if es == 2 else 8) == 0


def _composed_reference(q, pk, pv, table, ln):
    """The reference's composed path: gather_lane_window + masked_attend."""
    from paddle_tpu.models.llama import masked_attend

    S = table.shape[1] * pk.shape[1]
    kc = ref_pa.gather_lane_window(jnp.asarray(pk), jnp.asarray(table))
    vc = ref_pa.gather_lane_window(jnp.asarray(pv), jnp.asarray(table))
    vis = jnp.arange(S)[None, :] <= jnp.asarray(ln)[:, None]
    return np.asarray(masked_attend(jnp.asarray(q), kc, vc, vis).astype(jnp.float32))


# fp16 on both sides: the same einsums and f32 softmax, rounded to fp16 at
# the same places (logits, probabilities, output) from f32 sums taken in
# another order; outputs mix N(0, 1) rows (|out| < 4), so a rounding step
# of the output (2^-9 at 2-4) and of a probability apart: 4e-3.
PARITY_TOL = {np.float16: 4e-3, np.float32: 1e-5}


@pytest.mark.parametrize("np_dtype,hd", [(np.float16, 128), (np.float16, 80),
                                         (np.float32, 80), (np.float32, 96),
                                         (np.float16, 96), (np.float16, 20),
                                         (np.float32, 20), (np.float32, 6)])
def test_plain_matches_reference_in_fp16_and_other_head_dims(np_dtype, hd):
    """The plain version against the reference's composed path in fp16
    and at head_dims 80, 96, 20 and 6, which the card takes (the last two
    are served by the reference's composed path only: its kernel gate
    declines them)."""
    rng = np.random.RandomState(hd)
    lengths = [0, 19, 7, MB * BS - 1]
    lanes, nb = len(lengths), 1 + len(lengths) * MB
    pk = rng.randn(nb, BS, HK, hd).astype(np_dtype)
    pv = rng.randn(nb, BS, HK, hd).astype(np_dtype)
    table = rng.permutation(np.arange(1, nb))[:lanes * MB].reshape(lanes, MB).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    q = rng.randn(lanes, H, hd).astype(np_dtype)
    want = _composed_reference(q, pk, pv, table, ln)
    got = port_ops.paged_decode_attention(*(torch.from_numpy(x) for x in (q, pk, pv, table, ln)))
    assert got.dtype == torch.from_numpy(q).dtype
    tol = PARITY_TOL[np_dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# (lengths, H, Hk): ragged, skewed (one long lane), full, every lane
# inactive; the last shape has 12 query heads a KV head: two passes
SCHEDULE_CASES = [([0, 1, 17, 250, 511, 700, 1000, 1023], 32, 8),
                  ([1023] + [31] * 7, 32, 8),
                  ([1023] * 8, 32, 8),
                  ([0] * 8, 32, 8),
                  ([0, 77, 1023, 5], 24, 2)]


@pytest.mark.parametrize("lengths,H,Hk", SCHEDULE_CASES)
@pytest.mark.parametrize("grid", [264, 37])
def test_every_visible_page_falls_to_exactly_one_block(lengths, H, Hk, grid):
    """The kernel's schedule: every visible (lane, KV head, pass, page)
    in exactly one chunk, one chunk a block where the pairs fit the grid,
    no chunk longer than Kc pages, Kc the fewest pages that fit, and each
    pair's chunks consecutive so its merge reads them in order."""
    bs, mb = 16, 64
    segs = port_ops.split_schedule(lengths, bs, mb, H, Hk, grid)
    passes = -(-(H // Hk) // port_ops.heads_per_pass(H, Hk))
    seen = {}
    for s in segs:
        for page in range(*s["units"]):
            key = (s["lane"], s["kv_head"], s["pass"], page)
            seen[key] = seen.get(key, 0) + 1
    want = {(b, g, c, page) for b, n in enumerate(lengths) for g in range(Hk)
            for c in range(passes) for page in range(-(-(min(n, mb * bs - 1) + 1) // bs))}
    assert set(seen) == want and set(seen.values()) == {1}
    pairs = len(lengths) * Hk * passes
    blocks = [s["block"] for s in segs]
    if pairs <= grid:
        assert len(segs) <= grid and len(set(blocks)) == len(blocks)
    kc = max(s["units"][1] - s["units"][0] for s in segs)
    npages = [-(-(n + 1) // bs) for n in lengths]
    assert kc == max(npages) or sum(-(-p // (kc - 1)) for p in npages) * Hk * passes > grid
    for s in segs:
        assert s["chunk"] - s["first"] < s["splits"]
        assert segs[s["first"]]["pair"] == s["pair"]


@pytest.mark.parametrize("lengths,H,Hk", SCHEDULE_CASES)
def test_split_emulation_matches_plain_and_reference(lengths, H, Hk):
    """The kernel's chunks and their merge in split order, on the CPU in
    f32, against the plain version and the reference's composed path."""
    bs, mb, hd = 16, 64, 16
    rng = np.random.RandomState(len(lengths) + H)
    lanes, nb = len(lengths), 1 + len(lengths) * mb
    pk = rng.randn(nb, bs, Hk, hd).astype(np.float32)
    pv = rng.randn(nb, bs, Hk, hd).astype(np.float32)
    table = rng.permutation(np.arange(1, nb))[:lanes * mb].reshape(lanes, mb).astype(np.int32)
    table[[b for b, n in enumerate(lengths) if n == 0]] = 0   # inactive lanes: trash block
    ln = np.asarray(lengths, np.int32)
    q = rng.randn(lanes, H, hd).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, ln)]
    plain = port_ops.paged_decode_attention_ref(*args)
    for grid in (264, 37, 1):
        got = port_ops.paged_decode_attention_split(*args, grid)
        torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _composed_reference(q, pk, pv, table, ln),
                               rtol=RTOL, atol=ATOL)


def test_grid_depends_on_shapes_only():
    assert port_ops.grid_size(8, 32, 8, 64, 132) == 264       # Llama-3-8B serving shape
    assert port_ops.grid_size(1, 4, 4, 2, 132) == 8           # one block a possible page
    assert port_ops.grid_size(2, 24, 2, 3, 132) == 24         # two passes a KV head
    assert port_ops.grid_size(8, 16, 4, 64, 132, hd=320) == 132      # past 256 columns: one an SM
    assert port_ops.grid_size(8, 32, 8, 64, 132, hd=256) == 264
    assert port_ops.grid_size(1, 4, 4, 2, 132, hd=1024) == 8


# (lengths, bs, rows): pages past 256 slots cut into boxes of `rows` rows,
# the last box of a page reaching past its end where rows does not divide bs
UNIT_CASES = [([0, 300, 511, 1023, 17, 700, 1000, 5], 512, 16),
              ([0, 299, 300, 899, 5], 300, 16),
              ([256, 1, 770], 257, 16),
              ([1023] * 4, 512, 32)]


@pytest.mark.parametrize("lengths,bs,rows", UNIT_CASES)
@pytest.mark.parametrize("grid", [264, 37])
def test_every_visible_slot_falls_to_exactly_one_unit(lengths, bs, rows, grid):
    """The wide mode's schedule: units are boxes of rows of a page; every
    visible (lane, KV head, slot) lies in exactly one unit of exactly one
    chunk, and no chunk holds more than Kc units."""
    H, Hk, mb = 8, 2, -(-1024 // bs)
    segs = port_ops.split_schedule(lengths, bs, mb, H, Hk, grid, rows)
    upp = -(-bs // rows)
    seen = {}
    for s in segs:
        for u in range(*s["units"]):
            page, r0 = divmod(u, upp)
            for r in range(r0 * rows, min((r0 + 1) * rows, bs)):
                key = (s["lane"], s["kv_head"], page * bs + r)
                seen[key] = seen.get(key, 0) + 1
    nvis = [min(n, mb * bs - 1) + 1 for n in lengths]
    visible = {(b, g, slot) for b, n in enumerate(nvis) for g in range(Hk) for slot in range(n)}
    assert visible <= set(seen) and {seen[k] for k in visible} == {1}
    # the units reach no further than the last visible slot's box
    assert all(slot < -(-nvis[b] // rows) * rows + bs for b, _, slot in seen)
    if len(lengths) * Hk <= grid:
        assert len({s["block"] for s in segs}) == len(segs) <= grid


@pytest.mark.parametrize("np_dtype,hd,bs,H,Hk", [
    (np.float32, 320, 16, 8, 2), (np.float16, 320, 16, 8, 2),
    (np.float32, 512, 16, 8, 2), (np.float16, 512, 8, 8, 2),
    (np.float32, 520, 16, 4, 1), (np.float16, 520, 16, 4, 1),
    (np.float32, 1024, 8, 4, 2), (np.float16, 1024, 16, 4, 2),
    (np.float32, 128, 300, 8, 2), (np.float16, 128, 300, 8, 2),
    (np.float32, 128, 512, 8, 2), (np.float16, 64, 512, 8, 2),
    (np.float16, 300, 16, 8, 2), (np.float32, 320, 16, 24, 2),
])
def test_wide_emulation_matches_the_composed_reference(np_dtype, hd, bs, H, Hk):
    """The wide mode's arithmetic on the CPU (four column slices' partial
    scores added in warp order, units of boxes of rows of a page, chunks
    merged in split order) against the reference's composed path at ragged,
    one-slot and full lengths and at three grids; fp16 as the plain
    version's parity holds it (4e-3), f32 at 1e-5 (sums of up to 1024
    order-1 products in another order: 1e-5 holds with a decade to spare
    at these sizes)."""
    mb = 3
    cap = mb * bs
    lengths = [0, 1, bs - 1, cap // 2, cap - 1]
    rng = np.random.RandomState(hd + bs + H)
    lanes, nb = len(lengths), 1 + len(lengths) * mb
    pk = rng.randn(nb, bs, Hk, hd).astype(np_dtype)
    pv = rng.randn(nb, bs, Hk, hd).astype(np_dtype)
    table = rng.permutation(np.arange(1, nb))[:lanes * mb].reshape(lanes, mb).astype(np.int32)
    table[0] = 0                                    # an inactive lane on trash block 0
    ln = np.asarray(lengths, np.int32)
    q = rng.randn(lanes, H, hd).astype(np_dtype)
    want = _composed_reference(q, pk, pv, table, ln)
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, ln)]
    tol = PARITY_TOL[np_dtype]
    for grid in (264, 37, 1):
        got = port_ops.paged_decode_attention_split(*args, grid)
        assert got.dtype == args[0].dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
