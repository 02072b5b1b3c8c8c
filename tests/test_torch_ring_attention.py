"""PyTorch port: ring attention against the reference, on the CPU.

The port keeps the P ranks of a ring in one process (the global sequence
folded into the batch); the reference runs one shard per device of the
conftest's virtual CPU mesh under ``shard_map``. Same numpy inputs (f32,
the reference's own ring sizes: B 1-2, S 32, P 4, H 4, Hk 1-4, D 8) go
through:

- the port's ``ring_merge_ref`` and in-place ``ring_merge`` (plain on the
  CPU) against the reference's ``_merge``, including the ``-1e30`` identity;
- the port's ring-flash schedule (its plain kernel versions) and composed
  ring, forward and gradients, against the reference's composed ring
  differentiated by ``jax.grad`` and against the port's full-sequence
  flash attention, causal or not, GQA with Hk 1, 2 and 4;
- the port's schedule, which launches no masked step, against the
  reference's gated schedule (every step computed, masked ones gated by 0),
  and in fp16, where the gate's ``inf * 0`` turns into NaN;
- one case against the reference's ring-flash Pallas kernels in interpret
  mode;
- the one-process mesh, ``parallelize``, ``ring_context_attention`` and
  their errors.

Tolerances: outputs 2e-5 and gradients 5e-5 absolute, f32 sums in
another order over at most 32 keys of order-1 terms (as the flash tests);
the merge 1e-6 (the same f32 formula, exp of two libraries).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as PS

import paddle_tpu.distributed as ref_dist
from paddle_tpu.ops.pallas import ring_flash as ref_ring_flash
from paddle_tpu.ops.pallas.ring_attention import ring_attention as ref_ring_attention
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.fleet.sequence_parallel import ring_context_attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_attention as ra
from paddle_tpu_torch.ops import ring_flash as rf

ATOL = 2e-5
GRAD_ATOL = 5e-5
MERGE_ATOL = 1e-6
P = 4


def _draw(seed, B, S, H, Hk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32), rng.randn(B, S, Hk, D).astype(np.float32),
            rng.randn(B, S, Hk, D).astype(np.float32), rng.randn(B, S, H, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference_ring(causal, hk, impl="composed", B=2, S=32, H=4, D=8, seed=0):
    """The reference's ring over a 4-device ``cp`` axis: (inputs, out,
    (dq, dk, dv)) of ``sum(out * do)``."""
    q, k, v, do = _draw(seed + hk + 10 * causal, B, S, H, hk, D)
    mesh = ref_dist.ProcessMesh(shape=[P], dim_names=["cp"])
    spec = PS(None, "cp")
    ring = shard_map(
        lambda a, b, c: ref_ring_attention(a, b, c, axis_name="cp", causal=causal, impl=impl),
        mesh=mesh.jax_mesh, in_specs=(spec, spec, spec), out_specs=spec, check_rep=False)

    def loss(a, b, c):
        return jnp.sum(ring(a, b, c) * jnp.asarray(do))

    out = np.asarray(jax.jit(ring)(q, k, v))
    grads = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]
    return (q, k, v, do), out, grads


def _port(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


#: the port's two schedules on CPU tensors: the ring-flash schedule over the
#: kernels' plain versions, and the public entry, which keeps CPU tensors on
#: the composed ring
SCHEDULES = {"flash": lambda q, k, v, p, causal: rf.ring_flash_attention(q, k, v, p, causal),
             "composed": lambda q, k, v, p, causal: ra.ring_attention(q, k, v, p, causal)}


def _assert_close(got, want, grads, want_grads):
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_matches_the_reference_merge_and_its_identity(dtype):
    N, S, H, D = 3, 10, 2, 8
    rng = np.random.RandomState(1)
    acc = rng.randn(N, S, H, D).astype(np.float32)
    out_b = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(dtype)
    lse = (rng.randn(N, H, S) * 2 + 5).astype(np.float32)
    lse_b = (rng.randn(N, H, S) * 2 + 5).astype(np.float32)
    lse_b[:, :, ::3] = -1e30                       # masked rows: the identity
    got, got_lse = rf.ring_merge_ref(torch.from_numpy(acc), torch.from_numpy(lse), out_b,
                                     torch.from_numpy(lse_b))

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(N * H, S, D))

    want, want_lse = ref_ring_flash._merge(bhsd(acc), jnp.asarray(lse.reshape(N * H, 1, S)),
                                           bhsd(out_b.float().numpy()),
                                           jnp.asarray(lse_b.reshape(N * H, 1, S)))
    want = np.asarray(want).reshape(N, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=MERGE_ATOL, rtol=MERGE_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(N, H, S),
                               atol=MERGE_ATOL, rtol=MERGE_ATOL)
    np.testing.assert_array_equal(got.numpy()[:, ::3], acc[:, ::3])
    np.testing.assert_array_equal(got_lse.numpy()[:, :, ::3], lse[:, :, ::3])
    # the wrapper (plain on the CPU) merges in place and writes finished rows
    acc_t, lse_t = torch.from_numpy(acc.copy()), torch.from_numpy(lse.copy())
    out = torch.zeros((1, S, H, D), dtype=dtype)
    rf.ring_merge(acc_t, lse_t, out_b, torch.from_numpy(lse_b), out)
    assert torch.equal(acc_t, got) and torch.equal(lse_t, got_lse)
    assert torch.equal(out, got[:1].to(dtype))
    assert rf.ring_merge.launches == 0


# ---------------------------------------------------------------------------
# the ring against the reference's composed ring and the full flash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["flash", "composed"])
@pytest.mark.parametrize("causal,hk", [(True, 1), (True, 2), (True, 4),
                                       (False, 1), (False, 2), (False, 4)])
def test_ring_matches_reference_ring_and_full_flash(causal, hk, impl):
    (q, k, v, do), want, want_grads = _reference_ring(causal, hk)
    got, grads = _port(lambda a, b, c: SCHEDULES[impl](a, b, c, P, causal), q, k, v, do)
    _assert_close(got, want, grads, want_grads)
    full, full_grads = _port(lambda a, b, c: fa.flash_attention(a, b, c, causal), q, k, v, do)
    _assert_close(got, full, grads, full_grads)


def test_auto_takes_the_composed_ring_on_the_cpu(monkeypatch):
    """``ring_attention`` keeps CPU tensors composed; where the kernels run
    it takes the flash schedule (the gate sent there by a patched
    predicate)."""
    (q, k, v, do), want, _ = _reference_ring(True, 2)
    assert not ra.flash_runs(torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16))
    calls = []
    want_t = torch.tensor(want)
    monkeypatch.setattr(ra, "_composed", lambda *a: calls.append("composed") or want_t)
    assert ra.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), P, True) is want_t
    assert calls == ["composed"]
    monkeypatch.setattr(ra, "flash_runs", lambda t: True)
    got = ra.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), P, True)
    assert calls == ["composed"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ---------------------------------------------------------------------------
# masked steps: not launched, equal to the reference's gated schedule
# ---------------------------------------------------------------------------


def _gated_ring(q, k, v, dout, P):
    """The reference's causal schedule on the port's folded layout and
    plain kernel versions: every (rank, step) pair computed, the masked ones
    (K/V owner after the rank) merged with lse_b = -1e30 and their
    gradients multiplied by 0, dK/dV added to their owners in step order."""
    n = q.shape[0] // P
    rank = torch.arange(P).repeat_interleave(n)
    acc = torch.zeros(q.shape)
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), -1e30)
    shards = [(k.roll(s * n, 0), v.roll(s * n, 0), (rank - s) % P < rank) for s in range(P)]
    for s, (ks, vs, visible) in enumerate(shards):
        out_b, lse_b = fa.flash_attention_fwd_ref(q, ks, vs, causal=s == 0)
        if s > 0:
            lse_b = torch.where(visible[:, None, None], lse_b, torch.tensor(-1e30))
        acc, lse = rf.ring_merge_ref(acc, lse, out_b, lse_b)
    out = acc.to(q.dtype)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.zeros(t.shape) for t in (q, k, v))
    for s, (ks, vs, visible) in enumerate(shards):
        gate = torch.ones(()) if s == 0 else visible.float()[:, None, None, None]
        dq_b, dk_b, dv_b = fa.flash_attention_bwd_ref(q, ks, vs, dout, lse, delta, s == 0)
        dq += dq_b.float() * gate
        dk += (dk_b.float() * gate).roll(-s * n, 0)
        dv += (dv_b.float() * gate).roll(-s * n, 0)
    return out, (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _ring_port(q, k, v, dout):
    out, lse = rf.ring_flash_fwd(q, k, v, P, True)
    return out, rf.ring_flash_bwd(q, k, v, out, lse, dout, P, True)


@pytest.mark.parametrize("B,hk", [(1, 2), (2, 1)])
def test_skipping_masked_steps_equals_the_gated_schedule(B, hk):
    """f32: a merge with lse_b = -1e30 is exactly the identity and x + 0 is
    x, so the port's launch-free skip gives the reference's gated result
    (to f32 rounding of products blocked over another batch size)."""
    q, k, v, do = (rf.fold(torch.from_numpy(a), P) for a in _draw(3, B, 32, 4, hk, 8))
    out, grads = _ring_port(q, k, v, do)
    want, want_grads = _gated_ring(q, k, v, do, P)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-6)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


def test_masked_steps_would_turn_fp16_gradients_into_nan():
    """fp16, keys of the last shard far along the queries: a masked
    backward step's exp(min(s - lse, 60)) overflows dS, and the gate's
    inf * 0 is NaN. The port never computes that step."""
    q, k, v, do = (torch.from_numpy(a) for a in _draw(4, 1, 32, 4, 2, 8))
    q = q.abs() + 1.0
    k[:, 24:] = 20.0
    q, k, v, do = (rf.fold(t.half(), P) for t in (q, k, v, do))
    _, want_grads = _gated_ring(q, k, v, do, P)
    assert not all(bool(torch.isfinite(g).all()) for g in want_grads)
    out, grads = _ring_port(q, k, v, do)
    assert bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_ring_flash_matches_the_reference_pallas_kernels_in_interpret_mode():
    """The reference's fused ring over its FA2 Pallas kernels (interpret
    mode on the CPU mesh) against the port's schedule on its plain
    versions, causal with GQA; the composed-ring cases above are its
    broader siblings."""
    (q, k, v, do), want, want_grads = _reference_ring(True, 2, impl="flash", B=1)
    got, grads = _port(lambda a, b, c: rf.ring_flash_attention(a, b, c, P, True), q, k, v, do)
    _assert_close(got, want, grads, want_grads)


# ---------------------------------------------------------------------------
# the fold, the mesh, parallelize and the errors
# ---------------------------------------------------------------------------


def test_fold_is_a_view_for_one_sequence_and_round_trips():
    t = torch.randn(1, 32, 4, 8)
    f = rf.fold(t, P)
    assert f.shape == (4, 8, 4, 8) and f.data_ptr() == t.data_ptr()
    t2 = torch.randn(2, 32, 4, 8)
    f2 = rf.fold(t2, P)
    assert torch.equal(f2[1 * 2 + 1], t2[1, 8:16]) and f2.is_contiguous()   # rank 1, batch 1
    assert torch.equal(rf.unfold(f2, P), t2)


def test_mesh_parallelize_and_ring_context_attention():
    mesh = dist.ProcessMesh(shape=[1, 4], dim_names=["dp", "sep"])
    assert mesh.shape == [1, 4] and mesh.ndim == 2 and mesh.get_dim_size("sep") == 4
    assert mesh == dist.auto_mesh(dp=1, sep=4) and hash(mesh) == hash(dist.auto_mesh(dp=1, sep=4))
    assert "sep" in repr(mesh) and mesh != dist.auto_mesh(dp=1, sep=2)
    assert dist.ProcessMesh(mesh=[[0, 1]], dim_names=["dp", "sep"]).get_dim_size("sep") == 2
    (q, k, v, do), want, _ = _reference_ring(True, 2)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    assert dist.get_mesh() is None
    with pytest.raises(RuntimeError, match="active mesh"):
        ring_context_attention(qt, kt, vt)
    with mesh:
        assert dist.get_mesh() is mesh
        np.testing.assert_allclose(ring_context_attention(qt, kt, vt).numpy(), want, atol=ATOL)
        with pytest.raises(ValueError, match="'cp' axis"):
            ring_context_attention(qt, kt, vt, axis_name="cp")
    assert dist.get_mesh() is None
    model, opt = torch.nn.Linear(2, 2), object()
    with pytest.raises(ValueError, match="needs a mesh"):
        dist.parallelize(model, opt)
    try:
        assert dist.parallelize(model, opt, mesh=mesh) == (model, opt)
        assert dist.get_mesh() is mesh and dist.parallelize(model) is model
    finally:
        dist.set_mesh(None)


@pytest.mark.parametrize("shape,names", [([2, 4], ["dp", "sep"]), ([1, 2, 2], ["dp", "sep", "mp"]),
                                         ([4], ["cp"]), ([2], None)])
def test_meshes_that_need_process_groups_wait_for_the_distributed_slice(shape, names):
    with pytest.raises(NotImplementedError, match="distributed slice"):
        dist.ProcessMesh(shape=shape, dim_names=names)


@pytest.mark.parametrize("impl", ["flash", "composed"])
def test_ring_refuses_what_it_does_not_compute(impl):
    q, k, v, _ = (torch.from_numpy(a) for a in _draw(5, 1, 30, 4, 2, 8))
    with pytest.raises(ValueError, match="divide evenly"):
        SCHEDULES[impl](q, k, v, P, True)            # 30 % 4
    q, k, v, _ = (torch.from_numpy(a) for a in _draw(5, 1, 32, 3, 2, 8))
    with pytest.raises(ValueError, match="GQA"):
        SCHEDULES[impl](q, k, v, P, True)
