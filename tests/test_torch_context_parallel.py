"""PyTorch port: context parallelism across processes (the ring's K/V and
dK/dV over ``torch.distributed``, Ulysses' all-to-all, ``SegmentParallel``,
``sep`` beside the data, sharding, tensor and pipe axes), held against the
reference on the conftest's CPU mesh.

One launch of 4 ranks of ``tests/torch_dist_worker.py`` through the port's
launcher feeds every tier-1 test (cases ``cp_ring``, ``cp_ulysses``,
``cp_llama``, ``cp_axes``); the reference's side runs in this process
meanwhile. Each rank of a ``sep`` axis holds S / P positions:

- the ring at P 2 (a mesh ``[2, 2]`` over ``["d0", "sep"]``: two
  independent rings) and P 4 (the ``cp`` axis), causal or not, Hk 1 / 2 /
  4, on the flash schedule over the kernels' plain versions and on the
  composed ring: output, dQ, dK, dV against the reference's composed ring
  under ``shard_map`` over a 4-device ``cp`` axis
  (``test_torch_ring_attention._reference_ring``, that file's tolerances:
  2e-5 / 5e-5 absolute), and against the port's one-process ring on the
  same rank's rows: bit for bit on the flash schedule (a rank runs its
  one-process steps in their order), to f32 rounding on the composed ring
  (autograd sums a K/V shard's gradients through its hops in another
  order than through the one-process ring's rolls, 1e-6); the bytes sent a
  call, exactly as the schedule reckons them;
- Ulysses: the exchange and its inverse are identities on the gathered
  tensor (bit for bit), its backward too; Ulysses attention equals full
  attention (the plain flash over the whole inputs, 2e-5 / 5e-5); heads
  that do not divide raise ValueError naming them;
- the reference's tiny ring config (``tests/test_distributed.py:263-270``)
  under ``context_parallel="ring"`` and ``"ulysses"`` at ``sep`` 2 and 4,
  dp 2 x sep 2 (fleet: ``SegmentParallel``), sharding 2 x sep 2
  (``parallelize``, stage 1), sep 2 x tensor 2 (``parallelize``,
  ``mp_config``) and pp 2 x sep 2 (``PipelineParallel`` over the Llama's
  stages), held against the reference's one-device model: the loss (rtol
  1e-5, the reference's own ring test holds 2e-3), every gradient within
  1e-5 of its leaf's largest entry (f32 sums in another order), two
  ``TrainStep`` calls (``train_batch`` at pp) with AdamW 0.01: losses rtol
  2e-5, parameters within 2e-5 of each tensor's largest entry. Ulysses
  runs where the mesh's head cut divides H 4 and Hk 2; at sep 4 and at sep
  2 x tensor 2 it raises. A planted fault, RoPE without the rank's offset,
  fails the gradient check;
- the meshes and fleet's topology that now build, and the ``ep`` axis
  (which the expert-parallel slice brought).

The 8-rank sep 4 x tensor 2 case runs in the slow tier; its tier-1
sibling is ``test_tiny_llama_matches_the_reference[sep_tensor-ring]``.
"""

import functools

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed.mesh import set_mesh
from paddle_tpu.models import llama as ref
from paddle_tpu.tensor import Tensor
from test_torch_ring_attention import ATOL, GRAD_ATOL, _reference_ring

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-5
TRAIN_RTOL, PARAM_FRAC = 2e-5, 2e-5
COMPOSED_ATOL = 1e-6
FAULT_MIN = 1e-3            # the planted fault's worst leaf, far past GRAD_FRAC
RINGS = [(P, sched, causal, hk) for P in (2, 4) for sched in ("flash", "composed")
         for causal in (True, False) for hk in (1, 2, 4)]
RING_IDS = [f"P{P}-{s}-{'causal' if c else 'full'}-hk{h}" for P, s, c, h in RINGS]
LLAMAS = [("sep2", "ring"), ("sep4", "ring"), ("dp_sep", "ring"), ("sharding_sep", "ring"),
          ("sep_tensor", "ring"), ("pp_sep", "ring"), ("sep2", "ulysses"),
          ("dp_sep", "ulysses"), ("sharding_sep", "ulysses"), ("pp_sep", "ulysses")]
LLAMA_IDS = [f"{k}-{cp}" for k, cp in LLAMAS]
REFUSED = [("sep4", "ulysses"), ("sep_tensor", "ulysses")]


def _batch():
    rng = np.random.RandomState(0)
    return rng.randint(0, 64, (2, 32)).astype(np.int64), rng.randint(0, 64, (2, 32)).astype(np.int64)


def _make_reference():
    paddle.seed(7)
    return ref.LlamaForCausalLM(ref.LlamaConfig(**W.TINY_RING))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cpref")
    set_mesh(None)
    model = _make_reference()
    np.savez(tmp / "tiny.npz", **{k: np.asarray(v._data) for k, v in model.state_dict().items()})
    ids, labels = _batch()
    np.savez(tmp / "tok.npz", ids=ids, labels=labels)
    ring = {}
    for causal in (True, False):
        for hk in (1, 2, 4):
            (q, k, v, do), _, _ = _reference_ring(causal, hk)
            for name, a in zip(("q", "k", "v", "do"), (q, k, v, do)):
                ring[f"{name}_{int(causal)}_{hk}"] = a
    np.savez(tmp / "ring.npz", **ring)
    return {k: str(tmp / f"{k}.npz") for k in ("tiny", "tok", "ring")}


@pytest.fixture(scope="module")
def launched(files, tmp_path_factory):
    f = files
    spec = [["cp_axes"], ["cp_ring", f["ring"]], ["cp_ulysses", f["ring"]]]
    spec += [["cp_llama", f["tiny"], f["tok"], kind, cp] for kind, cp in LLAMAS + REFUSED]
    spec += [["cp_llama", f["tiny"], f["tok"], "sep2", "ring", 1]]
    return W.Launch(str(tmp_path_factory.mktemp("cp4")), 4, spec)


@pytest.fixture(scope="module")
def reference(files, launched):
    """The reference's side, computed while the ranks run: the rings, and
    the one-device model's loss, gradients and two-step trajectory."""
    from paddle_tpu.jit.training import TrainStep

    set_mesh(None)
    out = {"rings": {(c, h): _reference_ring(c, h) for c in (True, False) for h in (1, 2, 4)}}
    model = _make_reference()
    ids, labels = _batch()
    loss, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    out["loss"] = float(loss.numpy())
    out["grads"] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    model = _make_reference()
    opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters())
    step = TrainStep(model, opt, lambda x, y: model(x, labels=y)[0])
    out["losses"] = [float(step(Tensor(ids), Tensor(labels))._data) for _ in range(2)]
    out["params"] = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    set_mesh(None)
    return out


@pytest.fixture(scope="module")
def cp4(launched, reference):
    return str(launched)


@functools.lru_cache(maxsize=None)
def _load(tmp, name):
    return W.load(tmp, name, 4)


def _rank_rows(P, rank, n_seq=32):
    """The positions of ``rank``'s sep coordinate (P 2: ranks 2 and 3 repeat
    0 and 1 on the other d0 replica)."""
    r = rank % P
    n = n_seq // P
    return slice(r * n, (r + 1) * n)


def _frac(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


# ---------------------------------------------------------------------------
# the ring across processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,sched,causal,hk", RINGS, ids=RING_IDS)
def test_ring_across_processes_matches_the_reference(cp4, reference, P, sched, causal, hk):
    _, want, want_grads = reference["rings"][(causal, hk)]
    tag = f"{P}_{sched}_{int(causal)}_{hk}"
    for rank, got in enumerate(_load(cp4, "cp_ring")):
        rows = _rank_rows(P, rank)
        np.testing.assert_allclose(got[f"out_{tag}"], want[:, rows], atol=ATOL)
        for name, w in zip("qkv", want_grads):
            np.testing.assert_allclose(got[f"d{name}_{tag}"], w[:, rows], atol=GRAD_ATOL,
                                       err_msg=f"rank {rank} d{name}")


@pytest.mark.parametrize("P,sched,causal,hk", RINGS, ids=RING_IDS)
def test_ring_across_processes_is_the_one_process_ring(cp4, P, sched, causal, hk):
    """Bit for bit on the flash schedule; the composed ring to f32
    rounding (see the module docstring)."""
    tag = f"{P}_{sched}_{int(causal)}_{hk}"
    for rank, got in enumerate(_load(cp4, "cp_ring")):
        for key in ("out", "dq", "dk", "dv"):
            a, b = got[f"{key}_{tag}"], got[f"one_{key}_{tag}"]
            if sched == "flash":
                np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {key}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=COMPOSED_ATOL,
                                           err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("P", [2, 4])
def test_the_ring_sends_what_its_schedule_reckons(cp4, P):
    """The flash schedule a call: K and V (P - 1 hops forward, P - 1 in the
    backward) at their grouped heads, f32 dK and dV P hops; the composed
    ring K/V P - 1 hops forward and their gradients P - 1 hops back."""
    for causal in (True, False):
        for hk in (1, 2, 4):
            kv = 2 * (32 // P) * hk * 8 * 4           # one shard of K or V, f32 bytes
            flash = 2 * kv * (P - 1) * 2 + 2 * kv * P
            composed = 2 * kv * (P - 1) * 2
            for got in _load(cp4, "cp_ring"):
                assert int(got[f"sent_{P}_flash_{int(causal)}_{hk}"]) == flash
                assert int(got[f"sent_{P}_composed_{int(causal)}_{hk}"]) == composed


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_ulysses_exchange_and_its_inverse_are_identities(cp4, P):
    """Also split_sequence: this rank's positions, its backward the
    gathered cotangent (every rank's ones summed into the whole)."""
    for got in _load(cp4, "cp_ulysses"):
        assert bool(got[f"exchange_{P}"]) and bool(got[f"inverse_{P}"])
        assert bool(got[f"exchange_grad_{P}"]) and bool(got[f"split_{P}"])


@pytest.mark.parametrize("P,hk", [(2, 4), (2, 2), (4, 4)])
def test_ulysses_attention_equals_full_attention(cp4, P, hk):
    for rank, got in enumerate(_load(cp4, "cp_ulysses")):
        np.testing.assert_allclose(got[f"out_{P}_{hk}"], got[f"full_{P}_{hk}"], atol=ATOL)
        for name in "qkv":
            np.testing.assert_allclose(got[f"d{name}_{P}_{hk}"], got[f"full_d{name}_{P}_{hk}"],
                                       atol=GRAD_ATOL, err_msg=f"rank {rank} d{name}")


def test_ulysses_refuses_heads_that_do_not_divide(cp4):
    for got in _load(cp4, "cp_ulysses"):
        msg = str(got["refused_4_2"])
        assert "num_kv_heads 2" in msg and "4 sep ranks" in msg, msg
    for kind, cp in REFUSED:
        for got in _load(cp4, f"cp_llama_{kind}_{cp}_0"):
            assert "num_kv_heads" in str(got["refused"]), got["refused"]


# ---------------------------------------------------------------------------
# the tiny Llama on every mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,cp", LLAMAS, ids=LLAMA_IDS)
def test_tiny_llama_matches_the_reference(cp4, reference, kind, cp):
    """The loss (every rank's, the mean over the data ranks) and every
    reduced gradient, whole, against the reference's one-device model."""
    got = _load(cp4, f"cp_llama_{kind}_{cp}_0")
    losses = [float(g["loss"]) for g in got]
    np.testing.assert_allclose(np.mean(losses), reference["loss"], rtol=LOSS_RTOL)
    if kind not in ("dp_sep", "sharding_sep"):
        np.testing.assert_allclose(losses, reference["loss"], rtol=LOSS_RTOL)
    for rank, g in enumerate(got):
        grads = {k[len("grad/"):]: v for k, v in g.items() if k.startswith("grad/")}
        assert sorted(grads) == sorted(reference["grads"]), rank
        for n, want in reference["grads"].items():
            assert _frac(grads[n], want) <= GRAD_FRAC, (rank, n, _frac(grads[n], want))
    if kind == "dp_sep":
        assert str(got[0]["mode"]) == "segment_parallel"
        assert str(got[0]["wrapped"]) == "SegmentParallel"


@pytest.mark.parametrize("kind,cp", LLAMAS, ids=LLAMA_IDS)
def test_tiny_llama_two_train_steps_follow_the_reference(cp4, reference, kind, cp):
    got = _load(cp4, f"cp_llama_{kind}_{cp}_0")
    mean = np.mean([g["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean, reference["losses"], rtol=TRAIN_RTOL)
    assert reference["losses"][1] < reference["losses"][0]
    for rank, g in enumerate(got):
        for n, want in reference["params"].items():
            assert _frac(g[f"param/{n}"], want) <= PARAM_FRAC, (rank, n)


def test_rope_without_the_ranks_offset_fails_the_gradient_check(cp4, reference):
    """The planted fault: every rank rotating its positions as if they
    began the sequence."""
    worst = 0.0
    for g in _load(cp4, "cp_llama_sep2_ring_1"):
        for n, want in reference["grads"].items():
            worst = max(worst, _frac(g[f"grad/{n}"], want))
    assert worst > FAULT_MIN, worst


def test_pipeline_sends_each_ranks_positions(cp4):
    """pp 2 x sep 2 under Ulysses (whose exchange sends nothing point to
    point), 2 microbatches of one row: a rank sends its 16 of 32 positions
    of a [1, 32, 32] f32 activation (stage 0) or its cotangent (stage 1) a
    microbatch, exactly; under the ring the K/V hops come on top."""
    for ring, uly in zip(_load(cp4, "cp_llama_pp_sep_ring_0"),
                         _load(cp4, "cp_llama_pp_sep_ulysses_0")):
        assert int(uly["sent"]) == 2 * 16 * 32 * 4, uly["sent"]
        assert int(ring["sent"]) > int(uly["sent"])


# ---------------------------------------------------------------------------
# meshes, fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sep_dp", "sep_sharding", "sep_fsdp", "sep_mp", "pipe_sep",
                                  "cp"])
def test_the_context_axes_build(cp4, case):
    """sep beside dp, sharding, fsdp, the tensor axis and the pipe axis, and
    the cp axis, build over 4 ranks: each rank's context group holds the
    ranks of its other coordinates, in coordinate order."""
    for rank, got in enumerate(_load(cp4, "cp_axes")):
        row = list(got[case])
        if case == "cp":
            assert row == [4, 0, 1, 2, 3, rank]
        elif case == "sep_mp":
            q = rank % 2
            assert row == [2, 2, q, q + 2, rank // 2], row
        else:
            p = rank // 2
            assert row == [2, 2, 2 * p, 2 * p + 1, rank % 2], row


def test_fleet_at_sep_degree_2_is_segment_parallel(cp4):
    for rank, got in enumerate(_load(cp4, "cp_axes")):
        mode, size, r, sep, dp, wrapped, name = list(got["fleet"])
        assert (mode, size, int(r)) == ("segment_parallel", "2", rank % 2)
        assert sep == str([rank - rank % 2, rank - rank % 2 + 1])
        assert dp == str([rank % 2, rank % 2 + 2])
        assert wrapped == "True" and name == "SegmentParallel"
        assert list(got["ep"]) == [4, 0, 1, 2, 3]           # the ep axis builds


@pytest.mark.parametrize("neox", [True, False])
def test_rope_at_an_offset_is_the_global_ropes_slice(neox):
    """A rank's RoPE at its first global position equals those positions of
    the RoPE over the whole sequence, bit for bit (the angles are the same
    f32 products)."""
    import torch

    from paddle_tpu_torch.incubate.nn.functional import fused_rotary_position_embedding as rope

    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 4, 8).astype(np.float32))
    (whole,) = rope(x, use_neox_rotary_style=neox)[:1]
    for r in range(4):
        (part,) = rope(x[:, 8 * r:8 * r + 8], use_neox_rotary_style=neox,
                       _position_offset=8 * r)[:1]
        assert torch.equal(part, whole[:, 8 * r:8 * r + 8]), r


def test_a_context_axis_in_one_process_is_the_one_process_ring():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import context_link
    from paddle_tpu_torch.distributed.mesh import context_axes

    mesh = dist.ProcessMesh(shape=[2, 4], dim_names=["dp", "sep"])
    assert context_axes(mesh) == () and context_link("sep", mesh) is None


@pytest.mark.slow
def test_tiny_llama_at_sep4_by_tensor2(files, reference, tmp_path_factory):
    """8 ranks, sep 4 x tensor 2, the ring (tier-1 sibling:
    test_tiny_llama_matches_the_reference[sep_tensor-ring])."""
    tmp = str(tmp_path_factory.mktemp("cp8"))
    rc, logs = W.run_ranks(tmp, 8, [["cp_llama", files["tiny"], files["tok"], "sep4_tensor",
                                     "ring"]])
    assert rc == 0, logs
    for rank, g in enumerate(W.load(tmp, "cp_llama_sep4_tensor_ring_0", 8)):
        np.testing.assert_allclose(float(g["loss"]), reference["loss"], rtol=LOSS_RTOL)
        for n, want in reference["grads"].items():
            assert _frac(g[f"grad/{n}"], want) <= GRAD_FRAC, (rank, n)
