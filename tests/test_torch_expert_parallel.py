"""PyTorch port: expert parallelism across processes (the MoE layer routed
over the global batch; experts cut over a data axis with the all-to-all
dispatch and combine, or over an axis whose ranks hold the same rows with
partial sums), held against the reference on the CPU.

The reference's ``PartitionedTrainStep`` and ``dist.parallelize`` run one
program over the global batch, so its ``MoELayer`` routes the global
``T``: the capacity, the slot positions and the load-balance loss come
from every token. The port's ranks each hold their rows; they exchange
their per-expert counts and take the same decisions.

- Routing over virtual ranks (no processes): the global logits cut into
  2, 3 (uneven) or 4 ranks' rows, each rank's :class:`GlobalView` made by
  hand; dense and sort, top-1 and top-2, binding and ample capacity. The
  kept choices and their slots equal the reference's on the global logits
  bit for bit, the gates within 1e-6 (``test_torch_moe.GATE_ATOL``: f32
  softmax), the load-balance loss within 1e-6.
- One launch of 2 gloo ranks (``tests/torch_dist_worker.py`` cases
  ``ep_axes``, ``ep_llama``, ``ep_dp``, ``ep_ckpt``): the tiny MoE Llama
  (``TINY_MOE``: 4 experts, capacity factor 0.5, so tokens drop: C 16 of
  the global 64 tokens, 8 if a rank routed its 32 alone), loss = cross
  entropy + 0.02 x the layers' aux, AdamW with the global-norm clip, under
  the partitioner at ``dp 2`` (the experts on dp: the all-to-all) and at
  ``tensor 2`` (the experts on tensor: partial sums), and under
  ``parallelize`` on ``auto_mesh(dp=2)`` and ``auto_mesh(ep=2)``, dense
  and sort, top-2 (top-1 too at dp 2, dense and sort, at tensor 2 and
  under ``parallelize`` at dp 2), and on ``auto_mesh(sharding=2)`` at
  stages 1 and 3 (every expert on every rank, its state sliced). Each layer's decisions on
  the ranks' rows, from the logits they computed, equal the reference's
  gating of those logits as one batch, bit for bit; the loss (rtol 1e-5)
  and every reduced gradient, whole (1e-5 of each leaf's largest entry:
  f32 sums in another order), against the reference's backward on the
  global batch, which the reference's ``PartitionedTrainStep`` at dp 2 on
  the conftest's CPU mesh equals (its 3 losses against its
  ``TrainStep``'s, rtol 2e-5); 3 steps: losses rtol 2e-5, parameters as
  ``test_torch_distributed_train.close_params`` (AdamW magnifies a rounding
  of a gradient near 0); the all-to-all's bytes exactly the kept rows.
- The control: every rank routing its own rows
  (``tools.dist_train.routing_alone``, the port before this slice) misses
  the reference's gradients by more than 1e-2 of a leaf's largest entry.
  Eager ``DataParallel`` routes per rank, as the reference's eager
  ``DataParallel`` does: its reduced gradients equal the mean of the
  reference's on each rank's batch (1e-5).
- A checkpoint saved at dp 2 with the experts cut loads at world 1 and,
  saved there, back at dp 2: parameters and AdamW moments bit for bit.

The 4-rank meshes (dp 2 x tensor 2, dp 2 x fsdp 2, ``auto_mesh(dp=2,
ep=2)``) run in the slow tier; their tier-1 siblings are
``test_loss_and_every_gradient_match_the_reference[tensor2-dense-2]``,
``[dp2-dense-2]`` and ``[par_ep2-dense-2]``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed.fleet import moe as rmoe
from paddle_tpu.distributed.mesh import build_program_mesh, set_mesh
from paddle_tpu.models import llama as ref
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.distributed.fleet import moe as pmoe
from test_torch_distributed_train import close_params
from test_torch_moe import GATE_ATOL

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-5
TRAIN_RTOL = 2e-5
FAULT_MIN = 1e-2
#: (kind, dispatch, top_k) of the 2-rank launch
LLAMAS = [("dp2", "dense", 2), ("dp2", "sort", 2), ("dp2", "dense", 1), ("dp2", "sort", 1),
          ("tensor2", "dense", 2), ("tensor2", "sort", 2), ("tensor2", "dense", 1),
          ("par_dp2", "dense", 2), ("par_dp2", "sort", 2), ("par_dp2", "sort", 1),
          ("par_ep2", "dense", 2), ("par_ep2", "sort", 2),
          ("par_sh2s1", "dense", 2), ("par_sh2s3", "sort", 2)]
LLAMA_IDS = [f"{k}-{d}-{t}" for k, d, t in LLAMAS]
SLOW = [("dp2_tensor2", "dense", 2), ("dp2_fsdp2", "sort", 2), ("par_dp2_ep2", "dense", 2)]
#: kind -> (data ranks, experts' axis of the plan)
DATA = {"dp2": (2, "data"), "tensor2": (1, "tensor"), "par_dp2": (2, "data"),
        "par_ep2": (1, "tensor"), "dp2_tensor2": (2, "tensor"), "dp2_fsdp2": (4, "data"),
        "par_dp2_ep2": (2, "tensor"), "par_sh2s1": (2, "whole"), "par_sh2s3": (2, "whole")}


def _batches():
    rng = np.random.RandomState(13)
    tok = {}
    for i in range(3):
        t = rng.randint(0, 64, (4, 17))
        tok[f"ids{i}"], tok[f"labels{i}"] = t[:, :-1], t[:, 1:]
    return tok


def _reference():
    paddle.seed(7)
    return ref.LlamaForCausalLM(ref.LlamaConfig(**W.TINY_MOE))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("epref")
    set_mesh(None)
    np.savez(tmp / "tiny.npz", **{k: np.asarray(v._data)
                                  for k, v in _reference().state_dict().items()})
    np.savez(tmp / "tok.npz", **_batches())
    return {"tiny": str(tmp / "tiny.npz"), "tok": str(tmp / "tok.npz"),
            "ckpt2": str(tmp / "ckpt2"), "ckpt1": str(tmp / "ckpt1")}


class _Launches:
    """Launches of ``run_ranks`` one after another in a thread, so that the
    test computes the reference's side meanwhile; ``str()`` waits for them
    and gives ``tmp``."""

    def __init__(self, tmp, launches):
        import concurrent.futures

        self.tmp = tmp
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._fut = self._pool.submit(self._run, launches)

    def _run(self, launches):
        for nproc, spec in launches:
            rc, logs = W.run_ranks(self.tmp, nproc, spec)
            if rc:
                return rc, logs
        return 0, ""

    def __str__(self):
        rc, logs = self._fut.result()
        self._pool.shutdown()
        assert rc == 0, logs
        return self.tmp


@pytest.fixture(scope="module")
def launched(files, tmp_path_factory):
    """2 ranks (the cases), then the checkpoint saved there loaded at world
    1 (and saved there), then that one loaded at dp 2."""
    f = files
    spec = [["ep_axes"], ["ep_dp", f["tiny"], f["tok"]],
            ["ep_ckpt", f["tiny"], f["tok"], "", f["ckpt2"], "save2"]]
    spec += [["ep_llama", f["tiny"], f["tok"], k, d, t] for k, d, t in LLAMAS]
    spec += [["ep_llama", f["tiny"], f["tok"], "dp2", "sort", 2, 1]]
    return _Launches(str(tmp_path_factory.mktemp("ep2")), [
        (2, spec), (1, [["ep_ckpt", f["tiny"], f["tok"], f["ckpt2"], f["ckpt1"], "load1"]]),
        (2, [["ep_ckpt", f["tiny"], f["tok"], f["ckpt1"], "", "load2"]])])


def _model(weights, top_k=2):
    model = ref.LlamaForCausalLM(ref.LlamaConfig(**W.TINY_MOE, moe_top_k=top_k))
    model.set_state_dict({k: Tensor(v) for k, v in np.load(weights).items()})
    return model


def _loss_fn(model):
    def loss(ids, labels):
        ce = model(ids, labels=labels)[0]
        return ce + W.MOE_AUX * sum(lyr.mlp.aux_loss for lyr in model.llama.layers)
    return loss


def _trajectory(weights, top_k, axes=None):
    """3 steps of the reference's TrainStep (``axes``: its
    PartitionedTrainStep over ``build_program_mesh(**axes)``)."""
    from paddle_tpu.distributed.partitioning import Partitioner, PartitionedTrainStep
    from paddle_tpu.jit.training import TrainStep

    set_mesh(None)
    model = _model(weights, top_k)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    step = (TrainStep(model, opt, _loss_fn(model)) if axes is None else
            PartitionedTrainStep(model, opt, _loss_fn(model),
                                 partitioner=Partitioner(build_program_mesh(**axes))))
    tok = _batches()
    losses = [float(step(Tensor(tok[f"ids{i}"]), Tensor(tok[f"labels{i}"]))._data)
              for i in range(3)]
    set_mesh(None)
    return losses, {k: np.asarray(v._data) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def reference(files, launched):
    """The reference's side, computed while the ranks run: per dispatch
    and top-k the loss and gradients on the global batch (dense top-2 also
    on the second batch: eager DataParallel's second rank); the 3-step
    trajectory (dense: sort takes the same decisions, its values differ in
    rounding) and the PartitionedTrainStep's at dp 2."""
    out = {}
    tok = _batches()
    for dispatch in ("dense", "sort"):
        paddle.set_flags({"moe_dispatch": dispatch})
        try:
            for top_k in (2, 1):
                for b in (0, 1) if (dispatch, top_k) == ("dense", 2) else (0,):
                    set_mesh(None)
                    model = _model(files["tiny"], top_k)
                    loss = _loss_fn(model)(paddle.to_tensor(tok[f"ids{b}"]),
                                           paddle.to_tensor(tok[f"labels{b}"]))
                    loss.backward()
                    out[dispatch, top_k, b] = {
                        "loss": float(loss.numpy()),
                        "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}
        finally:
            paddle.set_flags({"moe_dispatch": ""})
        out[dispatch, 2] = out[dispatch, 2, 0]
        out[dispatch, 1] = out[dispatch, 1, 0]
    out["traj"] = _trajectory(files["tiny"], 2)
    out["part"] = _trajectory(files["tiny"], 2, {"dp": 2})[0]
    return out


@pytest.fixture(scope="module")
def ep2(launched, reference):
    return str(launched)


@functools.lru_cache(maxsize=None)
def _load(tmp, name, n=2):
    return W.load(tmp, name, n)


def _frac(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _name(kind, dispatch, top_k, fault=0):
    return f"ep_llama_{kind}_{dispatch}_{top_k}_{fault}"


# ---------------------------------------------------------------------------
# routing over virtual ranks
# ---------------------------------------------------------------------------


def _views(lg, parts, top_k):
    """Each virtual rank's rows, ids, gates, probs and GlobalView."""
    rows = np.split(lg, np.cumsum(parts)[:-1])
    routed = [pmoe.topk_routing(torch.from_numpy(r), top_k) for r in rows]
    E = lg.shape[1]
    counts = torch.stack([torch.stack([torch.bincount(ids[k], minlength=E)
                                       for k in range(top_k)]) for ids, _, _ in routed]).float()
    proxy = torch.softmax(torch.from_numpy(lg), -1).mean(0)
    return [(torch.from_numpy(r), ids, gates, probs, pmoe.GlobalView(counts, parts, i, proxy))
            for i, (r, (ids, gates, probs)) in enumerate(zip(rows, routed))]


ROUTES = [(parts, cf, top_k, mode) for parts in ((32, 32), (20, 28, 16), (16, 16, 16, 16))
          for cf in (0.5, 2.0) for top_k in (1, 2) for mode in ("dense", "sort")]


@pytest.mark.parametrize("parts,cf,top_k,mode", ROUTES,
                         ids=[f"{'-'.join(map(str, p))}-cf{c}-top{k}-{m}"
                              for p, c, k, m in ROUTES])
def test_routing_over_ranks_is_the_references_on_the_global_batch(parts, cf, top_k, mode):
    lg = np.random.RandomState(sum(parts) + top_k).randn(sum(parts), 4).astype(np.float32)
    T, E = lg.shape
    C = max(int(cf * T * top_k / E), 4)
    gate = rmoe.top1_gating if top_k == 1 else rmoe.top2_gating
    c_r, d_r, a_r = (np.asarray(a) for a in gate(jnp.asarray(lg), C))
    start = 0
    for x, ids, gates, probs, view in _views(lg, list(parts), top_k):
        rows = slice(start, start + x.shape[0])
        start += x.shape[0]
        assert view.tokens == T
        if mode == "dense":
            c, d, a = (pmoe.top1_gating if top_k == 1 else pmoe.top2_gating)(x, C, view)
            np.testing.assert_array_equal(d.numpy(), d_r[rows])
            np.testing.assert_allclose(c.numpy(), c_r[rows], rtol=0, atol=GATE_ATOL)
        else:
            order, se, stok, cpos, valid = pmoe.sort_slots(ids, E, C, view)
            got = np.zeros_like(d_r[rows])
            got[stok[valid].numpy(), se[valid].numpy(), cpos[valid].numpy()] = True
            np.testing.assert_array_equal(got, d_r[rows])
            sg = pmoe.sort_gates(gates, order, valid)
            np.testing.assert_allclose(
                sg[valid].numpy(), c_r[rows][stok[valid], se[valid], cpos[valid]],
                rtol=0, atol=GATE_ATOL)
            a = pmoe._aux_loss(probs, ids, view)
        np.testing.assert_allclose(float(a), float(a_r), rtol=0, atol=GATE_ATOL)
    if cf == 0.5:       # the capacity binds: a choice was dropped
        assert d_r.sum() < top_k * T


# ---------------------------------------------------------------------------
# the tiny MoE Llama on 2 ranks
# ---------------------------------------------------------------------------


def _global_logits(ranks, i, kind):
    """Layer ``i``'s logits of the global batch: the data ranks' rows in
    order (the ranks of an axis that holds the same rows computed the
    same bits)."""
    n, _ = DATA[kind]
    held = [r[f"route{i}/logits"] for r in ranks]
    if n == 1:
        for h in held[1:]:
            np.testing.assert_array_equal(h, held[0])
        return held[0]
    return np.concatenate(held)


@pytest.mark.parametrize("kind,dispatch,top_k", LLAMAS, ids=LLAMA_IDS)
def test_decisions_are_the_references_on_the_global_batch(ep2, kind, dispatch, top_k):
    """Each layer's kept choices and slots on each rank's rows equal the
    reference's gating of the global logits, bit for bit (the forward of
    the first batch; 2 layers)."""
    ranks = _load(ep2, _name(kind, dispatch, top_k))
    n, experts = DATA[kind]
    assert [str(p) for p in ranks[0]["plan"]] == [experts] * 2
    assert int(ranks[0]["local_experts"]) == (4 if experts == "whole" else 2)
    for i in range(2):
        lg = _global_logits(ranks, i, kind)
        C = max(int(0.5 * lg.shape[0] * top_k / 4), 4)
        assert C == 8 * top_k
        _, d_r, _ = (rmoe.top1_gating if top_k == 1 else rmoe.top2_gating)(jnp.asarray(lg), C)
        d_r = np.asarray(d_r)
        assert d_r.sum() < top_k * lg.shape[0]         # tokens dropped
        per = lg.shape[0] // n
        for r, rank in enumerate(ranks):
            rows = slice((r % n) * per, (r % n + 1) * per)
            call = {k.split("/")[1]: v for k, v in rank.items() if k.startswith(f"route{i}/")}
            if "dense" in call:
                np.testing.assert_array_equal(call["dense"] > 0, d_r[rows])
            else:
                stok, se, cpos, valid = call["sort"]
                got = np.zeros_like(d_r[rows])
                kept = valid.astype(bool)
                got[stok[kept], se[kept], cpos[kept]] = True
                np.testing.assert_array_equal(got, d_r[rows])


@pytest.mark.parametrize("kind,dispatch,top_k", LLAMAS, ids=LLAMA_IDS)
def test_loss_and_every_gradient_match_the_reference(ep2, reference, kind, dispatch, top_k):
    want = reference[dispatch, top_k]
    ranks = _load(ep2, _name(kind, dispatch, top_k))
    np.testing.assert_allclose(np.mean([float(r["loss0"]) for r in ranks]), want["loss"],
                               rtol=LOSS_RTOL)
    for rank, g in enumerate(ranks):
        grads = {k[len("grad/"):]: v for k, v in g.items() if k.startswith("grad/")}
        assert sorted(grads) == sorted(want["grads"]), rank
        for n, w in want["grads"].items():
            assert _frac(grads[n], w) <= GRAD_FRAC, (rank, n, _frac(grads[n], w))


@pytest.mark.parametrize("kind,dispatch,top_k", [c for c in LLAMAS if c[2] == 2],
                         ids=[i for c, i in zip(LLAMAS, LLAMA_IDS) if c[2] == 2])
def test_three_steps_follow_the_reference(ep2, reference, kind, dispatch, top_k):
    losses, params = reference["traj"]
    ranks = _load(ep2, _name(kind, dispatch, top_k))
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], axis=0), losses,
                               rtol=TRAIN_RTOL)
    assert losses[2] < losses[0]
    for g in ranks:
        close_params({n: g[f"param/{n}"] for n in params}, params, 1e-3)


def test_the_references_partitioned_step_is_its_one_program(reference):
    """The reference's PartitionedTrainStep at dp 2 on its CPU mesh routes
    the global batch: its 3 losses are its TrainStep's."""
    np.testing.assert_allclose(reference["part"], reference["traj"][0], rtol=TRAIN_RTOL)


@pytest.mark.parametrize("dispatch", ["dense", "sort"])
def test_the_all_to_all_moves_exactly_the_kept_rows(ep2, dispatch):
    """At dp 2 a layer's forward and backward send each rank's kept rows to
    the experts' owners and back: 2 x (rows sent + rows received) x H x 4
    bytes a layer, the rows from the decisions."""
    ranks = _load(ep2, _name("dp2", dispatch, 2))
    for r, rank in enumerate(ranks):
        want = 0
        for i in range(2):
            sent = int(rank[f"route{i}/sort"][3].sum())
            recv = 0
            for other in ranks:
                stok, se, cpos, valid = other[f"route{i}/sort"]
                recv += int(((se // 2 == r) & (valid == 1)).sum())
            want += 2 * (sent + recv) * 32 * 4
        stats = json.loads(str(rank["stats"]))
        assert stats["bytes"]["all_to_all_single"] == want, (r, stats)
        assert stats["calls"]["all_to_all_single"] == 8


def test_per_rank_routing_fails_the_gradient_check(ep2, reference):
    """The planted fault: every rank routes its rows alone (its own C 8,
    slots from 0, its own aux means), the port before this slice."""
    worst = 0.0
    for g in _load(ep2, _name("dp2", "sort", 2, 1)):
        for n, w in reference["sort", 2]["grads"].items():
            worst = max(worst, _frac(g[f"grad/{n}"], w))
    assert worst > FAULT_MIN, worst


def test_eager_data_parallel_routes_per_rank_as_the_reference(ep2, reference):
    """Each rank's batch alone (rank r the batch r of [4, 16]), as the
    reference's eager DataParallel: the port's reduced gradients equal the
    mean of the reference's on each rank's batch."""
    per = [reference["dense", 2, b]["grads"] for b in (0, 1)]
    for g in _load(ep2, "ep_dp"):
        for n in per[0]:
            assert _frac(g[f"grad/{n}"], (per[0][n] + per[1][n]) / 2) <= GRAD_FRAC, n


def test_checkpoint_at_dp2_loads_at_world1_and_back(ep2):
    saved = _load(ep2, "ep_ckpt_save2")
    one = _load(ep2, "ep_ckpt_load1", 1)[0]
    back = _load(ep2, "ep_ckpt_load2")
    keys = [k for k in one if k.startswith(("param/", "opt/"))]
    assert any("mlp.w_up" in k for k in keys) and any(k.startswith("opt/") for k in keys)
    for k in keys:
        for got in saved + back:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    assert [str(g["plan"]) for g in saved + [one] + back] == ["True", "True", "False",
                                                              "True", "True"]
    assert bool(one["resharded"]) and all(bool(g["resharded"]) for g in back)
    assert all(int(g["count"]) == 2 for g in saved + [one] + back)
    np.testing.assert_allclose([float(g["loss3"]) for g in [one] + back],
                               float(saved[0]["loss3"]), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# meshes, the dispatch policy
# ---------------------------------------------------------------------------


def test_the_expert_axes_build(ep2):
    for rank, got in enumerate(_load(ep2, "ep_axes")):
        assert list(got["ep"]) == [2, 0, 1]
        assert list(got["dp_ep"]) == [1, 2, 0, 1, rank]
        assert list(got["moe_tensor"]) == [2, 32, 64, 1]


def test_all_to_all_single_takes_empty_splits_and_two_byte_floats(ep2):
    """Rank 0 keeps its 3 rows and takes rank 1's 2; rank 1 sends 2 and
    takes none; in bf16 over gloo."""
    r0, r1 = (g["a2a_zero"] for g in _load(ep2, "ep_axes"))
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(r0, np.concatenate([rows, rows[:2] + 10]))
    assert r1.shape == (0, 2)


def test_a_moe_llama_under_context_parallelism_raises(ep2):
    for got in _load(ep2, "ep_axes"):
        assert "context parallelism across processes" in str(got["moe_sep"]), got["moe_sep"]


def test_the_measured_dispatch_is_keyed_on_the_global_batch(ep2):
    """A layer routed over both ranks (24 and 32 tokens) probes, where the
    policy measures, the shape class of the global batch's 56 tokens (C
    35): the class the reference's one program would measure."""
    for got in _load(ep2, "ep_axes"):
        assert got["dispatch_keys"].tolist() == [[56, 4, 35]]


@pytest.mark.parametrize("kind,dispatch", [("par_sh2s1", "dense"), ("par_sh2s3", "sort")])
def test_a_sharding_stage_slices_the_experts_state(ep2, kind, dispatch):
    """Under ``parallelize`` at ``auto_mesh(sharding=2)`` no expert axis
    holds the experts: every rank runs every expert on its rows' slots of
    the global routing, and stage 1 (the optimizer state) or 3 (the weight
    at rest too) keeps half of each expert weight's AdamW moments a rank."""
    for got in _load(ep2, _name(kind, dispatch, 2)):
        assert float(got["expert_state"]) == 0.5
        assert [str(p) for p in got["plan"]] == ["whole"] * 2


def test_a_moe_beside_a_context_axis_or_the_pipe_raises():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import _sharded
    from paddle_tpu_torch.models import llama as L

    model = L.LlamaForCausalLM(L.LlamaConfig(**W.TINY_MOE), device="cpu")
    mesh = dist.ProcessMesh(shape=[1], dim_names=["dp"])
    with pytest.raises(NotImplementedError, match="pipe axis"):
        _sharded.plan_specs(model, mesh, {}, ("dp",), "tensor", partial=set())


# ---------------------------------------------------------------------------
# four ranks (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_four_rank_meshes_match_the_reference(files, reference, tmp_path_factory):
    """dp 2 x tensor 2 and dp 2 x fsdp 2 under the partitioner and
    ``auto_mesh(dp=2, ep=2)`` under parallelize (tier-1 siblings: see the
    module docstring)."""
    tmp = str(tmp_path_factory.mktemp("ep4"))
    rc, logs = W.run_ranks(tmp, 4, [["ep_llama", files["tiny"], files["tok"], k, d, t]
                                    for k, d, t in SLOW])
    assert rc == 0, logs
    for kind, dispatch, top_k in SLOW:
        want = reference[dispatch, top_k]
        ranks = W.load(tmp, _name(kind, dispatch, top_k), 4)
        assert [str(p) for p in ranks[0]["plan"]] == [DATA[kind][1]] * 2
        np.testing.assert_allclose(np.mean([float(r["loss0"]) for r in ranks]), want["loss"],
                                   rtol=LOSS_RTOL)
        for g in ranks:
            for n, w in want["grads"].items():
                assert _frac(g[f"grad/{n}"], w) <= GRAD_FRAC, (kind, n)
