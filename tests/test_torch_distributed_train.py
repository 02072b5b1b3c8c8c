"""PyTorch port: data parallelism, the ZeRO stages, the partitioning tier,
fleet and sharded checkpoints over gloo processes, held against the
reference on the conftest's CPU mesh.

The reference builds the models from a seed (its ``_MLP`` of
``tests/test_sharding_stages.py:26-37``, ``LlamaConfig.tiny()`` in f32);
their weights go to ``tmp_path`` as one ``.npz`` that every rank of the
port loads. Ranks run ``tests/torch_dist_worker.py`` (port only) through
the port's launcher: 2 ranks for ``DataParallel``, fleet's gradient merge
and a checkpoint saved at fsdp 2; 4 ranks for the ZeRO stages, the
partitioned Llama at dp 2 x fsdp 2 and that checkpoint loaded at fsdp 4;
1 rank for it loaded whole. The reference runs in this process:
``TrainStep`` on the full batch, the stage runs of
``tests/test_sharding_stages.py`` over 4 devices, ``PartitionedTrainStep``
over ``build_program_mesh(dp=2, fsdp=2)``, its checkpoints.

Tolerances, where used: the port's ranks sum the same f32 terms in
another order than one process or GSPMD does.
"""

import os

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed.mesh import ProcessMesh, build_program_mesh, set_mesh
from paddle_tpu.jit.training import TrainStep
from paddle_tpu.nn import functional as RF
from paddle_tpu.tensor import Tensor
from test_sharding_stages import _MLP, _data

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# losses: f32 sums in another order through a few layers
LOSS_RTOL = 2e-5
# gradients of a mean loss: 1e-5 of the tensor's largest entry
GRAD_FRAC = 1e-5
# AdamW moves a weight by up to lr a step; the bulk of each tensor agrees
# to f32 rounding of those steps, and an element whose gradient sits near
# 0 takes lr * g / (|g| + eps), which magnifies a rounding difference of g:
# at most OUTLIERS elements of a tensor (2, or 2e-4 of it) may differ by
# more than PARAM_ATOL, none by more than a fifth of lr (OUTLIER_LR_FRAC)
PARAM_ATOL, OUTLIER_LR_FRAC = 2e-6, 0.2
LLAMA_LR, LLAMA_CLIP, MLP_LR = 1e-3, 0.5, 0.01


def _outliers(n):
    return max(2, int(2e-4 * n))


def close_params(got: dict, want: dict, lr: float):
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(w, np.float64))
        assert (d > PARAM_ATOL).sum() <= _outliers(d.size), (k, float(d.max()))
        assert d.max() <= OUTLIER_LR_FRAC * lr, (k, float(d.max()))


def _ref_state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    set_mesh(None)
    paddle.seed(7)
    np.savez(tmp / "mlp.npz", **_ref_state(_MLP()))
    x, y = _data()
    np.savez(tmp / "data.npz", x=x, y=y)
    from paddle_tpu.models import llama as ref

    paddle.seed(3)
    np.savez(tmp / "llama.npz", **_ref_state(ref.LlamaForCausalLM(ref.LlamaConfig.tiny())))
    rng = np.random.RandomState(11)
    tok = {}
    for i in range(3):
        t = rng.randint(0, 1024, (4, 17))
        tok[f"ids{i}"], tok[f"labels{i}"] = t[:, :-1], t[:, 1:]
    np.savez(tmp / "tok.npz", **tok)
    return {k: str(tmp / f"{k}.npz") for k in ("mlp", "data", "llama", "tok")} | {
        "ckpt": str(tmp / "ckpt")}


def _launch(tmp_path_factory, n, spec):
    tmp = str(tmp_path_factory.mktemp(f"ranks{n}"))
    rc, logs = W.run_ranks(tmp, n, spec)
    assert rc == 0, logs
    return tmp


@pytest.fixture(scope="module")
def world2(files, tmp_path_factory):
    f = files
    return _launch(tmp_path_factory, 2, [["dp", f["mlp"], f["data"]],
                                         ["fleet_merge", f["mlp"], f["data"]],
                                         ["ckpt_save", f["llama"], f["tok"], f["ckpt"]],
                                         ["partitioned_accum", f["llama"], f["tok"]]])


@pytest.fixture(scope="module")
def world4(files, world2, tmp_path_factory):
    f = files
    return _launch(tmp_path_factory, 4, [["zero", f["mlp"], f["data"]],
                                         ["fleet_sharding", f["mlp"], f["data"]],
                                         ["partitioned", f["llama"], f["tok"], 2, 2, LLAMA_CLIP],
                                         ["partitioned", f["llama"], f["tok"], 2, 2, LLAMA_CLIP,
                                          "every_layer"],
                                         ["ckpt_load", f["llama"], f["tok"], f["ckpt"]]])


def _mlp(files):
    set_mesh(None)
    model = _MLP()
    model.set_state_dict({k: Tensor(v) for k, v in np.load(files["mlp"]).items()})
    return model


def _ref_grads(model, x, y):
    loss = RF.cross_entropy(model(Tensor(x)), Tensor(y))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    model.clear_gradients()
    return grads


def _close_grads(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_FRAC * np.abs(w).max(),
                                   err_msg=k)


def test_dp_bucketed_gradients_equal_per_gradient_bits(world2):
    r = W.load(world2, "dp", 2)
    keys = [k for k in r[0] if k.startswith("bucketed.") and not k.endswith("buckets")]
    assert len(keys) == 6
    assert r[0]["bucketed.buckets"].sum() >= 2          # more than one bucket fired
    for rank in r:
        for k in keys:
            np.testing.assert_array_equal(rank[k], rank[k.replace("bucketed", "pergrad")])
            np.testing.assert_array_equal(rank[k], r[0][k])      # equal on both ranks


def test_dp_gradients_are_the_reference_full_batch_mean(files, world2):
    r = W.load(world2, "dp", 2)
    x, y = _data()
    want = _ref_grads(_mlp(files), x, y)
    _close_grads({k: r[0][f"bucketed.{k}"] for k in want}, want)


def test_dp_no_sync_then_one_synced_backward(files, world2):
    """Two micro-batches a rank, the first under no_sync: every rank ends
    with the mean over the ranks of its two gradients' sum."""
    r = W.load(world2, "dp", 2)
    x, y = _data()
    model = _mlp(files)
    total = {}
    for rank in range(2):
        rows = slice(8 * rank, 8 * rank + 8)
        for part in (slice(0, 4), slice(4, 8)):
            for k, g in _ref_grads(model, x[rows][part], y[rows][part]).items():
                total[k] = total.get(k, 0) + g / 2
        local = _ref_grads(model, x[rows][:4], y[rows][:4])
        _close_grads({k: r[rank][f"no_sync_local.{k}"] for k in local}, local)
    for rank in r:
        _close_grads({k: rank[f"no_sync.{k}"] for k in total}, total)


def test_dp_find_unused_parameters(files, world2):
    """Only rank 0 reaches ``fc_extra``: every gradient is the mean of the
    two ranks' local ones, ``fc_extra``'s half of rank 0's (the port's own
    model in this process, one rank at a time)."""
    import torch

    from paddle_tpu_torch.nn import functional as PF

    r = W.load(world2, "dp", 2)
    x, y = _data()
    want = {}
    for rank in range(2):
        model = W._mlp(files["mlp"], extra=True)
        rows = slice(8 * rank, 8 * rank + 8)
        PF.cross_entropy(model(torch.from_numpy(x[rows]), use_extra=rank == 0),
                         torch.from_numpy(y[rows]).long()).backward()
        for k, p in model.named_parameters():
            g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
            want[k] = want.get(k, 0) + g / 2
    for rank in r:
        _close_grads({k: rank[f"unused.{k}"] for k in want}, want)
    np.testing.assert_array_equal(r[0]["unused.fc_extra.weight"], r[1]["unused.fc_extra.weight"])


def test_dp_step_matches_the_reference_step(files, world2):
    """One eager AdamW step, each rank on half the batch, against the
    reference's step on the whole batch (its DataParallel is the sharded
    batch of one program)."""
    r = W.load(world2, "dp", 2)
    model = _mlp(files)
    opt = paddle.optimizer.AdamW(learning_rate=MLP_LR, parameters=model.parameters())
    x, y = _data()
    loss = RF.cross_entropy(model(Tensor(x)), Tensor(y))
    loss.backward()
    opt.step()
    close_params({k: r[0][f"step1.{k}"] for k in _ref_state(model)}, _ref_state(model), MLP_LR)
    np.testing.assert_allclose((r[0]["loss"] + r[1]["loss"]) / 2, float(loss.numpy()),
                               rtol=LOSS_RTOL)


def test_sampler_defaults_to_the_world(world2):
    r = W.load(world2, "dp", 2)
    x, _ = _data()
    for rank in range(2):
        np.testing.assert_array_equal(r[rank]["shard_dataloader_x"], x[8 * rank:8 * rank + 8])
        np.testing.assert_array_equal(r[rank]["sampler"], np.arange(rank, 10, 2))
        np.testing.assert_array_equal(r[rank]["sampler_world"], [2, rank])


def _ref_stage(stage, n=4, steps=4):
    """The reference's stage run (``test_sharding_stages._run``) over n
    devices."""
    from paddle_tpu.distributed.parallelize import parallelize

    set_mesh(None)
    paddle.seed(7)
    model = _MLP()
    opt = paddle.optimizer.AdamW(learning_rate=MLP_LR, parameters=model.parameters())
    if stage:
        parallelize(model, opt, mesh=ProcessMesh(shape=[n], dim_names=["sharding"]),
                    config={"sharding_config": {"stage": stage}})
    step = TrainStep(model, opt, lambda a, b: RF.cross_entropy(model(a), b))
    x, y = _data()
    losses = [float(step(Tensor(x), Tensor(y))._data) for _ in range(steps)]
    set_mesh(None)
    return losses, _ref_state(model)


@pytest.mark.parametrize("stage", ["1", "2", "3", "eager"])
def test_zero_stages_match_the_reference(world4, stage):
    """4 steps over 4 ranks (a quarter of the batch each) against the
    reference's run of the same stage over 4 devices (the eager loop
    through group_sharded_parallel's stage 3 against its stage 3)."""
    got = W.load(world4, "zero", 4)[0]
    losses, state = _ref_stage(3 if stage == "eager" else int(stage))
    np.testing.assert_allclose(got[f"stage{stage}.losses"], losses, rtol=LOSS_RTOL)
    close_params({k: got[f"stage{stage}.{k}"] for k in state}, state, MLP_LR)


@pytest.mark.parametrize("stage", ["1", "2", "3"])
def test_zero_resting_bytes(world4, stage):
    """Stage 3: parameters and moments a quarter of the whole on every
    rank; stages 1 and 2: the moments only (AdamW's m and v)."""
    for rank in W.load(world4, "zero", 4):
        whole = int(rank["full_bytes"])
        params = whole // 4 if stage == "3" else whole
        assert int(rank[f"stage{stage}.param_bytes"]) == params
        assert int(rank[f"stage{stage}.moment_bytes"]) == 2 * whole // 4


def test_fleet_sharding_stages_and_the_saved_model(world4):
    """fleet.init at sharding_degree 4 with sharding_configs stage 3:
    distributed_model / distributed_optimizer and the eager loop against
    the reference's stage 3 run; DygraphShardingOptimizer against its stage
    1; save_group_sharded_model writes the whole parameters; and
    shard_optimizer_state cuts a state tensor of the parameter's shape to
    the rank's rows."""
    import torch

    from paddle_tpu_torch.framework.io import load

    got = W.load(world4, "fleet_sharding", 4)
    for stage in (3, 1):
        losses, state = _ref_stage(stage)
        np.testing.assert_allclose(got[0][f"stage{stage}.losses"], losses, rtol=LOSS_RTOL)
        assert int(got[0][f"stage{stage}.stage"]) == stage
        if stage == 3:
            saved = {k: np.asarray(v) for k, v in load(os.path.join(world4, "gsm.pdmodel")).items()}
            close_params(saved, state, MLP_LR)
            opt = load(os.path.join(world4, "gsm.pdopt"))
            assert tuple(opt["states"]["param_0"]["m"].shape) == state["fc1.weight"].shape
    full = torch.arange(16.0 * 3).reshape(16, 3).numpy()
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["shard_optimizer_state"], full[4 * rank:4 * rank + 4])


def _ref_partitioned(files, clip, **axes):
    """The reference's PartitionedTrainStep over ``build_program_mesh(**axes)``
    with the global-norm clip ``clip``, 3 steps: (losses, parameters)."""
    from paddle_tpu.distributed.partitioning import Partitioner, PartitionedTrainStep
    from paddle_tpu.models import llama as ref

    set_mesh(None)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny())
    model.set_state_dict({k: Tensor(v) for k, v in np.load(files["llama"]).items()})
    opt = paddle.optimizer.AdamW(learning_rate=LLAMA_LR, parameters=model.parameters(),
                                 weight_decay=0.1,
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(clip))
    step = PartitionedTrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0],
                                partitioner=Partitioner(build_program_mesh(**axes)))
    tok = np.load(files["tok"])
    losses = [float(step(Tensor(tok[f"ids{i}"]), Tensor(tok[f"labels{i}"]))._data)
              for i in range(3)]
    set_mesh(None)
    return losses, _ref_state(model)


@pytest.fixture(scope="module")
def ref_partitioned(files):
    """The reference over dp 2 x fsdp 2, the clip at LLAMA_CLIP."""
    return _ref_partitioned(files, LLAMA_CLIP, dp=2, fsdp=2)


def test_partitioned_llama_matches_the_reference(world4, ref_partitioned):
    losses, state = ref_partitioned
    for rank in W.load(world4, "partitioned_2x2_none", 4):
        np.testing.assert_allclose(rank["losses"], losses, rtol=LOSS_RTOL)
        close_params({k: rank[f"param.{k}"] for k in state}, state, LLAMA_LR)


def test_partitioned_clip_and_resting_bytes(world4, files):
    """The global-norm clip scaled every step (its norm summed over the
    fsdp slices before the root), and a rank holds half of every
    parameter cut over fsdp = 2 (the norms whole) and its moments."""
    tiny = {k: v for k, v in np.load(files["llama"]).items()}
    whole = sum(v.nbytes for v in tiny.values())
    norms = sum(v.nbytes for k, v in tiny.items() if "norm" in k)
    for rank in W.load(world4, "partitioned_2x2_none", 4):
        assert (rank["clip_scales"] < 1).all() and (rank["clip_scales"] > 0).all()
        assert int(rank["param_bytes"]) == (whole - norms) // 2 + norms
        assert int(rank["moment_bytes"]) == 2 * int(rank["param_bytes"])


def test_partitioned_numerics_are_the_global_steps(world4, files):
    """The numerics plane under PartitionedTrainStep at dp 2 x fsdp 2: every
    rank publishes the same loss (the returned global mean), grad norm,
    digest and nonfinite count each step, as the reference's one program
    does: the sentinels read the reduced gradients, their statistics summed
    over the fsdp slices. Step 0's digest is that of the first batch's
    reduced gradients gathered whole, its norm theirs (1e-6: f32 sums
    against f64); the norms are the clip's (1e-5) and those of the port's
    one-process TrainStep on the whole batches (1e-5: the same f32 sums in
    another order, and parameters that differ by that rounding after a
    step), the losses that step's (LOSS_RTOL)."""
    from paddle_tpu_torch.jit import TrainStep as PortTrainStep

    tok = np.load(files["tok"])
    model = W._llama(files["llama"])
    opt = W.paddle.optimizer.AdamW(learning_rate=LLAMA_LR, parameters=model.parameters(),
                                   weight_decay=0.1,
                                   grad_clip=W.paddle.nn.ClipGradByGlobalNorm(LLAMA_CLIP))
    step = PortTrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0])
    with W.published() as pub:
        for i in range(3):
            step(W._t(tok[f"ids{i}"]), W._t(tok[f"labels{i}"]))
    one = pub.arrays()
    ranks = W.load(world4, "partitioned_2x2_none", 4)
    for rank in ranks:
        for k in ("sent_grad_norm", "sent_digest", "sent_loss", "sent_nonfinite"):
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)
        np.testing.assert_array_equal(rank["sent_loss"], rank["losses"].astype(np.float64))
        assert not rank["sent_nonfinite"].any()
        assert int(rank["sent_digest"][0]) == int(rank["reduced_digest0"])
        np.testing.assert_allclose(rank["sent_grad_norm"][0], rank["reduced_norm0"], rtol=1e-6)
        np.testing.assert_allclose(rank["sent_grad_norm"], LLAMA_CLIP / rank["clip_scales"],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["sent_grad_norm"], one["sent_grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(rank["sent_loss"], one["sent_loss"], rtol=LOSS_RTOL)


def test_partitioned_numerics_under_accumulation(world2, files):
    """PartitionedTrainStep at fsdp 2 with accumulate_steps=2: a micro-step's
    sentinels read its own gradients reduced over the ranks, as the merge
    step's do, so both ranks publish the same values every call; the norms
    are those of the port's one-process TrainStep(accumulate_steps=2) on
    the whole batches (1e-5, as above), the losses its (LOSS_RTOL)."""
    from paddle_tpu_torch.jit import TrainStep as PortTrainStep

    tok = np.load(files["tok"])
    model = W._llama(files["llama"])
    opt = W.paddle.optimizer.AdamW(learning_rate=LLAMA_LR, parameters=model.parameters(),
                                   weight_decay=0.1,
                                   grad_clip=W.paddle.nn.ClipGradByGlobalNorm(LLAMA_CLIP))
    step = PortTrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0],
                         accumulate_steps=2)
    with W.published() as pub:
        for i in (0, 1, 2, 0):
            step(W._t(tok[f"ids{i}"]), W._t(tok[f"labels{i}"]))
    one = pub.arrays()
    ranks = W.load(world2, "partitioned_accum", 2)
    for rank in ranks:
        assert len(rank["sent_grad_norm"]) == 4
        for k in ("sent_grad_norm", "sent_digest", "sent_loss", "sent_nonfinite"):
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)
        np.testing.assert_array_equal(rank["sent_loss"], rank["losses"].astype(np.float64))
        np.testing.assert_allclose(rank["sent_grad_norm"], one["sent_grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(rank["sent_loss"], one["sent_loss"], rtol=LOSS_RTOL)


def test_partitioned_recompute_gathers_again_in_the_backward(world4):
    """Under recompute_policy="every_layer" each decoder layer's gather
    runs again in the backward (2 layers, 3 steps: 6 more all-gathers),
    and the losses and parameters are those of the run without, bit for
    bit (the recomputed forward repeats the same operations)."""
    plain = W.load(world4, "partitioned_2x2_none", 4)
    remat = W.load(world4, "partitioned_2x2_every_layer", 4)
    for a, b in zip(plain, remat):
        assert int(b["all_gathers"]) == int(a["all_gathers"]) + 2 * 3
        for k in a:
            if k != "all_gathers":
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_fleet_gradient_merge_matches_the_reference(files, world2):
    """fleet.init at dp 2, distributed_model (DataParallel) and
    distributed_optimizer with gradient_merge k_steps=2 under TrainStep:
    4 calls of half micro-batches against the reference's
    TrainStep(accumulate_steps=2) on the whole micro-batches."""
    r = W.load(world2, "fleet_merge", 2)
    model = _mlp(files)
    opt = paddle.optimizer.AdamW(learning_rate=MLP_LR, parameters=model.parameters())
    step = TrainStep(model, opt, lambda a, b: RF.cross_entropy(model(a), b),
                     accumulate_steps=2)
    x, y = _data()
    losses = [float(step(Tensor(x[8 * (i % 2):8 * (i % 2) + 8]),
                         Tensor(y[8 * (i % 2):8 * (i % 2) + 8]))._data) for i in range(4)]
    np.testing.assert_allclose((r[0]["losses"] + r[1]["losses"]) / 2, losses, rtol=LOSS_RTOL)
    assert int(r[0]["step_count"]) == 2 and bool(r[0]["is_dp"])
    np.testing.assert_array_equal(r[1]["hcg"], [2, 1, 2, 1])
    close_params({k: r[0][f"param.{k}"] for k in _ref_state(model)}, _ref_state(model),
                 MLP_LR)


@pytest.mark.parametrize("world", [1, 4])
def test_checkpoint_at_fsdp2_reshards_on_load(files, world2, world4, tmp_path_factory, world):
    """Saved by 2 ranks at fsdp 2 after two steps; loaded whole into 1 rank
    and at fsdp 4 into 4 ranks, the third step continues as the unbroken
    run's."""
    out = world4 if world == 4 else _launch(
        tmp_path_factory, 1, [["ckpt_load", files["llama"], files["tok"], files["ckpt"]]])
    unbroken = W.load(world2, "ckpt_save2", 2)[0]
    got = W.load(out, f"ckpt_load{world}", world)[0]
    assert bool(got["resharded"]) and int(got["step_count"]) == 3
    np.testing.assert_allclose(got["loss3"], unbroken["loss3"], rtol=LOSS_RTOL)
    keys = [k for k in unbroken if k.startswith("param.")]
    close_params({k: got[k] for k in keys}, {k: unbroken[k] for k in keys}, LLAMA_LR)


def test_checkpoint_saving_run_matches_the_reference(files, world2):
    """The run that saves the checkpoint (2 ranks at fsdp 2, no dp axis,
    the clip at 1.0): its 3 losses and the parameters after the third step
    against the reference's PartitionedTrainStep over
    build_program_mesh(fsdp=2)."""
    losses, state = _ref_partitioned(files, 1.0, fsdp=2)
    for rank in W.load(world2, "ckpt_save2", 2):
        np.testing.assert_allclose(rank["losses"], losses, rtol=LOSS_RTOL)
        close_params({k: rank[f"param.{k}"] for k in state}, state, LLAMA_LR)


def _port_ckpt():
    from paddle_tpu_torch.distributed import checkpoint

    return checkpoint


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's save_state_dict (f32, one array sharded over 4
    devices) read by the port, whole and as a slice; the port's read by the
    reference."""
    import jax
    import torch
    from jax.sharding import NamedSharding, PartitionSpec

    from paddle_tpu.distributed import checkpoint as rckpt

    pc = _port_ckpt()
    rng = np.random.RandomState(5)
    w, b = rng.randn(8, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    mesh = ProcessMesh(shape=[4], dim_names=["dp"])
    ws = jax.device_put(w, NamedSharding(mesh.jax_mesh, PartitionSpec("dp")))
    rckpt.save_state_dict({"w": Tensor(ws), "opt": {"b": Tensor(b)}}, str(tmp_path / "ref"))
    target = {"w": torch.zeros(8, 6), "opt": {"b": torch.zeros(6)}}
    pc.load_state_dict(target, str(tmp_path / "ref"))
    np.testing.assert_array_equal(target["w"].numpy(), w)
    np.testing.assert_array_equal(target["opt"]["b"].numpy(), b)
    pc.save_state_dict({"w": torch.from_numpy(w * 2), "opt": {"b": torch.from_numpy(b)}},
                       str(tmp_path / "port"))
    back = {"w": Tensor(np.zeros((8, 6), np.float32)), "opt": {"b": Tensor(np.zeros(6, np.float32))}}
    rckpt.load_state_dict(back, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["w"]._data), w * 2)
    np.testing.assert_array_equal(np.asarray(back["opt"]["b"]._data), b)


def test_checkpoint_async_save_lands_at_the_fence(tmp_path):
    import torch

    pc = _port_ckpt()
    x = torch.arange(12.0).reshape(3, 4)
    pc.save_state_dict({"x": x}, str(tmp_path), async_save=True)
    pc.wait_async_save(str(tmp_path))
    y = {"x": torch.zeros(3, 4)}
    pc.load_state_dict(y, str(tmp_path))
    assert torch.equal(y["x"], x)


def test_checkpoint_bf16_words_and_corruption(tmp_path):
    import torch

    pc = _port_ckpt()
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    pc.save_state_dict({"x": x, "n": torch.tensor(3)}, str(tmp_path))
    y = {"x": torch.zeros(5, 7, dtype=torch.bfloat16), "n": torch.tensor(0)}
    pc.load_state_dict(y, str(tmp_path))
    assert torch.equal(y["x"].view(torch.int16), x.view(torch.int16)) and int(y["n"]) == 3
    shard = next(p for p in os.listdir(tmp_path) if p.startswith("x."))
    raw = bytearray((tmp_path / shard).read_bytes())
    raw[-3] ^= 0xFF
    (tmp_path / shard).write_bytes(bytes(raw))
    with pytest.raises(pc.CheckpointCorruptError, match="checksum"):
        pc.load_state_dict(y, str(tmp_path))
