"""The ranks of the port's multi-process CPU tests.

Run by ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
--log_dir DIR tests/torch_dist_worker.py OUT JSON``, JSON a list of
``[case, arg, ...]``: every rank sets the port's device to the CPU, joins a
gloo world and runs the cases in order, each writing ``OUT/<name>.<rank>.npz``
(arrays) for the test to hold against numpy and the reference. Imports only the port: the tests that launch it import the
reference, and hold what it writes.
"""

import os
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.nn import functional as F


def _save(out, case, **arrays):
    np.savez(os.path.join(out, f"{case}.{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def inputs(rank, shape=(4, 3)):
    """The collectives' input of ``rank`` (also computed by the test)."""
    return (np.random.RandomState(100 + rank).randn(*shape) + rank).astype(np.float32)


def collectives(out):
    rank, n = dist.get_rank(), dist.get_world_size()
    x = inputs(rank)
    res = {}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = _t(x.copy())
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        res[f"all_reduce_{op}"] = t
    got = []
    dist.all_gather(got, _t(x))
    res["all_gather_list"] = torch.stack(got)
    cat = torch.empty(n * 4, 3)
    dist.all_gather(cat, _t(x))
    res["all_gather_tensor"] = cat
    res["all_gather_stack"] = dist.all_gather(None, _t(x))
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    res["all_gather_object"] = np.array([o["rank"] for o in objs])
    big = inputs(rank, (n * 2, 3))
    rs = torch.empty(2, 3)
    dist.reduce_scatter(rs, _t(big))
    res["reduce_scatter_tensor"] = rs
    rs2 = torch.empty(2, 3)
    dist.reduce_scatter(rs2, [_t(big[2 * j:2 * j + 2]) for j in range(n)])
    res["reduce_scatter_list"] = rs2
    a2a = []
    dist.all_to_all(a2a, [_t(big[2 * j:2 * j + 2]) for j in range(n)])
    res["all_to_all"] = torch.cat(a2a)
    # a gloo without the list alltoall (some releases raise "Backend gloo
    # does not support alltoall"): the port never calls it on gloo
    keep = torch.distributed.all_to_all

    def refuse(*a, **k):
        raise RuntimeError("Backend gloo does not support alltoall")

    torch.distributed.all_to_all = refuse
    try:
        a2a = []
        dist.all_to_all(a2a, [_t(big[2 * j:2 * j + 2]) for j in range(n)])
    finally:
        torch.distributed.all_to_all = keep
    res["all_to_all_gloo_without_list"] = torch.cat(a2a)
    single = torch.empty(n * 2, 3)
    dist.all_to_all_single(single, _t(big))
    res["all_to_all_single"] = single
    # uneven: rank r sends j + 1 rows to rank j
    rows = sum(range(1, n + 1))
    src = inputs(rank, (rows, 3))
    got_rows = (rank + 1) * n
    uneven = torch.empty(got_rows, 3)
    dist.all_to_all_single(uneven, _t(src), out_split_sizes=[rank + 1] * n,
                           in_split_sizes=list(range(1, n + 1)))
    res["all_to_all_uneven"] = uneven
    b = _t(x.copy())
    dist.broadcast(b, src=1)
    res["broadcast"] = b
    box = [f"from {rank}"]
    dist.broadcast_object_list(box, src=n - 1)
    res["broadcast_object"] = np.array(box[0])
    r = _t(x.copy())
    dist.reduce(r, dst=1)
    res["reduce_dst1"] = r
    sc = torch.empty(4, 3)
    dist.scatter(sc, [_t(inputs(10 + j)) for j in range(n)] if rank == 0 else None, src=0)
    res["scatter"] = sc
    gl = []
    dist.gather(_t(x), gl, dst=0)
    res["gather"] = torch.stack(gl) if rank == 0 else torch.zeros(0)
    # point to point: a ring, both ways
    nxt, prv = (rank + 1) % n, (rank - 1) % n
    recv = torch.empty(4, 3)
    tasks = dist.batch_isend_irecv([dist.P2POp(dist.isend, _t(x), nxt),
                                    dist.P2POp(dist.irecv, recv, prv)])
    for task in tasks:
        task.wait()
    res["batch_isend_irecv"] = recv
    recv2 = torch.empty(4, 3)
    if rank % 2 == 0:
        dist.send(_t(x), dst=nxt)
        dist.recv(recv2, src=prv)
    else:
        dist.recv(recv2, src=prv)
        dist.send(_t(x), dst=nxt)
    res["send_recv"] = recv2
    task = dist.all_reduce(_t(x.copy()), sync_op=False)
    task.wait()
    # subsets: the first and last rank; the halves
    pair = dist.new_group([0, n - 1])
    t = _t(x.copy())
    if rank in (0, n - 1):
        dist.all_reduce(t, group=pair)
    else:
        try:
            dist.all_reduce(t, group=pair)
            raise AssertionError("a rank outside the group ran its collective")
        except ValueError:
            pass
    res["new_group_pair"] = t
    half = dist.split_group(split_sizes=[n // 2, n - n // 2])
    t = _t(x.copy())
    dist.all_reduce(t, group=half)
    res["split_group"] = t
    res["split_group_ranks"] = np.array(half.ranks)
    tree = {"a": _t(x), "b": [_t(x.astype(np.float64) * 2), _t(np.arange(3.0, dtype=np.float32))]}
    fused = dist.fused_allreduce(tree)
    res["fused_a"], res["fused_b0"], res["fused_b1"] = fused["a"], fused["b"][0], fused["b"][1]
    res["fused_b0_dtype"] = np.array(str(fused["b"][0].dtype))
    dist.barrier()
    stats = C.stats()
    res.update(tensor_axes(n))
    res.update(pipe_axes(n))
    res["stat_kinds"] = np.array(sorted(stats["calls"]))
    res["stat_fused_calls"] = np.array(stats["calls"]["fused_allreduce"])
    _save(out, "collectives", **res)


def tensor_axes(n):
    """The tensor axes build over the world: a mesh's ``tensor`` / ``mp``
    group, the program mesh's, fleet's topology's model group, and a Llama
    with sequence parallelism."""
    from paddle_tpu_torch.distributed.fleet import topology
    from paddle_tpu_torch.models import llama

    out = {}
    for name in ("tensor", "mp"):
        mesh = dist.ProcessMesh(shape=[n], dim_names=[name])
        out[f"axis_{name}"] = np.array(mesh.shape + mesh.get_group(name).ranks)
    mesh = dist.build_program_mesh(fsdp=n // 2, tensor=2)
    out["axis_program_tensor"] = np.array(mesh.shape + mesh.get_group("tensor").ranks)
    hcg = topology.HybridCommunicateGroup(topology.CommunicateTopology(dims=[n // 2, 1, 1, 1, 2]))
    out["axis_topology_mp"] = np.array([
        hcg.get_model_parallel_world_size(), hcg.get_model_parallel_rank(),
        hcg.get_model_parallel_group_src_rank(), *hcg.get_model_parallel_group().ranks,
        hcg.get_parallel_mode() == "model_parallel"])
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(sequence_parallel=True), device="cpu")
    out["axis_llama_sep"] = np.array([model.config.sequence_parallel, model.num_params()])
    return out


def pipe_axes(n):
    """The pipe axes build over the world: a mesh's ``pipe`` / ``pp`` axis,
    its stage group and stage order, and the program mesh's at dp x pipe."""
    out = {}
    for name in ("pipe", "pp"):
        mesh = dist.ProcessMesh(shape=[n], dim_names=[name])
        out[f"axis_{name}"] = np.array(mesh.shape + mesh.get_group(name).ranks
                                       + mesh.axis_ranks(name))
    mesh = dist.build_program_mesh(dp=n // 2, pipe=2)
    out["axis_program_pipe"] = np.array(mesh.shape + mesh.get_group("pipe").ranks
                                        + mesh.get_group("dp").ranks)
    return out


class MLP(paddle.nn.Layer):
    """The reference's ``tests/test_sharding_stages.py:26-37`` MLP."""

    def __init__(self, extra=False):
        super().__init__()
        self.fc1 = paddle.nn.Linear(16, 64, device="cpu")
        self.fc2 = paddle.nn.Linear(64, 32, device="cpu")
        self.fc3 = paddle.nn.Linear(32, 8, device="cpu")
        self.fc_extra = paddle.nn.Linear(32, 8, device="cpu") if extra else None

    def forward(self, x, use_extra=False):
        h = F.relu(self.fc2(F.relu(self.fc1(x))))
        out = self.fc3(h)
        if use_extra:
            out = out + self.fc_extra(h)
        return out


def _mlp(weights, extra=False):
    model = MLP(extra)
    state = {k: v for k, v in np.load(weights).items()}
    if extra:
        state["fc_extra.weight"] = state["fc3.weight"] * 0.5
        state["fc_extra.bias"] = state["fc3.bias"] + 0.1
    missing, _ = model.set_state_dict(state)
    assert not missing, missing
    return model


def _grads(model):
    inner = model._layers if isinstance(model, dist.DataParallel) else model
    return {n: p.grad.clone() for n, p in inner.named_parameters() if p.grad is not None}


def dp(out, weights, data):
    """DataParallel over 2 ranks: bucketed against per-gradient bits, no_sync,
    find_unused_parameters, one AdamW step."""
    rank, n = dist.get_rank(), dist.get_world_size()
    d = np.load(data)
    x, y = _t(d["x"]), _t(d["y"]).long()
    per = x.shape[0] // n
    xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    res = {}
    for regime in ("bucketed", "pergrad"):
        os.environ["PADDLE_DP_SYNC"] = regime
        model = dist.DataParallel(_mlp(weights), comm_buffer_size=0.004,
                                  last_comm_buffer_size=0.001)
        F.cross_entropy(model(xs), ys).backward()
        for k, g in _grads(model).items():
            res[f"{regime}.{k}"] = g
        res[f"{regime}.buckets"] = np.array([model.bucket_stats()["full"],
                                             model.bucket_stats()["tail"]])
    os.environ["PADDLE_DP_SYNC"] = "bucketed"
    # no_sync: two micro-batches, the second synced
    model = dist.DataParallel(_mlp(weights), comm_buffer_size=0.004)
    half = per // 2
    with model.no_sync():
        F.cross_entropy(model(xs[:half]), ys[:half]).backward()
    local = {k: g.clone() for k, g in _grads(model).items()}
    F.cross_entropy(model(xs[half:]), ys[half:]).backward()
    for k, g in _grads(model).items():
        res[f"no_sync.{k}"] = g
        res[f"no_sync_local.{k}"] = local[k]
    # find_unused_parameters: only rank 0 reaches fc_extra
    model = dist.DataParallel(_mlp(weights, extra=True), find_unused_parameters=True)
    F.cross_entropy(model(xs, use_extra=rank == 0), ys).backward()
    for k, g in _grads(model).items():
        res[f"unused.{k}"] = g
    # one eager AdamW step, each rank on its half of the batch
    model = dist.DataParallel(_mlp(weights))
    opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters())
    loss = F.cross_entropy(model(xs), ys)
    loss.backward()
    opt.step()
    opt.clear_grad()
    for k, v in model.state_dict().items():
        res[f"step1.{k}"] = v
    res["loss"] = loss.detach()
    loader = dist.shard_dataloader([(x, y)], meshes=dist.ProcessMesh(shape=[n], dim_names=["dp"]))
    res["shard_dataloader_x"] = next(iter(loader))[0]
    sampler = paddle.io.DistributedBatchSampler(list(range(10)), batch_size=2)
    res["sampler"] = np.array([i for b in sampler for i in b])
    res["sampler_world"] = np.array([sampler.nranks, sampler.local_rank])
    _save(out, "dp", **res)


def _bytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def zero(out, weights, data):
    """ZeRO stages 1 / 2 / 3 over the world (``parallelize`` over a
    ``sharding`` axis, as the reference's test), 4 TrainStep calls; and
    stage 3 through ``group_sharded_parallel`` with the eager loop."""
    rank, n = dist.get_rank(), dist.get_world_size()
    d = np.load(data)
    x, y = _t(d["x"]), _t(d["y"]).long()
    per = x.shape[0] // n
    xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    res = {}
    mesh = dist.ProcessMesh(shape=[n], dim_names=["sharding"])
    full_bytes = None
    for stage in (1, 2, 3, "eager"):
        model = _mlp(weights)
        full_bytes = _bytes(model.parameters())
        opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters())
        if stage == "eager":
            model, opt = dist.fleet.group_sharded_parallel(model, opt, level="p_g_os")
        else:
            model, opt = dist.parallelize(model, opt, mesh=mesh,
                                          config={"sharding_config": {"stage": stage}})
        losses = []
        if stage == "eager":
            for _ in range(4):
                loss = F.cross_entropy(model(xs), ys)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.detach())
        else:
            step = paddle.jit.TrainStep(model, opt, lambda a, b: F.cross_entropy(model(a), b))
            losses = [step(xs, ys) for _ in range(4)]
        loss = torch.stack(losses)
        dist.all_reduce(loss)
        res[f"stage{stage}.losses"] = loss / n
        res[f"stage{stage}.param_bytes"] = np.array(_bytes(model.parameters()))
        res[f"stage{stage}.moment_bytes"] = np.array(_bytes(
            t for st in opt._update.states.values() for t in st.values()))
        for k, v in model.state_dict().items():
            res[f"stage{stage}.{k}"] = dist._sharded.gather_full(v)
    res["full_bytes"] = np.array(full_bytes)
    _save(out, "zero", **res)


def fleet_sharding(out, weights, data):
    """fleet.init at sharding_degree = world: distributed_model /
    distributed_optimizer at stage 3 with the eager loop, then
    save_group_sharded_model; DygraphShardingOptimizer (stage 1) over
    fleet's group; shard_optimizer_state."""
    rank, n = dist.get_rank(), dist.get_world_size()
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": n, "sep_degree": 1}
    strategy.sharding_configs = {"stage": 3}
    dist.fleet.init(is_collective=True, strategy=strategy)
    d = np.load(data)
    x, y = _t(d["x"]), _t(d["y"]).long()
    per = x.shape[0] // n
    xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    res = {}
    model = dist.fleet.distributed_model(_mlp(weights))
    opt = dist.fleet.distributed_optimizer(
        paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters()))
    stage1 = _mlp(weights)
    opt1 = dist.fleet.DygraphShardingOptimizer(
        paddle.optimizer.AdamW(learning_rate=0.01, parameters=stage1.parameters()))
    for name, m, o in (("stage3", model, opt), ("stage1", stage1, opt1)):
        losses = []
        for _ in range(4):
            loss = F.cross_entropy(m(xs), ys)
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(loss.detach())
        loss = torch.stack(losses)
        dist.all_reduce(loss)
        res[f"{name}.losses"] = loss / n
        res[f"{name}.stage"] = np.array(o.stage)
    dist.fleet.sharding.save_group_sharded_model(model, os.path.join(out, "gsm"), opt)
    mesh = dist.fleet.fleet._mesh
    sliced = dist.fleet.sharding.shard_optimizer_state(
        {"w": {"m": torch.arange(16.0 * 3).reshape(16, 3), "step": torch.tensor(1.0)}},
        {"w": torch.zeros(16, 3)}, mesh)
    res["shard_optimizer_state"] = sliced["w"]["m"]
    _save(out, "fleet_sharding", **res)


def _llama(weights, mesh=None):
    from paddle_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.tiny()
    model = L.LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=0)
    L.load_reference_state_dict(model, dict(np.load(weights)))
    return model


def _llama_step(model, clip, mesh, policy=None):
    from paddle_tpu_torch.distributed.partitioning import Partitioner, PartitionedTrainStep

    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1,
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(clip))
    return PartitionedTrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0],
                                partitioner=Partitioner(mesh), recompute_policy=policy)


def _gathered(model):
    return {k: dist._sharded.gather_full(p.detach(), dist._sharded.info_of(p))
            for k, p in model.named_parameters()}


class published:
    """Records the host sentinels and the loss of every step's numerics
    fold (``profiler.numerics.publish``) while open: :attr:`steps`, one
    ``(sentinels, loss)`` a call."""

    def __enter__(self):
        from paddle_tpu_torch.profiler import numerics

        self._orig, self.steps = numerics.publish, []

        def publish(sent, loss=None):
            self.steps.append((dict(sent), loss))
            self._orig(sent, loss=loss)

        numerics.publish = publish
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.profiler import numerics

        numerics.publish = self._orig

    def arrays(self) -> dict:
        """``sent_grad_norm`` / ``sent_digest`` / ``sent_nonfinite`` /
        ``sent_loss`` over the steps."""
        return {"sent_grad_norm": np.array([s["grad_norm"] for s, _ in self.steps]),
                "sent_digest": np.array([s["digest"] for s, _ in self.steps], np.int64),
                "sent_nonfinite": np.array([s["nonfinite"] for s, _ in self.steps]),
                "sent_loss": np.array([loss for _, loss in self.steps])}


def reduced_whole(params, grads) -> dict:
    """The numerics digest (the wrapping u32 sum of the f32 bits) and the
    f64 L2 norm of the reduced gradients ``grads`` (a sharded step's
    ``_reduce``), each gathered whole."""
    from paddle_tpu_torch.ops.sentinels import _digest_plain

    whole = [dist._sharded.gather_full(g, dist._sharded.info_of(p))
             for (_, p), g in zip(params, grads)]
    return {"reduced_digest0": np.array(sum(int(_digest_plain(t)) for t in whole)
                                        & 0xFFFFFFFF, np.int64),
            "reduced_norm0": np.sqrt(sum(float(torch.sum(t.double() ** 2)) for t in whole))}


def partitioned(out, weights, data, dp_, fsdp, clip, policy="none"):
    """PartitionedTrainStep on a tiny Llama over dp x fsdp, 3 steps, under
    the recompute ``policy``; the numerics plane's published loss, grad norm
    and digest of every step, and the digest of the first batch's reduced
    gradients gathered whole."""
    d = np.load(data)
    mesh = dist.build_program_mesh(dp=int(dp_), fsdp=int(fsdp))
    model = _llama(weights)
    step = _llama_step(model, float(clip), mesh, policy)
    update = step.optimizer._update
    params = step._params()
    # this rank's rows, as the step runs them
    rows = [step.partitioner.shard_batch(_t(d[k])) for k in ("ids0", "labels0")]
    _, grads = step._loss_and_grads(params, rows)
    first = reduced_whole(params, update._reduce([p for _, p in params], grads))
    C.reset_stats()
    res = {"losses": [], "clip_scales": []}
    with published() as pub:
        for i in range(3):
            res["losses"].append(step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])))
            res["clip_scales"].append(update.last_clip_scale)
    res = {k: torch.stack(v) for k, v in res.items()}
    res.update(pub.arrays(), **first)
    res["param_bytes"] = np.array(_bytes(model.parameters()))
    res["moment_bytes"] = np.array(_bytes(t for st in step.optimizer._update.states.values()
                                          for t in st.values()))
    res["all_gathers"] = np.array(C.stats()["calls"]["all_gather"])
    for k, v in _gathered(model).items():
        res[f"param.{k}"] = v
    _save(out, f"partitioned_{dp_}x{fsdp}_{policy}", **res)


def partitioned_accum(out, weights, data):
    """PartitionedTrainStep at fsdp over the world with
    ``accumulate_steps=2``, 4 calls (the batches 0, 1, 2, 0): the numerics
    plane's published values of every call, micro-steps included."""
    d = np.load(data)
    model = _llama(weights)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1,
                                 grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    from paddle_tpu_torch.distributed.partitioning import Partitioner, PartitionedTrainStep

    step = PartitionedTrainStep(
        model, opt, lambda ids, lab: model(ids, labels=lab)[0], accumulate_steps=2,
        partitioner=Partitioner(dist.build_program_mesh(fsdp=dist.get_world_size())))
    with published() as pub:
        losses = [step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])) for i in (0, 1, 2, 0)]
    _save(out, "partitioned_accum", losses=torch.stack(losses), **pub.arrays())


def ckpt_save(out, weights, data, path):
    """2 steps at fsdp over the world, save, then a third: the unbroken run."""
    d = np.load(data)
    n = dist.get_world_size()
    model = _llama(weights)
    step = _llama_step(model, 1.0, dist.build_program_mesh(fsdp=n))
    losses = [step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])) for i in range(2)]
    dist.partitioning.save_partitioned(step, path)
    loss = step(_t(d["ids2"]), _t(d["labels2"]))
    res = {"loss3": loss, "losses": torch.stack(losses + [loss])}
    for k, v in _gathered(model).items():
        res[f"param.{k}"] = v
    _save(out, f"ckpt_save{n}", **res)


def ckpt_load(out, weights, data, path):
    """Load the checkpoint into this world (fsdp over it), run the third step."""
    d = np.load(data)
    n = dist.get_world_size()
    model = _llama(weights)
    step = _llama_step(model, 1.0, dist.build_program_mesh(fsdp=n))
    info = dist.partitioning.load_partitioned(step, path)
    loss = step(_t(d["ids2"]), _t(d["labels2"]))
    res = {"loss3": loss, "resharded": np.array(info["resharded"]),
           "step_count": np.array(step.optimizer._step_count)}
    for k, v in _gathered(model).items():
        res[f"param.{k}"] = v
    _save(out, f"ckpt_load{n}", **res)


def fleet_merge(out, weights, data):
    """fleet.init at dp = world, distributed_model / distributed_optimizer
    with gradient_merge k_steps=2, 4 TrainStep calls of half batches."""
    rank, n = dist.get_rank(), dist.get_world_size()
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": n, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1}
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    dist.fleet.init(is_collective=True, strategy=strategy)
    hcg = dist.fleet.get_hybrid_communicate_group()
    d = np.load(data)
    x, y = _t(d["x"]), _t(d["y"]).long()
    model = dist.fleet.distributed_model(_mlp(weights))
    opt = dist.fleet.distributed_optimizer(
        paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters()))
    step = paddle.jit.TrainStep(model, opt, lambda a, b: F.cross_entropy(model(a), b))
    quarter = x.shape[0] // 2 // n
    losses = []
    for i in range(4):
        lo = (i % 2) * (x.shape[0] // 2) + rank * quarter
        losses.append(step(x[lo:lo + quarter], y[lo:lo + quarter]))
    res = {"losses": torch.stack(losses), "step_count": np.array(opt._step_count),
           "is_dp": np.array(isinstance(model, dist.DataParallel)),
           "hcg": np.array([hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank(),
                            dist.fleet.worker_num(), dist.fleet.worker_index()])}
    for k, v in model.state_dict().items():
        res[f"param.{k}"] = v
    _save(out, "fleet_merge", **res)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def _params_of(layer, d, prefix):
    """Load the full arrays ``d[prefix + key]`` into ``layer``'s slices."""
    from paddle_tpu_torch.models import _weights

    _weights.load_reference_state_dict(layer, {k: d[prefix + k] for k in
                                               _weights.reference_state_dict(layer)})
    return layer


def _vjp(layer, x, cot, *args):
    """(output, input gradient, {param: gradient}) of ``sum(layer(x) * cot)``."""
    x = x.clone().requires_grad_(x.is_floating_point())
    y = layer(x, *args)
    (y * cot).sum().backward()
    grads = {k: p.grad.clone() for k, p in layer.named_parameters()}
    return y.detach(), (x.grad if x.is_floating_point() else torch.zeros(0)), grads


def _local(t, dim, n, r):
    return t.chunk(n, dim)[r].contiguous()


def mp_layers(out, data):
    """The four mp layers at tensor = world (the mesh's mp axis), every
    gather_output / input_is_parallel / bias case: outputs and gradients;
    and two planted faults, a row layer without its all-reduce and a
    column layer whose backward skips its all-reduce."""
    from paddle_tpu_torch.distributed import tensor_parallel as TP
    from paddle_tpu_torch.distributed.fleet import mp_layers as M

    n, r = dist.get_world_size(), dist.get_rank()
    d = {k: _t(v) for k, v in np.load(data).items()}
    dist.set_mesh(dist.ProcessMesh(shape=[n], dim_names=["mp"]))
    res = {}
    for bias in (False, True):
        for gather in (False, True):
            col = _params_of(M.ColumnParallelLinear(8, 16, has_bias=bias, gather_output=gather,
                                                    device="cpu"), d, f"col{int(bias)}.")
            cot = d["cot_col"] if gather else _local(d["cot_col"], -1, n, r)
            y, gx, gw = _vjp(col, d["x8"], cot)
            key = f"col.b{int(bias)}.g{int(gather)}"
            res.update({f"{key}.y": y, f"{key}.gx": gx,
                        **{f"{key}.grad.{k}": v for k, v in gw.items()}})
        for parallel in (False, True):
            row = _params_of(M.RowParallelLinear(16, 8, has_bias=bias,
                                                 input_is_parallel=parallel, device="cpu"),
                             d, f"row{int(bias)}.")
            x = _local(d["x16"], -1, n, r) if parallel else d["x16"]
            y, gx, gw = _vjp(row, x, d["cot_row"])
            key = f"row.b{int(bias)}.p{int(parallel)}"
            res.update({f"{key}.y": y, f"{key}.gx": gx,
                        **{f"{key}.grad.{k}": v for k, v in gw.items()}})
    emb = _params_of(M.VocabParallelEmbedding(32, 8, device="cpu"), d, "emb.")
    y, _, gw = _vjp(emb, d["ids"], d["cot_emb"])
    res.update({"emb.y": y, "emb.grad.weight": gw["weight"]})
    ce = M.ParallelCrossEntropy()
    logits = _local(d["logits"], -1, n, r).requires_grad_()
    loss = ce(logits, d["labels"])
    (loss * d["cot_ce"]).sum().backward()
    res.update({"ce.loss": loss.detach(), "ce.grad": logits.grad})
    # sequence parallelism: the two SP layers, the bias's gradient summed by the hooks
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as SP

    net = paddle.nn.Sequential(
        _params_of(SP.ColumnSequenceParallelLinear(8, 16, has_bias=True, device="cpu"), d,
                   "col1."),
        _params_of(SP.RowSequenceParallelLinear(16, 8, has_bias=True, device="cpu"), d, "row1."))
    SP.register_sequence_parallel_allreduce_hooks(net)
    y, gx, gw = _vjp(net, _local(d["xs"], 1, n, r), _local(d["cot_sp"], 1, n, r))
    res.update({"sp.y": y, "sp.gx": gx, **{f"sp.grad.{k}": v for k, v in gw.items()}})
    # planted faults
    col = _params_of(M.ColumnParallelLinear(8, 16, has_bias=True, device="cpu"), d, "col1.")
    row = _params_of(M.RowParallelLinear(16, 8, has_bias=True, device="cpu"), d, "row1.")
    keep = TP.reduce_from, TP.copy_to
    try:
        TP.reduce_from = lambda x, group: x
        res["fault.no_allreduce.y"] = row(d["x16"]).detach()
        TP.reduce_from, TP.copy_to = keep[0], lambda x, group: x
        _, res["fault.no_backward_allreduce.gx"], _ = _vjp(col, d["x8"], d["cot_col"])
    finally:
        TP.reduce_from, TP.copy_to = keep
    dist.set_mesh(None)
    _save(out, f"mp_layers{n}", **res)


def _tp_llama(cfg_name, weights, seq_parallel=False):
    from paddle_tpu_torch.models import llama as L

    cfg = (L.LlamaConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=48,
                              num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                              max_position_embeddings=8, use_flash_attention=False)
           if cfg_name == "micro" else L.LlamaConfig.tiny())
    cfg.sequence_parallel = bool(seq_parallel)
    model = L.LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=0)
    return model, dict(np.load(weights))


def _tp_opt(model, opt_name):
    if opt_name == "sgd":
        return paddle.optimizer.SGD(learning_rate=0.01, parameters=model.parameters())
    return paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                  weight_decay=0.1, grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))


def _tp_step(model, weights, opt_name, axes, seq_parallel=False):
    from paddle_tpu_torch.distributed.partitioning import Partitioner, PartitionedTrainStep
    from paddle_tpu_torch.models import llama as L

    step = PartitionedTrainStep(model, _tp_opt(model, opt_name),
                                lambda ids, lab: model(ids, labels=lab)[0],
                                partitioner=Partitioner(dist.build_program_mesh(**axes)))
    L.load_reference_state_dict(model, weights)
    return step


def tp_partitioned(out, cfg_name, weights, data, opt_name, axes, seq_parallel=0):
    """PartitionedTrainStep over ``axes`` (a JSON of build_program_mesh's),
    3 steps: losses, the parameters gathered whole, each rank's own slices,
    the specs, the reduced gradients of the first batch and the
    collectives."""
    import json

    axes = json.loads(axes) if isinstance(axes, str) else axes
    d = np.load(data)
    model, weights = _tp_llama(cfg_name, weights, seq_parallel)
    step = _tp_step(model, weights, opt_name, axes, seq_parallel)
    update = step.optimizer._update
    params = step._params()
    loss0, grads = step._loss_and_grads(params, (_t(d["ids0"]), _t(d["labels0"])))
    grads = update._reduce([p for _, p in params], grads)
    res = {"loss0": loss0, **{f"grad.{n}": g for (n, _), g in zip(params, grads)}}
    # the same on this rank's rows, as the step runs them
    _, grads = step._loss_and_grads(params, [step.partitioner.shard_batch(_t(d[k]))
                                             for k in ("ids0", "labels0")])
    res.update(reduced_whole(params, update._reduce([p for _, p in params], grads)))
    C.reset_stats()
    losses, scales = [], []
    with published() as pub:
        for i in range(3):
            losses.append(step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])))
            scales.append(update.last_clip_scale)
    res.update(pub.arrays(), losses=torch.stack(losses))
    if scales[0] is not None:       # the global-norm clip's (AdamW's; SGD has none)
        res["clip_scales"] = torch.stack(scales)
    stats = C.stats()
    res["collectives"] = np.array(json.dumps(stats))
    for k, v in _gathered(model).items():
        res[f"param.{k}"] = v
    for k, p in model.named_parameters():
        info = dist._sharded.info_of(p)
        index = info.held_index if info is not None else [slice(0, n) for n in p.shape]
        res[f"local.{k}"] = p.detach()
        res[f"index.{k}"] = np.array([[s.start, s.stop] for s in index])
        res[f"spec.{k}"] = np.array(repr(p.parallel_spec))
    tag = "_".join(f"{a}{v}" for a, v in sorted(axes.items()))
    _save(out, f"tp_{cfg_name}_{opt_name}_{tag}_sp{int(seq_parallel)}", **res)


def tp_ckpt(out, weights, data, path):
    """The micro Llama at fsdp 2 x tensor 2 with AdamW: 2 steps, save, a
    third (the unbroken run); then a fresh model at fsdp 4 (tensor 1)
    loads the checkpoint and runs the third step."""
    d = np.load(data)
    batch = [(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])) for i in range(3)]
    model, w = _tp_llama("micro", weights)
    step = _tp_step(model, w, "adamw", {"fsdp": 2, "tensor": 2})
    losses = [step(*b) for b in batch[:2]]
    saved = {f"saved.{k}": v.clone() for k, v in _gathered(model).items()}
    dist.partitioning.save_partitioned(step, path)
    losses.append(step(*batch[2]))
    model4, w = _tp_llama("micro", weights)
    step4 = _tp_step(model4, w, "adamw", {"fsdp": 4})
    info = dist.partitioning.load_partitioned(step4, path)
    res = {"losses": torch.stack(losses), "loss3_loaded": step4(*batch[2]),
           "resharded": np.array(info["resharded"]), **saved}
    for k, v in _gathered(model4).items():
        res[f"loaded.{k}"] = v
    _save(out, "tp_ckpt", **res)


def tp_fleet(out, weights, data):
    """fleet.init at mp_degree = world: the model group, distributed_model /
    distributed_optimizer over the tiny Llama, 3 TrainStep calls; the
    model-parallel RNG; parallelize(mp_config) over an mp mesh, 3 calls."""
    n = dist.get_world_size()
    d = np.load(data)
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": n, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1}
    dist.fleet.init(is_collective=True, strategy=strategy)
    hcg = dist.fleet.get_hybrid_communicate_group()
    res = {"hcg": np.array([hcg.get_model_parallel_world_size(), hcg.get_model_parallel_rank(),
                            hcg.get_model_parallel_group_src_rank()]),
           "mode": np.array(hcg.get_parallel_mode())}
    batch = [(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])) for i in range(3)]
    from paddle_tpu_torch.models import llama as L

    for how in ("fleet", "parallelize"):
        model, w = _tp_llama("tiny", weights)
        L.load_reference_state_dict(model, w)
        opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                     weight_decay=0.1)
        if how == "fleet":
            model = dist.fleet.distributed_model(model)
            opt = dist.fleet.distributed_optimizer(opt)
        else:
            model, opt = dist.parallelize(model, opt, mesh=dist.auto_mesh(mp=n),
                                          config={"mp_config": {}})
        step = paddle.jit.TrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0])
        res[f"{how}.losses"] = torch.stack([step(*b) for b in batch])
        res[f"{how}.q_shape"] = np.array(model.llama.layers[0].self_attn.q_proj.weight.shape)
    # a model without its own tensor-parallel schedule: parallelize makes each
    # cut Linear column- or row-parallel and the cut Embedding vocab-parallel
    torch.manual_seed(1)
    emb = paddle.nn.Embedding(16, 8, device="cpu")
    lin_c, lin_r = paddle.nn.Linear(8, 12, device="cpu"), paddle.nn.Linear(12, 8, device="cpu")
    emb.weight.shard_axes, lin_c.weight.shard_axes = {0: "mp"}, {1: "mp"}
    lin_r.weight.shard_axes = {0: "mp"}
    net = paddle.nn.Sequential(emb, lin_c, lin_r)
    ids = torch.arange(16).reshape(2, 8)
    res["generic.whole"] = net(ids).detach()
    dist.parallelize(net, mesh=dist.auto_mesh(mp=n))
    res["generic.cut"] = net(ids).detach()
    res["generic.shapes"] = np.array([list(p.shape) for p in
                                      (emb.weight, lin_c.weight, lin_r.weight)])
    from paddle_tpu_torch.distributed.fleet import random as R

    R.model_parallel_random_seed(7)
    with R.get_rng_state_tracker().rng_state():
        res["rng.mp"] = paddle.rand([4])
    res["rng.shared"] = paddle.rand([4])
    dist.set_mesh(None)
    _save(out, "tp_fleet", **res)


def semi_auto(out):
    """The semi-auto API on a dp 2 x mp 2 mesh, as the reference's
    ``test_shard_and_reshard``."""
    mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"])
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    xs = dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Shard(1)])
    xr = dist.reshard(xs, mesh, [dist.Replicate(), dist.Replicate()])
    y = torch.ones(8, 4, requires_grad=True)
    ys = dist.shard_tensor(y, mesh, [dist.Shard(0), dist.Replicate()])
    ys.sum().backward()
    try:
        dist.shard_tensor(x, mesh, [dist.Partial(), dist.Replicate()])
        partial = "no raise"
    except NotImplementedError as e:
        partial = str(e)
    lin = paddle.nn.Linear(4, 3, device="cpu")
    dist.shard_layer(lin, mesh)
    _save(out, "semi_auto", local=xs.detach(), full=dist.unshard_dtensor(xs).detach(),
          replicated=xr.detach(), grad=y.grad, has_attr=np.array(xs.dist_attr is not None),
          partial=np.array(partial),
          layer=np.array([repr(p.dist_attr.placements) for p in lin.parameters()]))


# ---------------------------------------------------------------------------
# the pipeline: the reference's tests/test_pipeline.py:25-77 model
# ---------------------------------------------------------------------------

PP_V, PP_H = 64, 16


class PPBlock(paddle.nn.Layer):
    def __init__(self, h=PP_H):
        super().__init__()
        self.fc1 = paddle.nn.Linear(h, 2 * h, device="cpu")
        self.fc2 = paddle.nn.Linear(2 * h, h, device="cpu")

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class PPHead(paddle.nn.Layer):
    def __init__(self, h=PP_H, v=PP_V):
        super().__init__()
        self.norm = paddle.nn.LayerNorm(h, device="cpu")
        self.proj = paddle.nn.Linear(h, v, device="cpu")

    def forward(self, x):
        return self.proj(self.norm(x))


def pp_loss(logits, labels):
    return F.cross_entropy(logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]),
                           reduction="mean")


def pp_model(weights, n_layers, v=PP_V, h=PP_H):
    """(embedding, blocks, head) with the reference's weights (``emb.*``,
    ``layers.<i>.*``, ``head.*`` of ``weights``)."""
    d = dict(np.load(weights))
    emb = paddle.nn.Embedding(v, h, device="cpu")
    layers = [PPBlock(h) for _ in range(n_layers)]
    head = PPHead(h, v)
    for prefix, layer in [("emb.", emb), ("head.", head)] + [
            (f"layers.{i}.", lyr) for i, lyr in enumerate(layers)]:
        missing, _ = layer.set_state_dict({k[len(prefix):]: a for k, a in d.items()
                                           if k.startswith(prefix)})
        assert not missing, missing
    return emb, layers, head


def _pp_tokens(data, key):
    d = np.load(data)
    return _t(d[f"{key}_ids"]), _t(d[f"{key}_labels"])


def _pp_mesh(n=None, axis="pp"):
    return dist.ProcessMesh(shape=[n or dist.get_world_size()], dim_names=[axis])


def _pp_save_tree(out, case, tree, **extra):
    flat = {f"{part}/{k}": v.detach() for part in tree for k, v in tree[part].items()}
    _save(out, case, **flat, **extra)


def pp_grads(out, weights, data, key, style, M, chunks, n_layers):
    """forward_backward_pipeline over the world's pp axis; the gradients
    reassembled by gather_pipeline_tree on every rank."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel, gather_pipeline_tree

    emb, layers, head = pp_model(weights, n_layers)
    ids, labels = _pp_tokens(data, key)
    pp = PipelineParallel(emb, layers, head, pp_loss, mesh=_pp_mesh(), num_microbatches=M,
                          schedule=style, num_chunks=chunks)
    C.reset_stats()
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    stats = C.stats()
    tree = gather_pipeline_tree(grads, pp)
    _pp_save_tree(out, f"pp_grads_{style}_{M}", tree, loss=loss,
                  local_keys=np.array(sorted(f"{p}/{k}" for p in grads for k in grads[p])),
                  peak=np.array(pp.peak_in_flight), ring=np.array(pp._sched.ring),
                  sends=np.array(stats["calls"].get("send", 0)),
                  recvs=np.array(stats["calls"].get("recv", 0)))


def _all_params(emb, layers, head):
    out = {f"emb.{k}": v for k, v in emb.named_parameters()}
    for i, lyr in enumerate(layers):
        out.update({f"layers.{i}.{k}": v for k, v in lyr.named_parameters()})
    out.update({f"head.{k}": v for k, v in head.named_parameters()})
    return out


def pp_train(out, weights, data, key, style, M, chunks, n_layers, steps):
    """train_batch with AdamW(1e-2), then sync_to_model: the losses and
    every parameter, on every rank."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel

    emb, layers, head = pp_model(weights, n_layers)
    ids, labels = _pp_tokens(data, key)
    pp = PipelineParallel(emb, layers, head, pp_loss, mesh=_pp_mesh(), num_microbatches=M,
                          schedule=style, num_chunks=chunks)
    params = list(_all_params(emb, layers, head).values())
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params)
    losses = [pp.train_batch((ids, labels), opt).item() for _ in range(steps)]
    pp.sync_to_model()
    _save(out, f"pp_train_{style}", losses=np.array(losses),
          **{k: v.detach() for k, v in _all_params(emb, layers, head).items()})


def pp_frozen(out, weights, data, key):
    """A frozen embedding through 3 steps; then switching the optimizer's
    class raises TypeError."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel

    emb, layers, head = pp_model(weights, 4)
    emb.weight.stop_gradient = True
    emb.weight.trainable = False
    ids, labels = _pp_tokens(data, key)
    pp = PipelineParallel(emb, layers, head, pp_loss, mesh=_pp_mesh(), num_microbatches=2,
                          schedule="1f1b")
    params = list(_all_params(emb, layers, head).values())
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params)
    before = emb.weight.detach().clone()
    proj = head.proj.weight.detach().clone()
    for _ in range(3):
        pp.train_batch((ids, labels), opt)
    try:
        pp.train_batch((ids, labels), paddle.optimizer.SGD(learning_rate=0.1,
                                                           parameters=params))
        switched = "no error"
    except TypeError as e:
        switched = str(e)
    _save(out, "pp_frozen", emb_before=before, emb_after=emb.weight.detach(),
          proj_before=proj, proj_after=head.proj.weight.detach(), switched=np.array(switched))


def pp_remat(out, weights, data, key):
    """remat=True against remat=False, 1F1B at M 4."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel, gather_pipeline_tree

    res = {}
    for remat in (False, True):
        emb, layers, head = pp_model(weights, 4)
        ids, labels = _pp_tokens(data, key)
        pp = PipelineParallel(emb, layers, head, pp_loss, mesh=_pp_mesh(), num_microbatches=4,
                              schedule="1f1b", remat=remat)
        loss, grads = pp.forward_backward_pipeline(ids, labels)
        tree = gather_pipeline_tree(grads, pp)
        res[f"loss_{remat}"] = loss
        res.update({f"{remat}/{part}/{k}": v for part in tree for k, v in tree[part].items()})
    _save(out, "pp_remat", **res)


def pp_apply(out, data):
    """pipeline_apply over the world's pp axis (the reference's
    tests/test_distributed.py:300-335)."""
    from paddle_tpu_torch.distributed.fleet import (pipeline_apply, scan_layers,
                                                    stack_stage_params)

    d = np.load(data)
    n = dist.get_world_size()
    stacked = stack_stage_params([{"w": _t(d[f"w{i}"])} for i in range(8)], n)
    p = dist.get_rank()
    mesh = _pp_mesh()
    with mesh:
        got = pipeline_apply(lambda sp, h: scan_layers(lambda q, x: torch.tanh(x @ q["w"]), sp, h),
                             {"w": stacked["w"][p:p + 1]}, _t(d["x"]), num_stages=n,
                             num_microbatches=4, axis_name="pp")
        last_only = pipeline_apply(
            lambda sp, h: scan_layers(lambda q, x: torch.tanh(x @ q["w"]), sp, h),
            {"w": stacked["w"][p:p + 1]}, _t(d["x"]), num_stages=n, num_microbatches=4,
            axis_name="pp", broadcast_output=False)
    _save(out, "pp_apply", output=got, last_only=last_only)


def pp_dp(out, weights, data, key, steps):
    """pp 2 x dp 2: each replica on its half of the batch; the gradients
    after the data average on every rank, then train_batch's losses."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel

    mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["pp", "dp"])
    emb, layers, head = pp_model(weights, 4)
    ids, labels = _pp_tokens(data, key)
    pp = PipelineParallel(emb, layers, head, pp_loss, mesh=mesh, num_microbatches=2,
                          schedule="1f1b")
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    flat = {f"{part}/{k}": v for part in grads for k, v in grads[part].items()}
    params = list(_all_params(emb, layers, head).values())
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params)
    losses = [pp.train_batch((ids, labels), opt).item() for _ in range(steps)]
    _save(out, "pp_dp", loss=loss, losses=np.array(losses), **flat,
          coord=np.array([mesh.coordinate()["pp"], mesh.coordinate()["dp"]]))


def pp_rules(out, weights, data):
    """pipeline_from_rules on build_program_mesh(pipe=2), a direct
    PipelineParallel over a pp axis, and one over fleet's mesh at
    pp_degree 2: the same loss and gradients; fleet's topology getters."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    from paddle_tpu_torch.distributed.partitioning import Partitioner, pipeline_from_rules

    ids, labels = _pp_tokens(data, "shim")
    res = {}
    emb, layers, head = pp_model(weights, 2, v=32)
    pp = pipeline_from_rules(emb, layers, head, pp_loss,
                             partitioner=Partitioner(dist.build_program_mesh(pipe=2)),
                             num_microbatches=2)
    res["rules_axis"] = np.array([pp.axis_name, str(pp.num_stages), str(pp.mesh.dim_names)])
    runs = {"rules": pp}
    emb, layers, head = pp_model(weights, 2, v=32)
    runs["direct"] = PipelineParallel(emb, layers, head, pp_loss, mesh=_pp_mesh(),
                                      num_microbatches=2)
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2,
                               "sharding_degree": 1, "sep_degree": 1}
    dist.fleet.init(is_collective=True, strategy=strategy)
    hcg = dist.fleet.get_hybrid_communicate_group()
    res["fleet_hcg"] = np.array([str(x) for x in (
        hcg.get_parallel_mode(), hcg.get_stage_id(), hcg.get_pipe_parallel_rank(),
        hcg.get_pipe_parallel_world_size(), hcg.get_pipe_parallel_group().ranks,
        hcg.is_first_stage(), hcg.is_last_stage(), hcg._get_p2p_prev_rank(),
        hcg._get_p2p_next_rank())])
    emb, layers, head = pp_model(weights, 2, v=32)
    res["fleet_model_same"] = np.array(dist.fleet.distributed_model(head) is head)
    fleet_mesh = dist.get_mesh()
    res["fleet_mesh"] = np.array(fleet_mesh.dim_names + [str(x) for x in fleet_mesh.shape])
    runs["fleet"] = PipelineParallel(emb, layers, head, pp_loss, mesh=fleet_mesh,
                                     num_microbatches=2)
    for name, run in runs.items():
        loss, grads = run.forward_backward_pipeline(ids, labels)
        res[f"{name}/loss"] = loss
        res.update({f"{name}/{part}/{k}": v for part in grads for k, v in grads[part].items()})
    dist.set_mesh(None)
    res.update(_pp_functional(weights, ids, labels))
    # one stage over both ranks as data replicas: vpp's chunks hand over
    # within the rank
    emb, layers, head = pp_model(weights, 2, v=32)
    one = PipelineParallel(emb, layers, head, pp_loss,
                           mesh=dist.ProcessMesh(shape=[1, 2], dim_names=["pp", "dp"]),
                           num_microbatches=2, schedule="vpp", num_chunks=2)
    loss, grads = one.forward_backward_pipeline(ids, labels)
    res["one_stage/loss"] = loss
    res.update({f"one_stage/{part}/{k}": v for part in grads for k, v in grads[part].items()})
    _save(out, "pp_rules", **res)


def _pp_functional(weights, ids, labels):
    """make_pipeline_step over the same model as functions of parameter
    trees (torch.func.functional_call; the chunk through scan_layers)."""
    from paddle_tpu_torch.distributed.fleet import make_pipeline_step, scan_layers

    emb, layers, head = pp_model(weights, 2, v=32)
    p = dist.get_rank()
    params = {"first": dict(emb.named_parameters()) if p == 0 else {},
              "stack": {k: v.detach()[None, None] for k, v in layers[p].named_parameters()},
              "last": dict(head.named_parameters()) if p == 1 else {}}
    step = make_pipeline_step(
        lambda w, x: torch.func.functional_call(emb, w, (x,)),
        lambda w, h: scan_layers(layers[p], w, h),
        lambda w, h, y: pp_loss(torch.func.functional_call(head, w, (h,)), y),
        mesh=_pp_mesh(), num_stages=2, num_microbatches=2)
    loss, grads = step(params, ids, labels)
    out = {"functional/loss": loss}
    out.update({f"functional/{part}/{k}": v for part in grads for k, v in grads[part].items()})
    return out


class _LlamaLast(paddle.nn.Layer):
    """A Llama's last stage: the final norm and the head."""

    def __init__(self, model):
        super().__init__()
        self.norm = model.llama.norm
        self.lm_head = model.lm_head

    def forward(self, h):
        return self.lm_head(self.norm(h))


def pp_llama(out, weights, data, dtype):
    """The tiny Llama as embedding / decoder layers / norm + head at pp 2,
    M 2. f32: the loss and every gradient, reassembled. bf16: each stage's
    outputs (stage 0's activation, stage 1's logits and loss) for every
    microbatch, against a one-process traced forward of the same
    microbatch, and the same forward untraced as the control."""
    from paddle_tpu_torch import tracing
    from paddle_tpu_torch.distributed.fleet import PipelineParallel, gather_pipeline_tree
    from paddle_tpu_torch.models import llama as L

    dt = getattr(torch, dtype)
    model = L.LlamaForCausalLM(L.LlamaConfig.tiny(), device="cpu", dtype=dt, seed=0)
    L.load_reference_state_dict(model, dict(np.load(weights)))
    if dtype == "bfloat16":     # norm weights away from 1, where both roundings agree
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, q in model.named_parameters():
                if "norm" in name:
                    q.mul_(1 + 0.1 * torch.randn(q.shape, generator=g).to(dt))
    ids, labels = _pp_tokens(data, "llama")
    emb, layers, last = model.llama.embed_tokens, list(model.llama.layers), _LlamaLast(model)
    captured = {"act": [], "logits": [], "loss": []}

    def loss_fn(logits, lab):
        loss = pp_loss(logits, lab)
        captured["logits"].append(logits.detach().clone())
        captured["loss"].append(loss.detach().clone())
        return loss

    hook = layers[0].register_forward_hook(
        lambda m, i, o: captured["act"].append(o.detach().clone()))
    pp = PipelineParallel(emb, layers, last, loss_fn, mesh=_pp_mesh(), num_microbatches=2)
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    hook.remove()
    res = {"loss": loss.float()}
    if dtype == "float32":
        tree = gather_pipeline_tree(grads, pp)
        res.update({f"{part}/{k}": v for part in tree for k, v in tree[part].items()})
    else:
        rank = dist.get_rank()
        mine = ["act"] if rank == 0 else ["logits", "loss"]
        for traced in (True, False):
            same = []
            for m in range(2):
                rows = slice(2 * m, 2 * m + 2)
                with torch.no_grad(), tracing.marked(traced):
                    act = layers[0](emb(ids[rows]))
                    logits = last(layers[1](act))
                    want = {"act": act, "logits": logits,
                            "loss": pp_loss(logits, labels[rows])}
                same += [bool(torch.equal(captured[k][m], want[k])) for k in mine]
            res[f"equal_{'traced' if traced else 'untraced'}"] = np.array(same)
    _save(out, f"pp_llama_{dtype}", **res)


# ---------------------------------------------------------------------------
# hybrid parallelism: the pipeline beside the tensor and sharding axes
# ---------------------------------------------------------------------------

HY_SPEC = ("dp", "mp")      # activation_spec: the sequence (dim 1) over the tensor axis


def hy_marked(emb, layers, head):
    """The pipeline model with Megatron's marks: fc1 column-parallel, fc2
    row-parallel (each with an fsdp dim, as the Llama's), the head's
    projection on its vocabulary columns."""
    for lyr in layers:
        lyr.fc1.weight.shard_axes = {1: "mp", 0: "fsdp"}
        lyr.fc2.weight.shard_axes = {0: "mp", 1: "fsdp"}
    head.proj.weight.shard_axes = {1: "mp"}
    return emb, layers, head


def _fleet_init(stage=1, **degrees):
    f = dist.fleet.fleet
    f._strategy = f._hcg = f._topology = f._mesh = f._model_update = None
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1, **degrees}
    strategy.sharding_configs = {"stage": stage}
    dist.fleet.init(is_collective=True, strategy=strategy)
    return dist.fleet.get_hybrid_communicate_group()


def _fleet_reset():
    f = dist.fleet.fleet
    f._strategy = f._hcg = f._topology = f._mesh = f._model_update = None
    dist.set_mesh(None)


def _whole_params(named):
    """{name: the whole tensor} of parameters some of which are this rank's
    slices (every rank of a slice's groups gathers, in one order)."""
    return {k: dist._sharded.gather_full(v).detach() for k, v in named.items()}


def hybrid_axes(out):
    """What waited for this slice builds over 4 ranks: the program mesh at
    pipe x tensor and pipe x fsdp (the pipe and other axes' groups), a
    pipeline with activation_spec (the cut dim), and fleet's topology at
    pp x mp and pp x sharding (every getter)."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel

    res = {}
    for name, axes in (("pipe_and_tensor", {"pipe": 2, "tensor": 2}),
                       ("pipe_and_fsdp", {"pipe": 2, "fsdp": 2})):
        mesh = dist.build_program_mesh(**axes)
        other = "tensor" if "tensor" in axes else "fsdp"
        res[name] = np.array(mesh.shape + mesh.get_group("pipe").ranks
                             + mesh.get_group(other).ranks + mesh.axis_ranks("pipe"))
    emb, layers, head = hy_marked(*pp_model_random(2))
    pp = PipelineParallel(emb, layers, head, pp_loss,
                          mesh=dist.ProcessMesh(shape=[2, 2], dim_names=["pp", "mp"]),
                          num_microbatches=2, activation_spec=HY_SPEC)
    res["activation_spec"] = np.array([pp.link.seq_dim, pp.link.tensor_group.nranks,
                                       len(pp.link.data_axes)])
    for name, deg in (("topology_pp_mp", {"pp_degree": 2, "mp_degree": 2}),
                      ("topology_pp_sharding", {"pp_degree": 2, "sharding_degree": 2}),
                      ("topology_mp_sharding", {"mp_degree": 2, "sharding_degree": 2})):
        hcg = _fleet_init(**deg)
        res[name] = np.array([str(x) for x in (
            hcg.get_parallel_mode(), hcg.get_stage_id(), hcg.get_pipe_parallel_group().ranks,
            hcg.get_model_parallel_rank(), hcg.get_model_parallel_group().ranks,
            hcg.get_sharding_parallel_rank(), hcg.get_sharding_parallel_group().ranks,
            hcg.get_data_parallel_group().ranks, hcg._get_p2p_prev_rank(),
            hcg._get_p2p_next_rank(), dist.get_mesh().dim_names, dist.get_mesh().shape)])
    _fleet_reset()
    _save(out, "hybrid_axes", **res)


def pp_model_random(n_layers):
    torch.manual_seed(0)
    emb = paddle.nn.Embedding(PP_V, PP_H, device="cpu")
    return emb, [PPBlock() for _ in range(n_layers)], PPHead()


def _hy_mesh(kind):
    shapes = {"pp_mp": ([2, 2], ["pp", "mp"]), "pp_dp_mp": ([2, 2, 2], ["pp", "dp", "mp"])}
    shape, names = shapes[kind]
    return dist.ProcessMesh(shape=shape, dim_names=names)


def hy_grads(out, weights, data, key, style, M, chunks, n_layers, spec, loss, kind="pp_mp"):
    """forward_backward_pipeline over ``kind``'s mesh, the stages cut by
    their marks over ``mp``: the loss and the gradients gathered whole by
    gather_pipeline_tree, and the bytes sent between stages; ``spec`` 1
    with activation_spec, ``loss`` ``mean`` (the reference's
    cross entropy on gathered logits) or ``pce`` (ParallelCrossEntropy on
    the head's vocabulary columns)."""
    from paddle_tpu_torch.distributed.fleet import (ParallelCrossEntropy, PipelineParallel,
                                                    gather_pipeline_tree)

    mesh = _hy_mesh(kind)
    emb, layers, head = hy_marked(*pp_model(weights, n_layers))
    ids, labels = _pp_tokens(data, key)
    pp = PipelineParallel(emb, layers, head, pp_loss if loss == "mean" else ParallelCrossEntropy(),
                          mesh=mesh, num_microbatches=M, schedule=style, num_chunks=chunks,
                          activation_spec=HY_SPEC if spec else None)
    C.reset_stats()
    got_loss, grads = pp.forward_backward_pipeline(ids, labels)
    stats = C.stats()
    tree = gather_pipeline_tree(grads, pp)
    _pp_save_tree(out, f"hy_grads_{kind}_{style}_{spec}_{loss}", tree, loss=got_loss,
                  sent=np.array(stats["bytes"].get("send", 0)),
                  proj_shape=np.array(head.proj.weight.shape if pp.stage == 1 else [0, 0]))


def hy_train(out, weights, data, key, how, steps):
    """train_batch with AdamW(1e-2), 3 steps, then sync_to_model: ``how``
    ``sharding`` (fleet at pp 2 x sharding 2, stage 1: the optimizer state
    on half of each tensor) or ``fsdp`` (pipeline_from_rules on
    build_program_mesh(pipe=2, fsdp=2): the marked weights at rest, half
    on each rank); the losses, every parameter whole, the state's size."""
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    from paddle_tpu_torch.distributed.partitioning import Partitioner, pipeline_from_rules

    emb, layers, head = hy_marked(*pp_model(weights, 4))
    ids, labels = _pp_tokens(data, key)
    if how == "sharding":
        _fleet_init(pp_degree=2, sharding_degree=2)
        pp = PipelineParallel(emb, layers, head, pp_loss, mesh=dist.get_mesh(),
                              num_microbatches=2)
    else:
        pp = pipeline_from_rules(emb, layers, head, pp_loss, num_microbatches=2,
                                 partitioner=Partitioner(dist.build_program_mesh(pipe=2, fsdp=2)))
    params = _all_params(emb, layers, head)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=list(params.values()))
    losses = [pp.train_batch((ids, labels), opt).item() for _ in range(steps)]
    held = sum(q.numel() for _, _, q in pp._owned())
    at_rest = [k for k, v in params.items() if dist._sharded.info_of(v) is not None
               and dist._sharded.info_of(v).at_rest]
    pp.sync_to_model()
    _save(out, f"hy_train_{how}", losses=np.array(losses), held=np.array(held),
          state=np.array(sum(v.numel() for st in pp._update.states.values()
                             for v in st.values() if torch.is_tensor(v))),
          at_rest=np.array(sorted(at_rest)),
          **_whole_params(params))
    _fleet_reset()


def hy_mp_sharding(out, weights, data, how, stage):
    """The micro Llama at mp 2 x sharding 2, 3 TrainStep calls with AdamW
    under the global-norm clip, each rank on its sharding coordinate's rows:
    ``how`` ``parallelize`` (mp_config and sharding_config at ``stage``
    over ProcessMesh([2, 2], ["sharding", "mp"])) or ``fleet``
    (mp_degree 2, sharding_degree 2); the losses, every parameter whole and
    the optimizer state's size."""
    d = np.load(data)
    model, w = _tp_llama("micro", weights)
    from paddle_tpu_torch.models import llama as L

    L.load_reference_state_dict(model, w)
    opt = _tp_opt(model, "adamw")
    if how == "fleet":
        hcg = _fleet_init(stage=stage, mp_degree=2, sharding_degree=2)
        model = dist.fleet.distributed_model(model)
        opt = dist.fleet.distributed_optimizer(opt)
        row = hcg.get_sharding_parallel_rank()
    else:
        mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["sharding", "mp"])
        model, opt = dist.parallelize(model, opt, mesh=mesh, config={
            "mp_config": {}, "sharding_config": {"stage": stage}})
        row = mesh.coordinate()["sharding"]
    step = paddle.jit.TrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0])
    half = slice(4 * row, 4 * row + 4)
    losses = torch.stack([step(_t(d[f"ids{i}"])[half], _t(d[f"labels{i}"])[half])
                          for i in range(3)])
    state = sum(t.numel() for st in opt._update.states.values() for t in st.values()
                if torch.is_tensor(t))
    _save(out, f"hy_mps_{how}_{stage}", losses=losses, state=np.array(state),
          stage=np.array(opt.stage), **_whole_params(dict(model.named_parameters())))
    _fleet_reset()


class MPBlock(paddle.nn.Layer):
    """PPBlock on fleet's mp layers: fc1 column-parallel (output kept cut),
    fc2 row-parallel (input cut)."""

    def __init__(self, h=PP_H):
        super().__init__()
        M = dist.fleet.mp_layers
        self.fc1 = M.ColumnParallelLinear(h, 2 * h, has_bias=True, gather_output=False,
                                          device="cpu")
        self.fc2 = M.RowParallelLinear(2 * h, h, input_is_parallel=True, device="cpu")

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(x)))


class MPHead(paddle.nn.Layer):
    def __init__(self, h=PP_H, v=PP_V):
        super().__init__()
        self.norm = paddle.nn.LayerNorm(h, device="cpu")
        self.proj = dist.fleet.mp_layers.ColumnParallelLinear(h, v, has_bias=True,
                                                              gather_output=False, device="cpu")

    def forward(self, x):
        return self.proj(self.norm(x))


def hy_pp_layers(out, data, key):
    """PipelineLayer over LayerDescs of fleet's mp layers at pp 2 x mp 2
    (fleet.init): its eager forward and backward on every rank (every
    stage's layers, the tensor collectives inside them), then
    PipelineParallel over its run_function with ParallelCrossEntropy; the
    losses and every gradient whole."""
    from paddle_tpu_torch.distributed.fleet import (LayerDesc, ParallelCrossEntropy,
                                                    PipelineLayer, PipelineParallel,
                                                    gather_pipeline_tree)

    hcg = _fleet_init(pp_degree=2, mp_degree=2)
    torch.manual_seed(3)
    pce = ParallelCrossEntropy()
    pl = PipelineLayer([LayerDesc(dist.fleet.VocabParallelEmbedding, PP_V, PP_H, device="cpu"),
                        LayerDesc(MPBlock), LayerDesc(MPBlock), LayerDesc(MPHead)],
                       topology=hcg.topology(), loss_fn=lambda y, t: pce(y, t).mean())
    ids, labels = _pp_tokens(data, key)
    loss = pl(ids, labels=labels)
    loss.backward()
    named = dict(pl.named_parameters())
    res = {"eager_loss": loss.detach(), "stages": np.array(pl.segment_parts),
           **{f"eager/{k}": dist._sharded.gather_full(q.grad, dist._sharded.info_of(q))
              for k, q in named.items()}}
    for q in named.values():
        q.grad = None
    layers = list(pl.run_function)
    pp = PipelineParallel(layers[0], layers[1:-1], layers[-1], ParallelCrossEntropy(),
                          mesh=dist.get_mesh(), num_microbatches=2)
    got_loss, grads = pp.forward_backward_pipeline(ids, labels)
    tree = gather_pipeline_tree(grads, pp)
    _fleet_reset()
    _pp_save_tree(out, "hy_pp_layers", tree, loss=got_loss, **res)


def hy_llama(out, weights, data):
    """The tiny Llama (f32) at pp 2 x tensor 2 with sequence parallelism
    through its pipeline stages (LlamaForCausalLM.pipeline_stages), the
    loss ParallelCrossEntropy and activation_spec on, M 2: the loss and
    every gradient gathered whole, and the bytes sent between stages."""
    from paddle_tpu_torch.distributed.fleet import (ParallelCrossEntropy, PipelineParallel,
                                                    gather_pipeline_tree)
    from paddle_tpu_torch.models import llama as L

    model = L.LlamaForCausalLM(L.LlamaConfig.tiny(sequence_parallel=True), device="cpu",
                               dtype=torch.float32, seed=0)
    L.load_reference_state_dict(model, dict(np.load(weights)))
    d = np.load(data)
    ids, labels = _t(d["ids0"]), _t(d["labels0"])
    first, layers, last = model.pipeline_stages()
    pp = PipelineParallel(first, layers, last, ParallelCrossEntropy(),
                          mesh=_hy_mesh("pp_mp"), num_microbatches=2, activation_spec=HY_SPEC)
    C.reset_stats()
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    stats = C.stats()
    tree = gather_pipeline_tree(grads, pp)
    _pp_save_tree(out, "hy_llama", tree, loss=loss, sent=np.array(stats["bytes"].get("send", 0)))


# ---------------------------------------------------------------------------
# context parallelism across processes: the ring, Ulysses, the Llama
# ---------------------------------------------------------------------------

#: the reference's tiny ring configuration (tests/test_distributed.py:263-270)
TINY_RING = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                 use_flash_attention=False)
#: mesh kind -> (shape, names); "d0" holds independent replicas of a sep-2 world
CP_MESHES = {"sep2": ([2, 2], ["d0", "sep"]), "sep4": ([4], ["sep"]),
             "dp_sep": ([2, 2], ["dp", "sep"]), "sharding_sep": ([2, 2], ["sharding", "sep"]),
             "sep_tensor": ([2, 2], ["sep", "mp"]), "pp_sep": ([2, 2], ["pp", "sep"]),
             "cp4": ([4], ["cp"]), "sep4_tensor": ([4, 2], ["sep", "mp"])}


def _cp_mesh(kind):
    shape, names = CP_MESHES[kind]
    return dist.ProcessMesh(shape=shape, dim_names=names)


def _cp_local(t, link):
    n = t.shape[1] // link.size
    return t[:, link.index * n:(link.index + 1) * n].contiguous()


def cp_ring(out, data):
    """The ring across processes at P 2 and 4 (the cp axis at 4), causal
    and not, Hk 1 / 2 / 4, on the flash schedule over the plain kernels and
    on the composed ring: this rank's output, dQ, dK, dV of
    ``sum(out * do)``, and the same rank's rows of the one-process ring
    over the whole inputs; then the ring's bytes a hop at P 2."""
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import context_link
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops import ring_flash as rf

    d = np.load(data)
    res = {}
    for kind, axis in (("sep2", "sep"), ("cp4", "cp")):
        mesh = _cp_mesh(kind)
        link = context_link(axis, mesh)
        P = link.size
        for causal in (True, False):
            for hk in (1, 2, 4):
                q, k, v, do = (_t(d[f"{x}_{int(causal)}_{hk}"]) for x in ("q", "k", "v", "do"))
                for sched in ("flash", "composed"):
                    fn = rf.ring_flash_attention if sched == "flash" else ra.ring_attention
                    ts = [_cp_local(t, link).requires_grad_(True) for t in (q, k, v)]
                    C.reset_stats()
                    o = fn(*ts, P, causal, link=link)
                    o.backward(_cp_local(do, link))
                    tag = f"{P}_{sched}_{int(causal)}_{hk}"
                    res[f"out_{tag}"] = o.detach()
                    for name, t in zip("qkv", ts):
                        res[f"d{name}_{tag}"] = t.grad
                    res[f"sent_{tag}"] = np.array(C.stats()["bytes"].get("send", 0))
                    gs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
                    one = fn(*gs, P, causal)
                    one.backward(do)
                    res[f"one_out_{tag}"] = _cp_local(one.detach(), link)
                    for name, t in zip("qkv", gs):
                        res[f"one_d{name}_{tag}"] = _cp_local(t.grad, link)
    _save(out, "cp_ring", **res)


def cp_ulysses(out, data):
    """Ulysses over sep 2 (replicas on d0) and sep 4: the exchange and its
    inverse on the gathered tensor, the gradient of the exchange, and
    Ulysses attention against full attention (the plain flash over the
    whole inputs), causal, H 4 / Hk 4 and Hk 2 where they divide."""
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    from paddle_tpu_torch.ops import flash_attention as fa

    d = np.load(data)
    res = {}
    for kind in ("sep2", "sep4"):
        mesh = _cp_mesh(kind)
        dist.set_mesh(mesh)
        link = sp.context_link("sep")
        P = link.size
        x = _t(d["q_1_4"])                           # [B, S, 4, D]
        mine = _cp_local(x, link).requires_grad_(True)
        (heads, _, _) = sp.sep_all_to_all_qkv(mine, mine, mine)
        h = x.shape[2] // P
        res[f"exchange_{P}"] = np.array(torch.equal(heads, x[:, :, link.index * h:
                                                             (link.index + 1) * h]))
        back = sp.sep_all_to_all_output(heads)
        res[f"inverse_{P}"] = np.array(torch.equal(back, mine))
        back.backward(_cp_local(_t(d["do_1_4"]), link))
        res[f"exchange_grad_{P}"] = np.array(torch.equal(mine.grad, _cp_local(_t(d["do_1_4"]), link)))
        whole = x.clone().requires_grad_(True)
        part = sp.split_sequence(whole)
        part.backward(torch.ones_like(part))
        res[f"split_{P}"] = np.array(torch.equal(part, _cp_local(x, link))
                                     and float(whole.grad.sum()) == x.numel()
                                     and torch.equal(sp.split_sequence(_t(d["q_1_4"]).long()),
                                                     _cp_local(x.long(), link)))
        for hk in (4, 2):
            q, k, v, do = (_t(d[f"{n}_1_{hk}"]) for n in ("q", "k", "v", "do"))
            try:
                ts = [_cp_local(t, link).requires_grad_(True) for t in (q, k, v)]
                a, b, c = sp.sep_all_to_all_qkv(*ts)
                o = sp.sep_all_to_all_output(fa.flash_attention(a, b, c, True))
                o.backward(_cp_local(do, link))
            except ValueError as e:
                res[f"refused_{P}_{hk}"] = np.array(str(e))
                continue
            gs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            full = fa.flash_attention(*gs, True)
            full.backward(do)
            res[f"out_{P}_{hk}"] = o.detach()
            res[f"full_{P}_{hk}"] = _cp_local(full.detach(), link)
            for name, t, g in zip("qkv", ts, gs):
                res[f"d{name}_{P}_{hk}"] = t.grad
                res[f"full_d{name}_{P}_{hk}"] = _cp_local(g.grad, link)
    dist.set_mesh(None)
    _save(out, "cp_ulysses", **res)


def _cp_whole_grads(step, params, grads):
    """{name: the whole reduced gradient} through the step's reductions
    (the sharded update's, gathered over its slices, or the model's)."""
    from paddle_tpu_torch.distributed import _sharded
    from paddle_tpu_torch.distributed.tensor_parallel import gather_dim

    ps = [p for _, p in params]
    upd = getattr(step.optimizer, "_update", None)
    if upd is None:
        return {n: g for (n, _), g in zip(params, step.model.reduce_gradients(ps, grads))}
    grads = upd._reduce(ps, grads)
    out = {}
    for (n, p), g in zip(params, grads):
        info = _sharded.info_of(p)
        if info is not None and info.dim is not None:
            g = _sharded.gather_many([g.contiguous()], [info])[0]
        if info is not None and info.tdim is not None:
            g = gather_dim(g, info.tdim, info.tgroup)
        out[n] = g
    return out


def _cp_llama(weights, cp):
    from paddle_tpu_torch.models import llama as L

    model = L.LlamaForCausalLM(L.LlamaConfig(**TINY_RING, context_parallel=cp), device="cpu")
    return L.load_reference_state_dict(model, dict(np.load(weights)))


def cp_llama(out, weights, data, kind, cp, fault=0):
    """The reference's tiny ring config under ``context_parallel=cp`` on
    mesh ``kind``: the loss and every reduced gradient (whole), then two
    TrainStep calls (AdamW 0.01) and the parameters after them (whole); at
    pp 2 x sep 2 the pipeline's loss and gathered gradients, then two
    train_batch calls. ``fault`` 1: RoPE without the rank's offset. A
    Ulysses mesh whose heads do not divide saves its ValueError."""
    from paddle_tpu_torch.models import llama as L

    d = np.load(data)
    ids, labels = _t(d["ids"]), _t(d["labels"])
    mesh = _cp_mesh(kind)
    dist.set_mesh(mesh)
    name = f"cp_llama_{kind}_{cp}_{int(fault)}"
    keep = L._rope_offset
    if fault:
        L._rope_offset = lambda link, n: 0
    try:
        if kind == "pp_sep":
            res = _cp_pipeline(weights, cp, ids, labels, mesh)
        else:
            res = _cp_train(weights, cp, ids, labels, mesh, kind)
    except ValueError as e:
        res = {"refused": np.array(str(e))}
    finally:
        L._rope_offset = keep
        _fleet_reset()
    _save(out, name, **res)


def _cp_train(weights, cp, ids, labels, mesh, kind):
    model = _cp_llama(weights, cp)
    opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters())
    if kind == "dp_sep":              # fleet: SegmentParallel over dp 2 x sep 2
        hcg = _fleet_init(dp_degree=2, sep_degree=2)
        model = dist.fleet.distributed_model(model)
        opt = dist.fleet.distributed_optimizer(opt)
        mode = hcg.get_parallel_mode()
    else:
        config = {"sharding_config": {"stage": 1}} if kind == "sharding_sep" else \
            {"mp_config": {}} if kind.endswith("tensor") else None
        model, opt = dist.parallelize(model, opt, mesh=mesh, config=config)
        mode = ""
    coord = mesh.coordinate()
    rows = slice(None)
    for a in ("dp", "sharding"):                  # a data rank's rows
        if a in coord:
            n = ids.shape[0] // mesh.get_dim_size(a)
            rows = slice(coord[a] * n, (coord[a] + 1) * n)
    ids, labels = ids[rows], labels[rows]
    step = paddle.jit.TrainStep(model, opt, lambda x, y: model(x, labels=y)[0])
    params = step._params()
    loss, grads = step._loss_and_grads(params, (ids, labels))
    res = {"loss": loss, "mode": np.array(mode),
           "wrapped": np.array(type(model).__name__),
           **{f"grad/{n.removeprefix('_layers.')}": g
              for n, g in _cp_whole_grads(step, params, grads).items()}}
    res["losses"] = torch.stack([step(ids, labels) for _ in range(2)])
    inner = getattr(model, "_layers", model)
    for n, v in _whole_params(dict(inner.named_parameters())).items():
        res[f"param/{n}"] = v
    return res


def _cp_pipeline(weights, cp, ids, labels, mesh):
    from paddle_tpu_torch.distributed.fleet import PipelineParallel, gather_pipeline_tree

    model = _cp_llama(weights, cp)
    first, layers, last = model.pipeline_stages()

    def loss_fn(logits, lab):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), lab.reshape(-1))

    pp = PipelineParallel(first, layers, last, loss_fn, mesh=mesh, num_microbatches=2)
    C.reset_stats()
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    sent = C.stats()["bytes"].get("send", 0)
    tree = gather_pipeline_tree(grads, pp)
    named = {"llama.embed_tokens.weight": tree["first"]["embed_tokens.weight"],
             "llama.norm.weight": tree["last"]["norm.weight"],
             "lm_head.weight": tree["last"]["lm_head.weight"]}
    for k, arr in tree["stack"].items():
        for p in range(2):
            named[f"llama.layers.{p}.{k}"] = arr[p, 0]
    opt = paddle.optimizer.AdamW(learning_rate=0.01, parameters=model.parameters())
    losses = torch.stack([pp.train_batch((ids, labels), opt) for _ in range(2)])
    pp.sync_to_model()
    res = {"loss": loss, "losses": losses, "sent": np.array(sent),
           **{f"grad/{n}": g for n, g in named.items()}}
    for n, v in model.named_parameters():
        res[f"param/{n}"] = v.detach()
    return res


def cp_axes(out):
    """What waited for this slice builds over 4 ranks: a mesh's sep beside
    dp, sharding, fsdp, the tensor axis and the pipe axis (its groups), the
    cp axis, fleet at sep_degree 2 beside dp (the mode, the sep group, the
    wrapper distributed_model returns), and the ep axis (its group)."""
    from paddle_tpu_torch.distributed.fleet import SegmentParallel

    res = {}
    for name, (shape, names) in {"sep_dp": ([2, 2], ["dp", "sep"]),
                                 "sep_sharding": ([2, 2], ["sharding", "sep"]),
                                 "sep_fsdp": ([2, 2], ["fsdp", "sep"]),
                                 "sep_mp": ([2, 2], ["sep", "mp"]),
                                 "pipe_sep": ([2, 2], ["pp", "sep"]),
                                 "cp": ([4], ["cp"])}.items():
        mesh = dist.ProcessMesh(shape=shape, dim_names=names)
        axis = "cp" if "cp" in names else "sep"
        res[name] = np.array(mesh.shape + mesh.get_group(axis).ranks
                             + [mesh.coordinate()[axis]])
    hcg = _fleet_init(dp_degree=2, sep_degree=2)
    model = dist.fleet.distributed_model(paddle.nn.Linear(4, 4, device="cpu"))
    res["fleet"] = np.array([str(x) for x in (
        hcg.get_parallel_mode(), hcg.get_sep_parallel_world_size(),
        hcg.get_sep_parallel_rank(), hcg.get_sep_parallel_group().ranks,
        hcg.get_data_parallel_group().ranks, isinstance(model, SegmentParallel),
        type(model).__name__)])
    _fleet_reset()
    mesh = dist.ProcessMesh(shape=[4], dim_names=["ep"])
    res["ep"] = np.array(mesh.shape + mesh.get_group("ep").ranks)
    _save(out, "cp_axes", **res)


#: the tiny MoE Llama of the expert-parallel tests: 4 experts, a capacity
#: factor at which tokens drop (C 16 of the global batch's 64 tokens)
TINY_MOE = dict(TINY_RING, moe_num_experts=4, moe_capacity_factor=0.5)
MOE_AUX = 0.02
#: kind -> (how, axes): the partitioner's program mesh or parallelize's
EP_MESHES = {"dp2": ("part", {"dp": 2}), "tensor2": ("part", {"tensor": 2}),
             "par_dp2": ("par", {"dp": 2}), "par_ep2": ("par", {"ep": 2}),
             "dp2_tensor2": ("part", {"dp": 2, "tensor": 2}),
             "dp2_fsdp2": ("part", {"dp": 2, "fsdp": 2}),
             "par_dp2_ep2": ("par", {"dp": 2, "ep": 2}), "one": ("part", {"dp": 1}),
             "par_sh2s1": ("par", {"sharding": 2}), "par_sh2s3": ("par", {"sharding": 2})}
#: kind -> parallelize's sharding stage (else none)
EP_STAGES = {"par_sh2s1": 1, "par_sh2s3": 3}


def _moe_llama(weights, top_k=2):
    from paddle_tpu_torch.models import llama as L

    model = L.LlamaForCausalLM(L.LlamaConfig(**TINY_MOE, moe_top_k=int(top_k)), device="cpu")
    return L.load_reference_state_dict(model, dict(np.load(weights)))


def _moe_loss(model):
    inner = getattr(model, "_layers", model)

    def loss_fn(ids, labels):
        ce = model(ids, labels=labels)[0]
        return ce + MOE_AUX * sum(lyr.mlp.aux_loss for lyr in inner.llama.layers)
    return loss_fn


def _moe_opt(model):
    return paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                  weight_decay=0.1, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def _ep_step(model, kind):
    """``(step, rows)``: the train step of ``kind`` and the function giving
    a batch as the step takes it and as this rank computes on it."""
    from paddle_tpu_torch.distributed.partitioning import Partitioner, PartitionedTrainStep

    how, axes = EP_MESHES[kind]
    opt = _moe_opt(model)
    if how == "part":
        part = Partitioner(dist.build_program_mesh(**axes))
        step = PartitionedTrainStep(model, opt, _moe_loss(model), partitioner=part)
        return step, (lambda t: t), part.shard_batch
    mesh = dist.auto_mesh(**axes)
    model, opt = dist.parallelize(model, opt, mesh=mesh,
                                  config={"sharding_config": {"stage": EP_STAGES.get(kind, 0)}})
    coord, index, n = mesh.coordinate(), 0, 1
    for a in mesh.dim_names:        # the batch axes, in order
        if a in ("dcn", "dp", "sharding"):
            index, n = index * mesh.get_dim_size(a) + coord[a], n * mesh.get_dim_size(a)

    def rows(t):
        k = t.shape[0] // n
        return t[index * k:(index + 1) * k]
    return paddle.jit.TrainStep(model, opt, _moe_loss(model)), rows, rows


class _Decisions:
    """Records what the routing functions of ``fleet.moe`` return while
    active: each call's logits, and the dense combine or the sort's slots."""

    def __init__(self):
        from paddle_tpu_torch.distributed.fleet import moe

        self.moe, self.calls, self.keep = moe, [], {}

    def __enter__(self):
        for name in ("topk_routing", "top1_gating", "top2_gating", "sort_slots"):
            fn = self.keep[name] = getattr(self.moe, name)
            setattr(self.moe, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*a, **k):
            got = fn(*a, **k)
            if name == "topk_routing":
                self.calls.append({"logits": a[0].detach().clone()})
            elif name == "sort_slots":
                order, se, stok, cpos, valid = got
                self.calls[-1]["sort"] = torch.stack([stok, se, cpos, valid.long()])
            else:
                self.calls[-1]["dense"] = got[0].detach().clone()
            return got
        return call

    def __exit__(self, *exc):
        for name, fn in self.keep.items():
            setattr(self.moe, name, fn)


def ep_llama(out, weights, data, kind, dispatch, top_k=2, fault=0):
    """The tiny MoE Llama (``TINY_MOE``, loss plus 0.02 x the layers' aux)
    on mesh ``kind`` under ``dispatch``: the first batch's loss, each
    layer's routing on this rank's rows (logits and decisions), the bytes of
    the all-to-all, every reduced gradient (whole), then 3 steps and the
    parameters after them (whole). ``fault`` 1: every rank routes its rows
    alone (``dist_train.routing_alone``)."""
    import contextlib
    import json

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import _sharded
    from paddle_tpu_torch.tools.dist_train import routing_alone

    d = np.load(data)
    flags.set_flags({"moe_dispatch": dispatch})
    try:
        model = _moe_llama(weights, top_k)
        step, batch, rows = _ep_step(model, kind)
        params = step._params()
        C.reset_stats()
        with routing_alone() if int(fault) else contextlib.nullcontext(), \
                _Decisions() as rec:
            loss, grads = step._loss_and_grads(params, (rows(_t(d["ids0"])),
                                                        rows(_t(d["labels0"]))))
        stats = C.stats()
        res = {"loss0": loss, "stats": np.array(json.dumps(stats)),
               **{f"grad/{n.removeprefix('_layers.')}": g
                  for n, g in _cp_whole_grads(step, params, grads).items()}}
        for i, call in enumerate(rec.calls):
            res.update({f"route{i}/{k}": v for k, v in call.items()})
        res["losses"] = torch.stack([step(batch(_t(d[f"ids{i}"])), batch(_t(d[f"labels{i}"])))
                                     for i in range(3)])
        inner = getattr(step.model, "_layers", step.model)
        for n, v in _whole_params(dict(inner.named_parameters())).items():
            res[f"param/{n}"] = v
        plans = [lyr.mlp._ep for lyr in inner.llama.layers]
        res["plan"] = np.array([p.experts if p is not None else "none" for p in plans])
        w = inner.llama.layers[0].mlp.w_gate
        res["local_experts"] = np.array(w.shape[0])
        # the share of an expert weight's AdamW moment this rank keeps
        info = _sharded.info_of(w)
        moments = [v for v in step.optimizer._update.state_of(type(step.optimizer._inner_opt),
                                                              w).values()
                   if torch.is_tensor(v) and v.ndim]
        res["expert_state"] = np.array(moments[0].numel() / np.prod(
            info.full_shape if info is not None else w.shape))
    finally:
        flags.set_flags({"moe_dispatch": ""})
        _fleet_reset()
    _save(out, f"ep_llama_{kind}_{dispatch}_{top_k}_{int(fault)}", **res)


def ep_dp(out, weights, data):
    """Eager DataParallel over the world: rank r routes its batch r alone,
    as the reference's eager DataParallel does; the reduced gradients."""
    d = np.load(data)
    model = dist.DataParallel(_moe_llama(weights))
    step = paddle.jit.TrainStep(model, _moe_opt(model), _moe_loss(model))
    r = dist.get_rank()
    params = step._params()
    loss, grads = step._loss_and_grads(params, (_t(d[f"ids{r}"]), _t(d[f"labels{r}"])))
    _save(out, "ep_dp", loss0=loss,
          **{f"grad/{n.removeprefix('_layers.')}": g
             for n, g in _cp_whole_grads(step, params, grads).items()})


def _ep_state(step):
    """Every parameter and optimizer moment of the step, whole."""
    from paddle_tpu_torch.distributed import _sharded

    out = {f"param/{k}": v.clone()
           for k, v in _whole_params(dict(step.model.named_parameters())).items()}
    inner = step.optimizer._inner_opt
    for name, p in step.model.named_parameters():
        for slot, v in step.optimizer._update.state_of(type(inner), p).items():
            if torch.is_tensor(v) and v.ndim:
                out[f"opt/{name}/{slot}"] = _sharded.gather_full(v).detach().clone()
    return out


def ep_ckpt(out, weights, data, load_from, save_to, tag):
    """The partitioned step at dp = world: load ``load_from`` (or take 2
    steps), save the state to ``save_to`` (if any), record it whole, then
    run the third batch."""
    d = np.load(data)
    model = _moe_llama(weights)
    step, _, _ = _ep_step(model, "dp2" if dist.get_world_size() == 2 else "one")
    if load_from:
        info = dist.partitioning.load_partitioned(step, load_from)
    else:
        info = {"resharded": False}
        for i in range(2):
            step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"]))
    if save_to:
        dist.partitioning.save_partitioned(step, save_to)
    res = {**_ep_state(step), "resharded": np.array(info["resharded"]),
           "count": np.array(step.optimizer._inner_opt._step_count)}
    res["loss3"] = step(_t(d["ids2"]), _t(d["labels2"]))
    res["plan"] = np.array(str(model.llama.layers[0].mlp._ep is not None))
    _save(out, f"ep_ckpt_{tag}", **res)


def ep_axes(out):
    """What waited for this slice builds: a mesh's ep axis and its group,
    ep beside dp, and a MoE Llama under a tensor axis."""
    from paddle_tpu_torch.distributed.partitioning import Partitioner
    from paddle_tpu_torch.models import llama as L

    n = dist.get_world_size()
    res = {}
    mesh = dist.ProcessMesh(shape=[n], dim_names=["ep"])
    res["ep"] = np.array(mesh.shape + mesh.get_group("ep").ranks)
    mesh = dist.auto_mesh(dp=n // 2, ep=2)
    res["dp_ep"] = np.array(mesh.shape + mesh.get_group("ep").ranks + mesh.get_group("dp").ranks)
    model = L.LlamaForCausalLM(L.LlamaConfig(**TINY_MOE), device="cpu")
    Partitioner(dist.build_program_mesh(tensor=2, dp=n // 2)).shard_model(model)
    res["moe_tensor"] = np.array(list(model.llama.layers[0].mlp.w_gate.shape)
                                 + [model.llama.layers[0].mlp._ep.experts == "tensor"])
    dist.set_mesh(None)
    # all_to_all_single with a split of 0 rows, in bf16 (gloo: staged as f32)
    r = dist.get_rank()
    src = torch.arange(6, dtype=torch.bfloat16).reshape(3, 2) + 10 * r
    send = [3, 0] if r == 0 else [2, 0]
    got = torch.empty(((3 + 2) if r == 0 else 0, 2), dtype=torch.bfloat16)
    C.all_to_all_single(got, src[:sum(send)], out_split_sizes=[3, 2] if r == 0 else [0, 0],
                        in_split_sizes=send)
    res["a2a_zero"] = got.float()
    # an MoE Llama under context parallelism across processes is refused
    with dist.ProcessMesh(shape=[n], dim_names=["sep"]):
        model = L.LlamaForCausalLM(L.LlamaConfig(**TINY_MOE, context_parallel="ring"),
                                   device="cpu")
        try:
            model(torch.zeros(1, 8, dtype=torch.long))
            res["moe_sep"] = np.array("no raise")
        except NotImplementedError as e:
            res["moe_sep"] = np.array(str(e))
    # the measured dispatch of a layer routed over the world: the probe (forced
    # at a tiny shape) is keyed on the global batch's T
    from paddle_tpu_torch.distributed.fleet import moe

    keep = moe._SMALL, dict(moe._DISPATCH_CHOICE)
    moe._SMALL = 0
    moe._DISPATCH_CHOICE.clear()
    try:
        layer = moe.MoELayer(16, 24, 4, device="cpu")
        layer._ep = moe.ExpertPlan(C._world())
        layer(torch.randn(3 + r, 8, 16))
        res["dispatch_keys"] = np.array([k[:3] for k in moe._DISPATCH_CHOICE])
    finally:
        moe._SMALL = keep[0]
        moe._DISPATCH_CHOICE.clear()
        moe._DISPATCH_CHOICE.update(keep[1])
    _save(out, "ep_axes", **res)


def fail(out):
    """Rank 1 raises at once; the others would sleep a minute."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)


def spawned(out):
    """The body of ``spawn``'s test: a sum over the ranks."""
    paddle.set_device("cpu")
    dist.init_parallel_env(timeout=120)
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    _save(out, "spawned", total=t)


CASES = {"collectives": collectives, "dp": dp, "zero": zero, "partitioned": partitioned, "partitioned_accum": partitioned_accum,
         "fleet_sharding": fleet_sharding,
         "ckpt_save": ckpt_save, "ckpt_load": ckpt_load, "fleet_merge": fleet_merge,
         "mp_layers": mp_layers, "tp_partitioned": tp_partitioned, "tp_ckpt": tp_ckpt,
         "tp_fleet": tp_fleet, "semi_auto": semi_auto, "fail": fail, "pp_grads": pp_grads,
         "pp_train": pp_train, "pp_frozen": pp_frozen, "pp_remat": pp_remat,
         "pp_apply": pp_apply, "pp_dp": pp_dp, "pp_rules": pp_rules, "pp_llama": pp_llama,
         "hybrid_axes": hybrid_axes, "hy_grads": hy_grads, "hy_train": hy_train,
         "hy_mp_sharding": hy_mp_sharding, "hy_llama": hy_llama, "hy_pp_layers": hy_pp_layers,
         "cp_ring": cp_ring, "cp_ulysses": cp_ulysses, "cp_llama": cp_llama, "cp_axes": cp_axes,
         "ep_llama": ep_llama, "ep_dp": ep_dp, "ep_ckpt": ep_ckpt, "ep_axes": ep_axes}


def main():
    import json

    out, spec = sys.argv[1], json.loads(sys.argv[2])
    paddle.set_device("cpu")
    # one intra-op thread a rank: up to 4 ranks share the cores with the
    # other test processes, and the cases are small
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_parallel_env(timeout=120)
    for case, *args in spec:
        CASES[case](out, *args)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()


class Launch:
    """``run_ranks`` in a thread, so that the test computes the reference's
    side meanwhile; ``str()`` waits for the ranks and gives ``tmp``."""

    def __init__(self, tmp, nproc, spec):
        import concurrent.futures

        self.tmp = tmp
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._fut = self._pool.submit(run_ranks, tmp, nproc, spec)

    def __str__(self):
        rc, logs = self._fut.result()
        self._pool.shutdown()
        assert rc == 0, logs
        return self.tmp


def run_ranks(tmp, nproc, spec, timeout=240):
    """Launch ``nproc`` ranks of this script through the port's launcher with
    the cases ``spec``, writing under ``tmp``; on a failure or past
    ``timeout`` seconds every rank is stopped and the logs are raised."""
    import json
    import signal
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    log = os.path.join(tmp, f"log.{nproc}")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
           str(nproc), "--log_dir", log, str(root / "tests" / "torch_dist_worker.py"),
           str(tmp), json.dumps(spec)]
    proc = subprocess.Popen(cmd, cwd=str(root), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        out = f"timed out after {timeout} s\n{out}"
    logs = "".join(f"--- rank {r} ---\n" + open(os.path.join(log, f"workerlog.{r}")).read()
                   for r in range(nproc) if os.path.exists(os.path.join(log, f"workerlog.{r}")))
    return proc.returncode, out + logs


def load(tmp, name, nproc):
    """``OUT/name.<rank>.npz`` of every rank."""
    return [dict(np.load(os.path.join(tmp, f"{name}.{r}.npz"))) for r in range(nproc)]
