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
    res["stat_kinds"] = np.array(sorted(stats["calls"]))
    res["stat_fused_calls"] = np.array(stats["calls"]["fused_allreduce"])
    _save(out, "collectives", **res)


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


def partitioned(out, weights, data, dp_, fsdp, clip, policy="none"):
    """PartitionedTrainStep on a tiny Llama over dp x fsdp, 3 steps, under
    the recompute ``policy``."""
    d = np.load(data)
    mesh = dist.build_program_mesh(dp=int(dp_), fsdp=int(fsdp))
    model = _llama(weights)
    step = _llama_step(model, float(clip), mesh, policy)
    C.reset_stats()
    res = {"losses": [], "clip_scales": []}
    for i in range(3):
        res["losses"].append(step(_t(d[f"ids{i}"]), _t(d[f"labels{i}"])))
        res["clip_scales"].append(step.optimizer._update.last_clip_scale)
    res = {k: torch.stack(v) for k, v in res.items()}
    res["param_bytes"] = np.array(_bytes(model.parameters()))
    res["moment_bytes"] = np.array(_bytes(t for st in step.optimizer._update.states.values()
                                          for t in st.values()))
    res["all_gathers"] = np.array(C.stats()["calls"]["all_gather"])
    for k, v in _gathered(model).items():
        res[f"param.{k}"] = v
    _save(out, f"partitioned_{dp_}x{fsdp}_{policy}", **res)


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


CASES = {"collectives": collectives, "dp": dp, "zero": zero, "partitioned": partitioned,
         "fleet_sharding": fleet_sharding,
         "ckpt_save": ckpt_save, "ckpt_load": ckpt_load, "fleet_merge": fleet_merge,
         "fail": fail}


def main():
    import json

    out, spec = sys.argv[1], json.loads(sys.argv[2])
    paddle.set_device("cpu")
    torch.manual_seed(0)
    dist.init_parallel_env(timeout=120)
    for case, *args in spec:
        CASES[case](out, *args)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()


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
