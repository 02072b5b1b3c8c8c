"""PyTorch port: the distributed tier's collectives, launcher and
environment, on the CPU.

Ranks are gloo processes started through the port's launcher
(``python -m paddle_tpu_torch.distributed.launch``) running
``tests/torch_dist_worker.py``, which imports only the port; each wait has
its own limit and a failure stops every rank and shows their logs. Every
collective of ``paddle_tpu_torch.distributed`` runs at 2 and at 4 ranks on
seeded inputs and is held against numpy and against the reference's
collectives under ``shard_map`` over as many devices of the conftest's CPU
mesh (``ReduceOp`` SUM/MAX/MIN/PROD/AVG, the gathers, ``reduce_scatter``,
``all_to_all``). Tolerance: a reduction of 2 or 4 f32 values in another
order, 1e-6 relative; moves are exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_worker as W

RTOL = ATOL = 1e-6

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"coll{n}")
        rc, logs = W.run_ranks(str(tmp), n, [["collectives"]])
        assert rc == 0, logs
        out[n] = W.load(str(tmp), "collectives", n)
    return out


def _x(n):
    return [W.inputs(r) for r in range(n)]


def _big(n):
    return [W.inputs(r, (n * 2, 3)) for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_reductions_match_numpy(ranks, n):
    xs = np.stack(_x(n))
    want = {"SUM": xs.sum(0), "MAX": xs.max(0), "MIN": xs.min(0), "PROD": xs.prod(0),
            "AVG": xs.mean(0)}
    for r, got in enumerate(ranks[n]):
        for op, w in want.items():
            np.testing.assert_allclose(got[f"all_reduce_{op}"], w, rtol=RTOL, atol=ATOL)
        big = np.stack(_big(n)).sum(0)
        np.testing.assert_allclose(got["reduce_scatter_tensor"], big[2 * r:2 * r + 2],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got["reduce_scatter_list"], got["reduce_scatter_tensor"])
        if r == 1:      # only the destination's result is defined
            np.testing.assert_allclose(got["reduce_dst1"], xs.sum(0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_moves_are_exact(ranks, n):
    xs, bigs = _x(n), _big(n)
    for r, got in enumerate(ranks[n]):
        for key in ("all_gather_list", "all_gather_stack"):
            np.testing.assert_array_equal(got[key], np.stack(xs))
        np.testing.assert_array_equal(got["all_gather_tensor"], np.concatenate(xs))
        np.testing.assert_array_equal(got["all_gather_object"], np.arange(n))
        a2a = np.concatenate([bigs[j][2 * r:2 * r + 2] for j in range(n)])
        np.testing.assert_array_equal(got["all_to_all"], a2a)
        np.testing.assert_array_equal(got["all_to_all_gloo_without_list"], a2a)
        np.testing.assert_array_equal(got["all_to_all_single"], a2a)
        # uneven: rank j sends rows [sum(1..r), +r+1) of its input to rank r
        start = sum(range(1, r + 1))
        rows = sum(range(1, n + 1))
        uneven = np.concatenate([W.inputs(j, (rows, 3))[start:start + r + 1] for j in range(n)])
        np.testing.assert_array_equal(got["all_to_all_uneven"], uneven)
        np.testing.assert_array_equal(got["broadcast"], xs[1])
        assert str(got["broadcast_object"]) == f"from {n - 1}"
        np.testing.assert_array_equal(got["scatter"], W.inputs(10 + r))
        if r == 0:
            np.testing.assert_array_equal(got["gather"], np.stack(xs))


@pytest.mark.parametrize("n", [2, 4])
def test_point_to_point_and_subgroups(ranks, n):
    xs = _x(n)
    for r, got in enumerate(ranks[n]):
        for key in ("batch_isend_irecv", "send_recv"):
            np.testing.assert_array_equal(got[key], xs[(r - 1) % n])
        if r in (0, n - 1):
            np.testing.assert_allclose(got["new_group_pair"], xs[0] + xs[n - 1], rtol=RTOL)
        else:     # outside the pair: its all_reduce raised, the tensor is untouched
            np.testing.assert_array_equal(got["new_group_pair"], xs[r])
        half = list(range(n // 2)) if r < n // 2 else list(range(n // 2, n))
        np.testing.assert_array_equal(got["split_group_ranks"], half)
        np.testing.assert_allclose(got["split_group"], sum(xs[j] for j in half), rtol=RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_fused_allreduce_and_the_counters(ranks, n):
    xs = _x(n)
    for got in ranks[n]:
        np.testing.assert_allclose(got["fused_a"], sum(xs), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["fused_b0"], 2 * sum(x.astype(np.float64) for x in xs),
                                   rtol=1e-12)
        np.testing.assert_array_equal(got["fused_b1"], n * np.arange(3.0))
        assert str(got["fused_b0_dtype"]) == "torch.float64"
        # one all-reduce for each of the tree's two dtypes
        assert int(got["stat_fused_calls"]) == 2
        assert {"all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
                "send", "recv", "barrier"} <= set(got["stat_kinds"].tolist())


def _ref_collectives(n):
    """The reference's collectives under shard_map over n devices: shard r
    holds rank r's input."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as rdist
    from paddle_tpu.tensor import Tensor

    mesh = rdist.ProcessMesh(shape=[n], dim_names=["dp"])
    g = rdist.new_group(list(range(n)), axis_name="dp")
    ops = ("SUM", "MAX", "MIN", "PROD", "AVG")

    def f(a, b):
        out = [rdist.all_reduce(Tensor(a), op=getattr(rdist.ReduceOp, op), group=g)._data
               for op in ops]
        out.append(rdist.all_gather(None, Tensor(a), group=g)._data)
        rs = Tensor(jax.numpy.zeros((2, 3), a.dtype))
        out.append(rdist.reduce_scatter(rs, Tensor(b), group=g)._data)
        out.append(rdist.all_to_all(None, Tensor(b), group=g)._data)
        return tuple(out)

    sm = shard_map(f, mesh=mesh.jax_mesh, in_specs=(P("dp"), P("dp")),
                   out_specs=tuple(P("dp") for _ in range(len(ops) + 3)))
    res = jax.jit(sm)(np.concatenate(_x(n)), np.concatenate(_big(n)))
    names = [f"all_reduce_{op}" for op in ops] + ["all_gather_stack", "reduce_scatter_tensor",
                                                  "all_to_all_single"]
    return {k: np.asarray(v) for k, v in zip(names, res)}


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_the_reference_shard_map(ranks, n):
    ref = _ref_collectives(n)
    for r, got in enumerate(ranks[n]):
        for key, want in ref.items():
            part = np.split(want, n)[r]
            if key == "all_gather_stack":
                part = part.reshape(n, 4, 3)
            np.testing.assert_allclose(got[key], part, rtol=RTOL, atol=ATOL, err_msg=key)


def test_launch_stops_the_other_ranks_when_one_fails(tmp_path):
    """Rank 1 raises at once while rank 0 would sleep a minute: the
    launcher stops rank 0 and exits with 1 well before that."""
    import time

    t0 = time.monotonic()
    rc, logs = W.run_ranks(str(tmp_path), 2, [["fail"]], timeout=50)
    assert rc == 1, logs
    assert time.monotonic() - t0 < 45
    assert "rank 1 exited with code 1" in logs and "fails on purpose" in logs


def test_spawn_runs_a_function_on_each_rank(tmp_path):
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_dist_worker as w; "
            "from paddle_tpu_torch.distributed import spawn; "
            f"spawn(w.spawned, args=({str(tmp_path)!r},), nprocs=2, timeout=120)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=150)
    assert out.returncode == 0, out.stderr
    for got in W.load(str(tmp_path), "spawned", 2):
        np.testing.assert_array_equal(got["total"], [3.0])


@pytest.fixture
def port_device():
    from paddle_tpu_torch import device

    saved = device._current
    yield device
    device._current = saved


def test_sampler_takes_rank_and_world_from_env(monkeypatch):
    from paddle_tpu_torch.io import DistributedBatchSampler

    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    s = DistributedBatchSampler(list(range(10)), batch_size=2)
    assert (s.nranks, s.local_rank) == (3, 1)
    assert [i for b in s for i in b] == [1, 4, 7, 0]
    assert DistributedBatchSampler(list(range(4)), 1, num_replicas=2, rank=0).nranks == 2


def test_no_fallback_hides_the_device(port_device, monkeypatch):
    """NCCL on the CPU, a card that is not there, two ranks on one card
    under NCCL: each raises, none drops to gloo or to the CPU."""
    import torch

    from paddle_tpu_torch.distributed import env

    port_device.set_device("cpu")
    with pytest.raises(RuntimeError, match="NCCL needs the card"):
        env.init_parallel_env(backend="nccl")
    port_device._current = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.init_parallel_env()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "2")
    with pytest.raises(RuntimeError, match=r"local ranks \[0, 1\] would share cuda:0"):
        env.init_parallel_env(backend="nccl")
    assert not env.is_initialized()


@pytest.mark.parametrize("case", ["elastic", "localsgd"])
def test_the_axes_that_wait_raise(case):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import launch

    calls = {
        "elastic": lambda: launch.launch(["--max_restart", "1", "x.py"]),
        "localsgd": lambda: _localsgd(dist),
    }
    with pytest.raises(NotImplementedError, match="wait"):
        calls[case]()


@pytest.mark.parametrize("case", ["ep", "moe_tensor"])
def test_what_waited_for_expert_parallelism_now_builds(case):
    """These ids raised until the expert-parallel slice: an ``ep`` axis,
    and an MoE Llama under the partitioner's tensor axis (the rules put
    its experts there). Building needs no process group; placing needs the
    world (``tests/test_torch_expert_parallel.py``)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.partitioning import Partitioner
    from paddle_tpu_torch.models import llama

    assert "ep" not in M.WAITING_AXES and not M.WAITING_AXES
    if case == "ep":
        mesh = dist.ProcessMesh(shape=[2], dim_names=["ep"])
        assert mesh.get_dim_size("ep") == 2 and mesh.dim_names == ["ep"]
        return
    part = Partitioner(dist.build_program_mesh(tensor=2))
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(moe_num_experts=2), device="cpu")
    specs = {n: part.param_spec(p) for n, p in model.named_parameters()}
    assert specs["llama.layers.0.mlp.w_gate"][0] == "tensor"
    assert specs["llama.layers.0.mlp.gate.gate.weight"] == (None, None)


@pytest.mark.parametrize("case", ["cp", "sep_and_dp", "llama_ulysses", "pipe_and_sep"])
def test_what_waited_for_sep_across_processes_now_builds(case):
    """These ids raised until the context-parallel slice (sep across
    processes): the cp axis, sep beside dp and beside the pipe axis build
    (their groups over processes: tests/test_torch_context_parallel.py),
    and a Llama takes context_parallel="ulysses"."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models import llama

    if case == "llama_ulysses":
        model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(context_parallel="ulysses"),
                                       device="cpu")
        assert model.config.context_parallel == "ulysses" and model.takes_global_sequence
        return
    shape, names = {"cp": ([2], ["cp"]), "sep_and_dp": ([2, 2], ["dp", "sep"]),
                    "pipe_and_sep": ([2, 2], ["pp", "sep"])}[case]
    mesh = dist.ProcessMesh(shape=shape, dim_names=names)
    assert mesh.shape == shape and mesh.dim_names == names


@pytest.mark.parametrize("case", ["pipe", "pp", "program_pipe"])
def test_the_pipe_axes_build(ranks, case):
    """What waited for the pipeline slice builds over worlds of 2 and 4: a
    mesh's ``pipe`` / ``pp`` axis, its stage group (every rank, in stage
    order) and the program mesh's pipe axis beside dp (its stage group and
    its data group)."""
    for n, rank, got in [(n, r, g) for n in (2, 4) for r, g in enumerate(ranks[n])]:
        row = list(got[f"axis_{case}"])
        if case in ("pipe", "pp"):
            assert row == [n] + list(range(n)) + list(range(n))
        else:
            dp = rank // 2
            assert row == [n // 2, 2, 1, 1, 2 * dp, 2 * dp + 1] + list(range(rank % 2, n, 2))


@pytest.mark.parametrize("case", ["tensor", "mp", "program_tensor", "topology_mp", "llama_sep"])
def test_the_tensor_axes_build(ranks, case):
    """What waited for the tensor-parallel slice builds over worlds of 2 and
    4: a mesh's ``tensor`` / ``mp`` axis and its group (every rank in
    order), the program mesh's tensor group, fleet's topology at mp 2 (the
    model group's size, rank and source) and a Llama with sequence
    parallelism."""
    for n, rank, got in [(n, r, g) for n in (2, 4) for r, g in enumerate(ranks[n])]:
        row = list(got[f"axis_{case}"])
        if case in ("tensor", "mp"):
            assert row == [n] + list(range(n))
        elif case == "program_tensor":
            assert row == [1, 1, n // 2, 2, rank - rank % 2, rank - rank % 2 + 1]
        elif case == "topology_mp":
            src = rank - rank % 2
            assert row == [2, rank % 2, src, src, src + 1, 1]
        else:
            assert row[0] == 1 and row[1] > 0


def _localsgd(dist):
    strategy = dist.fleet.DistributedStrategy()
    strategy.localsgd = True
    dist.fleet.Fleet().distributed_optimizer(object(), strategy)


def test_a_mesh_over_processes_and_its_helpers():
    from paddle_tpu_torch import distributed as dist

    mesh = dist.build_program_mesh(dp=2, fsdp=2)
    assert mesh.dim_names == ["dp", "pipe", "fsdp", "tensor"] and mesh.shape == [2, 1, 2, 1]
    assert mesh.get_rank_by_dim_and_process_id("fsdp", 3) == 1
    assert mesh.get_rank_by_dim_and_process_id("dp", 2) == 1
    assert dist.init_mesh_from_topology(dp=2, sharding=2).dim_names == [
        "pp", "dp", "sharding", "sep", "mp"]
    assert dist.init_hybrid_mesh(dcn=2, dp=2).shape == [2, 1, 2, 1, 1, 1]
    topo = dist.fleet.CommunicateTopology(dims=[2, 1, 2, 1, 1])
    assert topo.get_comm_list("sharding") == [[0, 1], [2, 3]]
    assert topo.get_comm_list("data") == [[0, 2], [1, 3]]
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        mesh.get_group("dp")


def test_a_shard_layout_rides_on_its_tensor_only():
    """A parameter's shard layout reaches ``Layer.state_dict()``'s detached
    copy, which the sharded checkpoint reads; a tensor that does not carry
    it has none, whatever its address, shape and dtype."""
    import types

    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import _sharded

    group = types.SimpleNamespace(nranks=2, rank=1, id=0)
    lin = nn.Linear(4, 3, device="cpu")
    info = _sharded.ShardInfo((8, 3), 0, group, None, at_rest=True)
    _sharded.register(lin.weight, info)
    sd = lin.state_dict()
    assert _sharded.info_of(sd["weight"]) is info and _sharded.info_of(sd["bias"]) is None
    assert info.index == (slice(4, 8), slice(0, 3))
    ptr = lin.weight.data_ptr()
    del lin, sd
    fresh = torch.empty(4, 3)
    assert _sharded.info_of(fresh) is None, fresh.data_ptr() == ptr
