"""PyTorch port: the pipeline over gloo processes (the schedules' runtime,
``PipelineParallel`` under every style, ``train_batch``, ``sync_to_model``,
``pipeline_apply``, pp x dp), held against the reference on the conftest's
CPU mesh.

One launch of 4 ranks of ``tests/torch_dist_worker.py`` through the port's
launcher feeds every test, on the reference's model of
``tests/test_pipeline.py:25-77`` (V 64, H 16, S 8, B 8, f32) with its
weights carried by key: ``forward_backward_pipeline`` at pp 4 for
``1f1b`` and ``fthenb`` at M 2 and 4, ``zero_bubble`` and ``vpp`` (2
chunks, 8 layers), each gathered whole by ``gather_pipeline_tree``;
``train_batch`` with AdamW(1e-2) then ``sync_to_model`` for ``1f1b`` (M 4)
and ``vpp``; a frozen embedding; ``remat``; ``pipeline_apply``; and pp 2 x
dp 2 on ``ProcessMesh(shape=[2, 2], dim_names=["pp", "dp"])``. The
reference runs here: its sequential oracle (``_sequential_loss_and_grads``)
and its ``PipelineParallel.train_batch`` (each once per module).

Tolerances, the reference's own (``tests/test_pipeline.py:141-154``, which
its pipeline meets against the same oracle): the loss rtol 1e-5, every
gradient rtol 1e-4 / atol 1e-5; the losses and parameters of
``train_batch`` against the reference's rtol 2e-5 (atol 1e-6 for entries
near 0); ``remat`` and the data replicas' gradients bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed.mesh import ProcessMesh, set_mesh
from test_pipeline import B, S, V, _build_model, _loss_fn, _sequential_loss_and_grads

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
# (style, microbatches, chunks, layers, data key): the reference's golden
# cases (tests/test_pipeline.py:126-186)
GOLDEN = [("1f1b", 2, 1, 4, "r0"), ("1f1b", 4, 1, 4, "r0"), ("fthenb", 2, 1, 4, "r0"),
          ("fthenb", 4, 1, 4, "r0"), ("zero_bubble", 4, 1, 4, "r3"), ("vpp", 4, 2, 8, "r3")]
# (style, microbatches, chunks, layers, data key, steps): tests/test_pipeline.py:188-223
TRAIN = [("1f1b", 4, 1, 4, "r1", 6), ("vpp", 4, 2, 8, "r5", 5)]


def _state(n_layers):
    emb, layers, head = _build_model(n_layers)
    out = {f"emb.{k}": np.asarray(v._data) for k, v in emb.state_dict().items()}
    for i, lyr in enumerate(layers):
        out.update({f"layers.{i}.{k}": np.asarray(v._data) for k, v in lyr.state_dict().items()})
    out.update({f"head.{k}": np.asarray(v._data) for k, v in head.state_dict().items()})
    return out


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, V, (B, S)), rng.randint(0, V, (B, S))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppref")
    set_mesh(None)
    for n in (4, 8):
        np.savez(tmp / f"w{n}.npz", **_state(n))
    data = {}
    for seed in (0, 1, 3, 5, 2):
        ids, labels = _tokens(seed)
        data[f"r{seed}_ids"], data[f"r{seed}_labels"] = ids, labels
    rng = np.random.RandomState(1)
    data.update({f"w{i}": rng.rand(16, 16).astype(np.float32) * 0.1 for i in range(8)})
    data["x"] = rng.rand(8, 16).astype(np.float32)
    np.savez(tmp / "data.npz", **data)
    return {"w4": str(tmp / "w4.npz"), "w8": str(tmp / "w8.npz"), "data": str(tmp / "data.npz")}


@pytest.fixture(scope="module")
def launched(files, tmp_path_factory):
    f = files
    spec = [["pp_grads", f[f"w{n}"], f["data"], key, style, m, c, n]
            for style, m, c, n, key in GOLDEN]
    spec += [["pp_train", f[f"w{n}"], f["data"], key, style, m, c, n, steps]
             for style, m, c, n, key, steps in TRAIN]
    spec += [["pp_frozen", f["w4"], f["data"], "r1"], ["pp_remat", f["w4"], f["data"], "r0"],
             ["pp_apply", f["data"]], ["pp_dp", f["w4"], f["data"], "r2", 2]]
    return W.Launch(str(tmp_path_factory.mktemp("pp4")), 4, spec)


@pytest.fixture(scope="module")
def pp4(launched, reference):
    return str(launched)


@pytest.fixture(scope="module")
def reference(files, launched):
    """The reference's sequential oracle for each golden case, and its
    train_batch trajectories."""
    from paddle_tpu.distributed.fleet.pipeline_parallel import PipelineParallel

    out = {}
    for style, m, c, n, key in GOLDEN:
        if (n, key) not in out:
            ids, labels = _tokens(int(key[1:]))
            out[(n, key)] = _sequential_loss_and_grads(*_build_model(n), jnp.asarray(ids),
                                                       jnp.asarray(labels))
    for style, m, c, n, key, steps in TRAIN + [("1f1b", 2, 1, 4, "r2", 2)]:
        emb, layers, head = _build_model(n)
        mesh = (ProcessMesh(shape=[4], dim_names=["pp"]) if key != "r2"
                else ProcessMesh(shape=[2, 2], dim_names=["pp", "dp"]))
        pp = PipelineParallel(emb, layers, head, _loss_fn, mesh=mesh, num_microbatches=m,
                              schedule=style, num_chunks=c)
        params = [p for mod in [emb, head] + layers for _, p in mod.named_parameters()]
        opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params)
        ids, labels = (jnp.asarray(a) for a in _tokens(int(key[1:])))
        losses = [float(pp.train_batch((ids, labels), opt)._data) for _ in range(steps)]
        pp.sync_to_model()
        state = {f"emb.{k}": np.asarray(v._data) for k, v in emb.named_parameters()}
        for i, lyr in enumerate(layers):
            state.update({f"layers.{i}.{k}": np.asarray(v._data)
                          for k, v in lyr.named_parameters()})
        state.update({f"head.{k}": np.asarray(v._data) for k, v in head.named_parameters()})
        out[("train", style, key)] = (losses, state)
    set_mesh(None)
    return out


def _stack_layers(got, n_layers, chunks):
    """{layer index: {key: gradient}} from the reassembled stack
    ``[P, Lc, ...]`` (``[P, V, Lc, ...]``: layer ``(v * P + p) * Lc + j``)."""
    layers = {}
    for name, arr in got.items():
        if not name.startswith("stack/"):
            continue
        k = name[len("stack/"):]
        a = np.swapaxes(arr, 0, 1) if chunks > 1 else arr
        flat = a.reshape((n_layers,) + a.shape[3 if chunks > 1 else 2:])
        for i in range(n_layers):
            layers.setdefault(i, {})[k] = flat[i]
    return layers


@pytest.mark.parametrize("style,m,chunks,n_layers,key", GOLDEN,
                         ids=[f"{g[0]}-M{g[1]}" for g in GOLDEN])
def test_forward_backward_matches_the_sequential_oracle(pp4, reference, style, m, chunks,
                                                        n_layers, key):
    ref_loss, ref_grads = reference[(n_layers, key)]
    for r, got in enumerate(W.load(pp4, f"pp_grads_{style}_{m}", 4)):
        np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=LOSS_RTOL)
        for n in ref_grads["emb"]:
            np.testing.assert_allclose(got[f"first/{n}"], ref_grads["emb"][n],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for n in ref_grads["head"]:
            np.testing.assert_allclose(got[f"last/{n}"], ref_grads["head"][n],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        layers = _stack_layers(got, n_layers, chunks)
        assert len(layers) == n_layers
        for i in range(n_layers):
            for k, want in ref_grads["layers"][i].items():
                np.testing.assert_allclose(layers[i][k], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"rank {r} layer {i} {k}")


@pytest.mark.parametrize("style,m,chunks,n_layers,key", GOLDEN,
                         ids=[f"{g[0]}-M{g[1]}" for g in GOLDEN])
def test_each_rank_holds_its_stage_and_the_table_bounds_its_graphs(pp4, style, m, chunks,
                                                                   n_layers, key):
    """A rank's own gradients are its stage's (first on stage 0, last on
    stage 3), the microbatches in flight on a chunk never pass the table's
    ring, and every stage but the ends sends and receives each way once a
    microbatch and chunk."""
    for r, got in enumerate(W.load(pp4, f"pp_grads_{style}_{m}", 4)):
        parts = {k.split("/")[0] for k in got["local_keys"]}
        want = {"stack"} | ({"first"} if r == 0 else set()) | ({"last"} if r == 3 else set())
        assert parts == want, (r, parts)
        assert 1 <= int(got["peak"]) <= int(got["ring"]), (r, got["peak"], got["ring"])
        hops = 2 * m * chunks - (m if r == 0 else 0) - (m if r == 3 else 0)
        assert (int(got["sends"]), int(got["recvs"])) == (hops, hops), r


def test_1f1b_keeps_fewer_graphs_in_flight_than_fthenb(pp4):
    """The stash bound: stage 0 holds P graphs under 1F1B at M 4 and all M
    under FThenB (the reference's test_1f1b_memory_bound)."""
    one = W.load(pp4, "pp_grads_1f1b_4", 4)[0]
    all_ = W.load(pp4, "pp_grads_fthenb_4", 4)[0]
    assert int(one["peak"]) == 4 and int(all_["peak"]) == 4
    assert [int(g["peak"]) for g in W.load(pp4, "pp_grads_1f1b_4", 4)] == [4, 3, 2, 1]
    assert [int(g["peak"]) for g in W.load(pp4, "pp_grads_fthenb_4", 4)] == [4, 4, 4, 4]


@pytest.mark.parametrize("style,m,chunks,n_layers,key,steps", TRAIN, ids=[t[0] for t in TRAIN])
def test_train_batch_follows_the_reference(pp4, reference, style, m, chunks, n_layers, key,
                                           steps):
    losses, state = reference[("train", style, key)]
    for r, got in enumerate(W.load(pp4, f"pp_train_{style}", 4)):
        np.testing.assert_allclose(got["losses"], losses, rtol=TRAIN_RTOL)
        assert losses[-1] < losses[0]
        for k, want in state.items():
            np.testing.assert_allclose(got[k], want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       err_msg=f"rank {r} {k}")


def test_a_frozen_parameter_is_not_updated(pp4):
    got = W.load(pp4, "pp_frozen", 4)
    np.testing.assert_array_equal(got[0]["emb_before"], got[0]["emb_after"])
    assert not np.allclose(got[3]["proj_before"], got[3]["proj_after"])
    for g in got:
        assert "create a new PipelineParallel" in str(g["switched"])


def test_remat_changes_nothing(pp4):
    for got in W.load(pp4, "pp_remat", 4):
        assert float(got["loss_False"]) == float(got["loss_True"])
        for k in got:
            if k.startswith("False/"):
                np.testing.assert_array_equal(got[k], got["True/" + k[len("False/"):]])


def test_pipeline_apply_matches_the_reference(pp4, files):
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed.fleet.pipeline_engine import (pipeline_apply, scan_layers,
                                                              stack_stage_params)

    d = np.load(files["data"])
    mesh = ProcessMesh(shape=[4], dim_names=["pp"])
    stacked = stack_stage_params([{"w": jnp.asarray(d[f"w{i}"])} for i in range(8)], 4)
    fn = shard_map(lambda sp, xx: pipeline_apply(
        lambda q, h: scan_layers(lambda w, x: jnp.tanh(x @ w["w"]), q, h), sp, xx,
        num_stages=4, num_microbatches=4, axis_name="pp"),
        mesh=mesh.jax_mesh, in_specs=(P("pp"), P(None)), out_specs=P(None))
    want = np.asarray(jax.jit(fn)(stacked, d["x"]))
    for r, got in enumerate(W.load(pp4, "pp_apply", 4)):
        np.testing.assert_allclose(got["output"], want, rtol=1e-6, atol=1e-6)
        if r == 3:
            np.testing.assert_array_equal(got["last_only"], got["output"])
        else:
            assert not got["last_only"].any()


def test_pp_by_dp_matches_the_reference_and_its_replicas_agree(pp4, reference):
    """Ranks (pp, dp): 0 (0, 0), 1 (0, 1), 2 (1, 0), 3 (1, 1); each replica
    takes half the batch, the gradients are averaged over dp."""
    losses, _ = reference[("train", "1f1b", "r2")]
    got = W.load(pp4, "pp_dp", 4)
    assert [list(g["coord"]) for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for g in got:
        np.testing.assert_allclose(float(g["loss"]), losses[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["losses"], losses, rtol=TRAIN_RTOL)
    for a, b in ((0, 1), (2, 3)):
        keys = [k for k in got[a] if "/" in k]
        assert keys and keys == [k for k in got[b] if "/" in k]
        for k in keys:
            np.testing.assert_array_equal(got[a][k], got[b][k])


@pytest.mark.slow
def test_the_references_own_pipeline_agrees(pp4):
    """The golden 1F1B case (M 4) against the reference's own
    forward_backward_pipeline (10-24 s here)."""
    from paddle_tpu.distributed.fleet.pipeline_parallel import PipelineParallel

    emb, layers, head = _build_model(4)
    ids, labels = (jnp.asarray(a) for a in _tokens(0))
    pp = PipelineParallel(emb, layers, head, _loss_fn,
                          mesh=ProcessMesh(shape=[4], dim_names=["pp"]), num_microbatches=4,
                          schedule="1f1b")
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    set_mesh(None)
    got = W.load(pp4, "pp_grads_1f1b_4", 4)[0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=LOSS_RTOL)
    for part in ("first", "last", "stack"):
        for k, v in grads[part].items():
            np.testing.assert_allclose(got[f"{part}/{k}"], np.asarray(v), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
