"""PyTorch port: hybrid parallelism over gloo processes (the pipeline beside
the tensor, sharding and fsdp axes with Megatron sequence parallelism
between stages, the tensor axis beside a sharding stage, fleet's topology
at the mixed degrees), held against the reference on the conftest's CPU
mesh.

One launch of 4 ranks of ``tests/torch_dist_worker.py`` through the port's
launcher feeds every tier-1 test, on the reference's pipeline model of
``tests/test_pipeline.py:25-77`` (V 64, H 16, S 8, B 8, f32) with
Megatron's marks (``hy_marked``: fc1 column-parallel, fc2 row-parallel,
each with an fsdp dim, ``head.proj.weight.shard_axes = {1: "mp"}``):
``forward_backward_pipeline`` at pp 2 x mp 2 under 1F1B and vpp, with and
without ``activation_spec``, and with ``ParallelCrossEntropy`` on the
head's vocabulary columns; ``train_batch`` at pp 2 x sharding 2 through
fleet and at pp 2 x fsdp 2 through ``pipeline_from_rules``; the
reference's micro Llama at mp 2 x sharding 2 through ``parallelize`` and
fleet; the tiny Llama at pp 2 x tensor 2 with sequence parallelism;
``PipelineLayer`` over fleet's mp layers at pp 2 x mp 2 against its own
eager run; and the meshes and topologies that now build. The reference runs here, while
the ranks run: its sequential oracle, its ``train_batch`` on fleet's pp x
sharding mesh and through its ``pipeline_from_rules`` at pipe x fsdp, its
``parallelize`` on a [2, 2] mesh and its one-device Llama (each once per
module); its own ``PipelineParallel`` on ``ProcessMesh([2, 2], ["pp",
"mp"])``, which its tests hold to the sequential oracle, in the slow tier.

Tolerances: the pipeline's loss rtol 1e-5 (the reference's own,
``tests/test_pipeline.py:260``), its gradients rtol 1e-4 / atol 1e-5 and
its ``train_batch`` losses and parameters rtol 2e-5 / atol 1e-6 (as
``tests/test_torch_pipeline.py``: f32 partial sums over the tensor ranks
added in another order); the micro Llama's losses rtol 2e-5 and its
parameters within 2e-5 of each tensor's largest entry, and the tiny
Llama's gradients within 1e-5 of each leaf's largest entry (as
``tests/test_torch_tensor_parallel.py``). The reference's own 8-device
mesh (pp x dp x mp, ``tests/test_pipeline.py:247-260``) runs 8 ranks in
the slow tier; its tier-1 sibling is the 4-rank pp x mp case.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed.mesh import ProcessMesh, build_program_mesh, set_mesh
from paddle_tpu.tensor import Tensor
from test_pipeline import B, H, S, V, _build_model, _loss_fn, _sequential_loss_and_grads

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
LLAMA_LOSS_RTOL, LLAMA_FRAC, PARAM_FRAC = 2e-5, 1e-5, 2e-5
# (style, microbatches, chunks, layers, data key, activation_spec, loss)
GRADS = [("1f1b", 2, 1, 4, "r0", 0, "mean"), ("1f1b", 2, 1, 4, "r0", 1, "mean"),
         ("vpp", 4, 2, 8, "r3", 0, "mean"), ("vpp", 4, 2, 8, "r3", 1, "mean"),
         ("1f1b", 2, 1, 4, "r0", 1, "pce")]
GRAD_IDS = [f"{g[0]}-spec{g[5]}-{g[6]}" for g in GRADS]
TRAIN_KEY, TRAIN_STEPS = "r1", 3
MPS = [("parallelize", 1), ("parallelize", 2), ("parallelize", 3), ("fleet", 1)]


def _marked(emb, layers, head):
    for lyr in layers:
        lyr.fc1.weight.shard_axes = {1: "mp", 0: "fsdp"}
        lyr.fc2.weight.shard_axes = {0: "mp", 1: "fsdp"}
    head.proj.weight.shard_axes = {1: "mp"}
    return emb, layers, head


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


def _micro():
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=8,
        use_flash_attention=False))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hyref")
    set_mesh(None)
    for n in (4, 8):
        np.savez(tmp / f"w{n}.npz", **_state(n))
    data = {}
    for seed in (0, 1, 2, 3):
        data[f"r{seed}_ids"], data[f"r{seed}_labels"] = _tokens(seed)
    np.savez(tmp / "data.npz", **data)
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    paddle.seed(7)
    np.savez(tmp / "micro.npz", **{k: np.asarray(v._data)
                                   for k, v in _micro().state_dict().items()})
    paddle.seed(3)
    tiny = LlamaForCausalLM(LlamaConfig.tiny())
    np.savez(tmp / "tiny.npz", **{k: np.asarray(v._data) for k, v in tiny.state_dict().items()})
    rng = np.random.RandomState(11)
    micro = {}
    for i in range(3):
        micro[f"ids{i}"] = rng.randint(0, 64, (8, 8)).astype(np.int32)
        micro[f"labels{i}"] = rng.randint(0, 64, (8, 8)).astype(np.int32)
    np.savez(tmp / "micro_tok.npz", **micro)
    t = np.random.RandomState(13).randint(0, 1024, (4, 17))
    np.savez(tmp / "tiny_tok.npz", ids0=t[:, :-1], labels0=t[:, 1:])
    return {k: str(tmp / f"{k}.npz") for k in ("w4", "w8", "data", "micro", "tiny",
                                                "micro_tok", "tiny_tok")} | {"tiny_model": tiny}


@pytest.fixture(scope="module")
def launched(files, tmp_path_factory):
    f = files
    spec = [["hybrid_axes"]]
    spec += [["hy_grads", f[f"w{n}"], f["data"], key, style, m, c, n, sp, loss]
             for style, m, c, n, key, sp, loss in GRADS]
    spec += [["hy_train", f["w4"], f["data"], TRAIN_KEY, how, TRAIN_STEPS]
             for how in ("sharding", "fsdp")]
    spec += [["hy_mp_sharding", f["micro"], f["micro_tok"], how, stage] for how, stage in MPS]
    spec += [["hy_llama", f["tiny"], f["tiny_tok"]], ["hy_pp_layers", f["data"], "r2"]]
    return W.Launch(str(tmp_path_factory.mktemp("hy4")), 4, spec)


@pytest.fixture(scope="module")
def hy4(launched, reference):
    return str(launched)


@pytest.fixture(scope="module")
def reference(files, launched):
    """The reference's side, computed while the ranks run (see the module
    docstring)."""
    from paddle_tpu.distributed.fleet.pipeline_parallel import PipelineParallel
    from paddle_tpu.distributed.partitioning import Partitioner, pipeline_from_rules

    out = {}
    for n, key in ((4, "r0"), (8, "r3")):
        ids, labels = (jnp.asarray(a) for a in _tokens(int(key[1:])))
        out[(n, key)] = _sequential_loss_and_grads(*_build_model(n), ids, labels)
    ids, labels = (jnp.asarray(a) for a in _tokens(int(TRAIN_KEY[1:])))
    for how in ("sharding", "fsdp"):
        set_mesh(None)
        emb, layers, head = _marked(*_build_model(4))
        if how == "sharding":
            mesh = ProcessMesh(shape=[2, 1, 2, 1, 1], dim_names=["pp", "dp", "sharding", "sep",
                                                                 "mp"])
            pp = PipelineParallel(emb, layers, head, _loss_fn, mesh=mesh, num_microbatches=2)
        else:
            pp = pipeline_from_rules(emb, layers, head, _loss_fn, num_microbatches=2,
                                     partitioner=Partitioner(build_program_mesh(pipe=2, fsdp=2)))
        params = [p for m in [emb, head] + layers for _, p in m.named_parameters()]
        opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params)
        losses = [float(pp.train_batch((ids, labels), opt)._data) for _ in range(TRAIN_STEPS)]
        pp.sync_to_model()
        state = {f"emb.{k}": np.asarray(v._data) for k, v in emb.named_parameters()}
        for i, lyr in enumerate(layers):
            state.update({f"layers.{i}.{k}": np.asarray(v._data)
                          for k, v in lyr.named_parameters()})
        state.update({f"head.{k}": np.asarray(v._data) for k, v in head.named_parameters()})
        out[("train", how)] = (losses, state)
    out["mps"] = _ref_mp_sharding(files)
    out["llama"] = _ref_llama(files)
    set_mesh(None)
    return out


def _ref_mp_sharding(files):
    """The reference's micro Llama under parallelize(mp_config,
    sharding_config stage 1) on a [2, 2] mesh, 3 TrainStep calls."""
    from paddle_tpu.distributed.parallelize import parallelize
    from paddle_tpu.jit.training import TrainStep

    set_mesh(None)
    model = _micro()
    model.set_state_dict({k: Tensor(v) for k, v in np.load(files["micro"]).items()})
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1, grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    model, opt = parallelize(model, opt, mesh=ProcessMesh(shape=[2, 2],
                                                          dim_names=["sharding", "mp"]),
                             config={"mp_config": {}, "sharding_config": {"stage": 1}})
    step = TrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0])
    tok = np.load(files["micro_tok"])
    losses = [float(step(Tensor(tok[f"ids{i}"]), Tensor(tok[f"labels{i}"]))._data)
              for i in range(3)]
    set_mesh(None)
    return losses, {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _ref_llama(files):
    """The reference's one-device tiny Llama: the loss and every gradient."""
    set_mesh(None)
    model = files["tiny_model"]
    tok = np.load(files["tiny_tok"])
    loss, _ = model(Tensor(tok["ids0"]), labels=Tensor(tok["labels0"]))
    loss.backward()
    return float(loss.numpy()), {n: p.grad.numpy() for n, p in model.named_parameters()}


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


def _close(got, want, frac, msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= frac, (msg, err)


@pytest.mark.parametrize("style,m,chunks,n_layers,key,spec,loss", GRADS, ids=GRAD_IDS)
def test_pp_by_mp_matches_the_sequential_oracle(hy4, reference, style, m, chunks, n_layers,
                                                key, spec, loss):
    """pp 2 x mp 2: every rank's loss and its gradients, gathered whole over
    the stages and the tensor ranks, against the reference's sequential
    oracle; the head's weight on a rank of the last stage is its half of the
    vocabulary."""
    ref_loss, ref_grads = reference[(n_layers, key)]
    for r, got in enumerate(W.load(hy4, f"hy_grads_pp_mp_{style}_{spec}_{loss}", 4)):
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
        if r >= 2:
            assert list(got["proj_shape"]) == [H, V // 2], got["proj_shape"]


@pytest.mark.slow
def test_pp_by_mp_matches_the_references_pipeline(hy4):
    """The 1F1B case against the reference's own PipelineParallel on
    ProcessMesh([2, 2], ["pp", "mp"]) (its stacks [P, Lc, ...]; ~15 s
    here), which its own tests hold to the sequential oracle (tier-1
    sibling: test_pp_by_mp_matches_the_sequential_oracle)."""
    from paddle_tpu.distributed.fleet.pipeline_parallel import PipelineParallel

    emb, layers, head = _marked(*_build_model(4))
    ids, labels = (jnp.asarray(a) for a in _tokens(0))
    pp = PipelineParallel(emb, layers, head, _loss_fn,
                          mesh=ProcessMesh(shape=[2, 2], dim_names=["pp", "mp"]),
                          num_microbatches=2)
    loss, grads = pp.forward_backward_pipeline(ids, labels)
    set_mesh(None)
    loss, grads = float(loss), {part: {k: np.asarray(v) for k, v in grads[part].items()}
                                for part in grads}
    for got in W.load(hy4, "hy_grads_pp_mp_1f1b_0_mean", 4):
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
        for part in grads:
            for k, v in grads[part].items():
                np.testing.assert_allclose(got[f"{part}/{k}"], v, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL, err_msg=f"{part}/{k}")


@pytest.mark.parametrize("style", ["1f1b", "vpp"])
def test_activation_spec_halves_the_bytes_between_stages(hy4, style):
    """Under activation_spec each rank sends its part of the sequence: half
    the bytes of the whole activation (and of its cotangent), exactly."""
    whole = W.load(hy4, f"hy_grads_pp_mp_{style}_0_mean", 4)
    cut = W.load(hy4, f"hy_grads_pp_mp_{style}_1_mean", 4)
    for r in range(4):
        assert int(whole[r]["sent"]) > 0
        assert 2 * int(cut[r]["sent"]) == int(whole[r]["sent"]), r


@pytest.mark.parametrize("how", ["sharding", "fsdp"])
def test_train_batch_beside_a_sharding_axis_follows_the_reference(hy4, reference, how):
    """3 AdamW steps through train_batch: pp 2 x sharding 2 through fleet
    (stage 1: each rank's optimizer state is half of its stage's, exactly)
    and pp 2 x fsdp 2 through pipeline_from_rules (the marked weights at
    rest, gathered where they run), against the reference's train_batch on
    the same meshes; every parameter after sync_to_model."""
    losses, state = reference[("train", how)]
    got = W.load(hy4, f"hy_train_{how}", 4)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["losses"], losses, rtol=TRAIN_RTOL)
        assert losses[-1] < losses[0]
        for k, want in state.items():
            np.testing.assert_allclose(g[k], want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       err_msg=f"rank {r} {k}")
        if how == "sharding":         # AdamW's two moments, on half of each tensor
            assert int(g["state"]) == int(g["held"]), (r, g["state"], g["held"])
        else:
            assert sorted(g["at_rest"]) == sorted(
                k for k in state if k.startswith("layers.") and k.endswith("weight")
                and int(k.split(".")[1]) // 2 == r // 2), (r, g["at_rest"])


@pytest.mark.parametrize("how,stage", MPS, ids=[f"{h}-stage{s}" for h, s in MPS])
def test_mp_beside_a_sharding_stage_follows_the_reference(files, hy4, reference, how, stage):
    """The micro Llama at mp 2 x sharding 2 (its K and V stay whole, their
    gradients summed over the tensor ranks): 3 TrainStep calls, each
    sharding rank on its half of the batch, against the reference's
    parallelize on a [2, 2] mesh; at stages 1 and 2 a rank's optimizer
    state is half of its tensor slices' two moments."""
    losses, state = reference["mps"]
    got = W.load(hy4, f"hy_mps_{how}_{stage}", 4)
    mean = np.mean([g["losses"] for g in got], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=LLAMA_LOSS_RTOL)
    for r, g in enumerate(got):
        assert int(g["stage"]) == stage
        for k, want in state.items():
            _close(g[k], want, PARAM_FRAC, f"rank {r} {k}")
    if stage in (1, 2):
        assert len({int(g["state"]) for g in got}) == 1


def test_tiny_llama_pp_by_tensor_with_sequence_parallelism(hy4, reference):
    """The tiny Llama's stages at pp 2 x tensor 2 with sequence
    parallelism and ParallelCrossEntropy: the loss and every gradient,
    gathered whole, against the reference's one-device backward; each rank
    sends its half of the sequence."""
    loss, grads = reference["llama"]
    for r, got in enumerate(W.load(hy4, "hy_llama", 4)):
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LLAMA_LOSS_RTOL)
        named = {"llama.embed_tokens.weight": got["first/embed_tokens.weight"],
                 "llama.norm.weight": got["last/norm.weight"],
                 "lm_head.weight": got["last/lm_head.weight"]}
        for name, arr in got.items():
            if name.startswith("stack/"):
                for p in range(2):
                    named[f"llama.layers.{p}.{name[len('stack/'):]}"] = arr[p, 0]
        assert sorted(named) == sorted(grads)
        for k, want in grads.items():
            _close(named[k], want, LLAMA_FRAC, f"rank {r} {k}")
        # 2 microbatches of [2, 8 of 16, 256] f32 one way
        assert int(got["sent"]) == 2 * 2 * 8 * 256 * 4, got["sent"]


def test_pipeline_layer_of_mp_layers_at_pp_by_mp(hy4):
    """PipelineLayer over LayerDescs of fleet's mp layers (a vocab-parallel
    embedding, column / row blocks, a column head kept cut) at pp 2 x mp 2:
    its two uniform stages, and PipelineParallel over its layers with
    ParallelCrossEntropy gives the loss and every gradient of the same
    model run eagerly on each rank (rtol 1e-5 / atol 1e-6: the same f32
    sums in microbatches)."""
    for r, got in enumerate(W.load(hy4, "hy_pp_layers", 4)):
        assert list(got["stages"]) == [0, 2, 4]
        np.testing.assert_allclose(float(got["loss"]), float(got["eager_loss"]), rtol=1e-5)
        named = {"0.weight": got["first/weight"]}
        for k, arr in got.items():
            if k.startswith("stack/"):
                for p in range(2):
                    named[f"{p + 1}.{k[len('stack/'):]}"] = arr[p, 0]
            elif k.startswith("last/"):
                named[f"3.{k[len('last/'):]}"] = arr
        want = {k[len("eager/run_function."):]: v for k, v in got.items()
                if k.startswith("eager/")}
        assert sorted(named) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(named[k], w, rtol=1e-5, atol=1e-6, err_msg=f"{r} {k}")


@pytest.mark.parametrize("case", ["pipe_and_tensor", "pipe_and_fsdp", "activation_spec"])
def test_the_hybrid_axes_build(hy4, case):
    """What waited for this slice (these ids raised before) builds over 4
    ranks: the program mesh's pipe axis beside tensor / fsdp (each group
    and the stage order), and a pipeline on pp x mp with activation_spec,
    which cuts the sequence (dim 1) over the 2 tensor ranks."""
    for rank, got in enumerate(W.load(hy4, "hybrid_axes", 4)):
        row = list(got[case])
        if case == "activation_spec":
            assert row == [1, 2, 0]
        else:
            p, q = divmod(rank, 2)
            shape = [1, 2, 1, 2] if case == "pipe_and_tensor" else [1, 2, 2, 1]
            assert row == shape + [q, q + 2] + [2 * p, 2 * p + 1] + [q, q + 2], (rank, row)


@pytest.mark.parametrize("degrees", ["pp_mp", "pp_sharding", "mp_sharding"])
def test_fleets_topology_at_the_mixed_degrees(hy4, degrees):
    """fleet.init at pp 2 x mp 2, pp 2 x sharding 2 and mp 2 x sharding 2:
    the mode (the reference's precedence), the stage, every axis's group
    and the stage's neighbours, as the reference's CommunicateTopology
    lays the ranks out (data, pipe, sharding, sep, model)."""
    from paddle_tpu.distributed.fleet.topology import CommunicateTopology

    dims = {"pp_mp": [1, 2, 1, 1, 2], "pp_sharding": [1, 2, 2, 1, 1],
            "mp_sharding": [1, 1, 2, 1, 2]}[degrees]
    topo = CommunicateTopology(dims=dims)
    mode = {"pp_mp": "pipeline", "pp_sharding": "pipeline",
            "mp_sharding": "sharding_parallel"}[degrees]

    def along(axis, rank):
        return next(g for g in topo.get_comm_list(axis) if rank in g)

    for rank, got in enumerate(W.load(hy4, "hybrid_axes", 4)):
        c = dict(zip(["data", "pipe", "sharding", "sep", "model"], topo.get_coord(rank)))
        stages = along("pipe", rank)
        i = stages.index(rank)
        want = [mode, c["pipe"], stages, c["model"], along("model", rank), c["sharding"],
                along("sharding", rank), along("data", rank), stages[(i - 1) % len(stages)],
                stages[(i + 1) % len(stages)], ["pp", "dp", "sharding", "sep", "mp"],
                [dims[1], dims[0], dims[2], dims[3], dims[4]]]
        assert list(got[f"topology_{degrees}"]) == [str(x) for x in want], rank


@pytest.mark.slow
def test_the_references_own_mesh_pp_dp_mp(files, tmp_path_factory):
    """The reference's test_composes_with_dp_mp (tests/test_pipeline.py:
    247-260) on 8 ranks: pp 2 x dp 2 x mp 2, 2 layers, 1F1B at M 2; the
    loss at rtol 1e-5 of the sequential oracle (tier-1 sibling:
    test_pp_by_mp_matches_the_sequential_oracle)."""
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("hy8")
    set_mesh(None)
    np.savez(tmp / "w2.npz", **_state(2))
    rng = np.random.RandomState(2)
    ids, labels = rng.randint(0, V, (B, S)), rng.randint(0, V, (B, S))
    np.savez(tmp / "d.npz", r2_ids=ids, r2_labels=labels)
    rc, logs = W.run_ranks(str(tmp), 8, [["hy_grads", str(tmp / "w2.npz"), str(tmp / "d.npz"),
                                          "r2", "1f1b", 2, 1, 2, 0, "mean", "pp_dp_mp"]])
    assert rc == 0, logs
    ref_loss, ref_grads = _sequential_loss_and_grads(*_build_model(2), jnp.asarray(ids),
                                                     jnp.asarray(labels))
    for got in W.load(str(tmp), "hy_grads_pp_dp_mp_1f1b_0_mean", 8):
        np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=LOSS_RTOL)
        for n, want in ref_grads["head"].items():
            np.testing.assert_allclose(got[f"last/{n}"], want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
