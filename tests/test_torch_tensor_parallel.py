"""PyTorch port: tensor parallelism over gloo processes (fleet's mp layers,
the partitioner's tensor axis, Megatron's sequence parallelism, the
semi-auto API, two-dim checkpoints), held against the reference on the
conftest's CPU mesh.

Two launches of ``tests/torch_dist_worker.py`` through the port's
launcher feed every test: 2 ranks (the mp layers at tensor 2, the tiny
Llama at tensor 2 with and without sequence parallelism, fleet at
``mp_degree`` 2 and ``parallelize(mp_config=...)``) and 4 ranks (the mp
layers at tensor 4, the reference's micro Llama of
``tests/test_partitioning.py:45-50`` at fsdp 2 x tensor 2 with SGD and
with AdamW under the global-norm clip, the tiny Llama at tensor 4, the
semi-auto API on dp 2 x mp 2, a checkpoint saved at fsdp 2 x tensor 2 and
loaded at fsdp 4). The micro Llama has one KV head: at tensor 2 its K and
V projections stay whole and their gradients are summed over the tensor
ranks. The reference runs here: its layers under ``dist.auto_mesh(mp=t)``,
its ``PartitionedTrainStep`` over ``build_program_mesh`` and its
``TrainStep`` oracle, the unsharded backward for the gradients.

Tolerances: the layers' outputs and gradients 1e-5 relative to the
largest entry (a few f32 partial sums added in another order); losses
rtol 2e-5, the reference's own bound (``tests/test_partitioning.py:163``);
the micro Llama's parameters after 3 SGD or AdamW steps within 2e-5 of
each tensor's largest entry; the tiny Llama's after 3 AdamW steps as
``test_torch_distributed_train.close_params`` (AdamW moves a weight whose
gradient sits near 0 by lr * g / (|g| + eps), which magnifies a rounding
difference of g: a few elements a tensor may differ by up to a fifth of
lr); gradients 1e-5 of the largest entry.
"""

import functools
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_worker as W
from test_torch_distributed_train import close_params
from paddle_tpu.distributed.mesh import build_program_mesh, set_mesh
from paddle_tpu.jit.training import TrainStep
from paddle_tpu.tensor import Tensor

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FRAC = 1e-5          # outputs and gradients, of the largest entry
LOSS_RTOL = 2e-5
PARAM_FRAC = 2e-5
FAULT_FRAC = 1e-2    # a planted fault misses by more than this
AXES = {"micro22": {"fsdp": 2, "tensor": 2}, "tiny2": {"tensor": 2}, "tiny4": {"tensor": 4}}


def _state(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _micro():
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=48,
                           num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=8, use_flash_attention=False)
    return LlamaForCausalLM(cfg)


def _tiny():
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpref")
    set_mesh(None)
    rng = np.random.RandomState(5)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    layers = {"x8": f32(4, 8), "x16": f32(4, 16), "cot_col": f32(4, 16), "cot_row": f32(4, 8),
              "ids": rng.randint(0, 32, (3, 5)), "cot_emb": f32(3, 5, 8),
              "logits": f32(6, 32), "cot_ce": f32(6),
              "labels": np.array([0, 9, 17, 31, -100, 24]), "xs": f32(2, 8, 8),
              "cot_sp": f32(2, 8, 8)}
    for b in (0, 1):
        layers.update({f"col{b}.weight": f32(8, 16), f"row{b}.weight": f32(16, 8)})
        if b:
            layers.update({"col1.bias": f32(16), "row1.bias": f32(8)})
    layers["emb.weight"] = f32(32, 8)
    np.savez(tmp / "layers.npz", **layers)
    paddle.seed(7)
    np.savez(tmp / "micro.npz", **_state(_micro()))
    paddle.seed(3)
    np.savez(tmp / "tiny.npz", **_state(_tiny()))
    rng = np.random.RandomState(11)
    micro = {}
    for i in range(3):
        micro[f"ids{i}"] = rng.randint(0, 64, (8, 8)).astype(np.int32)
        micro[f"labels{i}"] = rng.randint(0, 64, (8, 8)).astype(np.int32)
    np.savez(tmp / "micro_tok.npz", **micro)
    rng = np.random.RandomState(13)
    tok = {}
    for i in range(3):
        t = rng.randint(0, 1024, (4, 17))
        tok[f"ids{i}"], tok[f"labels{i}"] = t[:, :-1], t[:, 1:]
    np.savez(tmp / "tiny_tok.npz", **tok)
    return {k: str(tmp / f"{k}.npz") for k in ("layers", "micro", "tiny", "micro_tok",
                                                "tiny_tok")} | {"ckpt": str(tmp / "ckpt")}


def _launch(tmp_path_factory, n, spec):
    tmp = str(tmp_path_factory.mktemp(f"tp{n}"))
    rc, logs = W.run_ranks(tmp, n, spec)
    assert rc == 0, logs
    return tmp


@pytest.fixture(scope="module")
def tp2(files, tmp_path_factory):
    f = files
    return _launch(tmp_path_factory, 2, [
        ["mp_layers", f["layers"]],
        ["tp_partitioned", "tiny", f["tiny"], f["tiny_tok"], "adamw", AXES["tiny2"]],
        ["tp_partitioned", "tiny", f["tiny"], f["tiny_tok"], "adamw", AXES["tiny2"], 1],
        ["tp_fleet", f["tiny"], f["tiny_tok"]]])


@pytest.fixture(scope="module")
def tp4(files, tp2, tmp_path_factory):
    f = files
    return _launch(tmp_path_factory, 4, [
        ["mp_layers", f["layers"]],
        ["tp_partitioned", "micro", f["micro"], f["micro_tok"], "sgd", AXES["micro22"]],
        ["tp_partitioned", "micro", f["micro"], f["micro_tok"], "adamw", AXES["micro22"]],
        ["tp_partitioned", "tiny", f["tiny"], f["tiny_tok"], "adamw", AXES["tiny4"]],
        ["semi_auto"],
        ["tp_ckpt", f["micro"], f["micro_tok"], f["ckpt"]]])


def _close(got, want, frac=FRAC, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=msg)


def _far(got, want, frac=FAULT_FRAC):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() > frac * np.abs(want).max()


# ---------------------------------------------------------------------------
# (a) the mp layers
# ---------------------------------------------------------------------------


def _ref_vjp(layer, x, cot, integer=False):
    xt = Tensor(x) if integer else paddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    (y * Tensor(cot)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    return y.numpy(), (None if integer else xt.grad.numpy()), grads


def _ref_layers(files, t):
    return _ref_layers_at(files["layers"], t)


@functools.lru_cache(maxsize=None)
def _ref_layers_at(path, t):
    """The reference's layers under ``dist.auto_mesh(mp=t)``: {key: array}."""
    import paddle_tpu.distributed as rdist
    from paddle_tpu.distributed.fleet import (ColumnParallelLinear, ParallelCrossEntropy,
                                              RowParallelLinear, VocabParallelEmbedding)

    d = dict(np.load(path))
    out = {}
    with rdist.auto_mesh(mp=t):
        for b in (0, 1):
            col = ColumnParallelLinear(8, 16, has_bias=bool(b))
            col.set_state_dict({k: Tensor(d[f"col{b}.{k}"]) for k in col.state_dict()})
            y, gx, gw = _ref_vjp(col, d["x8"], d["cot_col"])
            out.update({f"col.b{b}.y": y, f"col.b{b}.gx": gx,
                        **{f"col.b{b}.grad.{k}": v for k, v in gw.items()}})
            row = RowParallelLinear(16, 8, has_bias=bool(b))
            row.set_state_dict({k: Tensor(d[f"row{b}.{k}"]) for k in row.state_dict()})
            y, gx, gw = _ref_vjp(row, d["x16"], d["cot_row"])
            out.update({f"row.b{b}.y": y, f"row.b{b}.gx": gx,
                        **{f"row.b{b}.grad.{k}": v for k, v in gw.items()}})
        emb = VocabParallelEmbedding(32, 8)
        emb.set_state_dict({"weight": Tensor(d["emb.weight"])})
        y, _, gw = _ref_vjp(emb, d["ids"], d["cot_emb"], integer=True)
        out.update({"emb.y": y, "emb.grad.weight": gw["weight"]})
        # the sequence-parallel pair's dense counterpart
        col, row = ColumnParallelLinear(8, 16, has_bias=True), RowParallelLinear(16, 8)
        col.set_state_dict({k: Tensor(d[f"col1.{k}"]) for k in col.state_dict()})
        row.set_state_dict({k: Tensor(d[f"row1.{k}"]) for k in row.state_dict()})
        y, gx, gw = _ref_vjp(paddle.nn.Sequential(col, row), d["xs"], d["cot_sp"])
        out.update({"sp.y": y, "sp.gx": gx, **{f"sp.grad.{k}": v for k, v in gw.items()}})
        logits = paddle.to_tensor(d["logits"], stop_gradient=False)
        loss = ParallelCrossEntropy()(logits, Tensor(d["labels"]))
        (loss * Tensor(d["cot_ce"])).sum().backward()
        out.update({"ce.loss": loss.numpy(), "ce.grad": logits.grad.numpy()})
    set_mesh(None)
    return out


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis=axis)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("layer", ["column", "row", "vocab_embedding", "cross_entropy",
                                   "sequence_parallel"])
def test_mp_layers_match_the_reference(files, tp2, tp4, t, layer):
    """Outputs, input and weight gradients at tensor t, the ranks' slices
    concatenated on their cut dim, against the reference's layers; every
    gather_output / input_is_parallel / bias case; cross entropy with
    labels in each rank's range and at ignore_index; the sequence-parallel
    column and row layers (input and output cut on the sequence, the row
    layer's bias summed over the ranks by
    register_sequence_parallel_allreduce_hooks) against the dense pair."""
    got = W.load(tp2 if t == 2 else tp4, f"mp_layers{t}", t)
    want = _ref_layers(files, t)
    for r in got:               # what every rank holds whole is equal on every rank
        for k in r:
            if k.endswith((".gx", ".y")) and (".g1." in k or k.startswith(("row", "emb"))) \
                    and ".p1." not in k:
                np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)
    for b in (0, 1):
        if layer == "column":
            for g in (0, 1):
                key = f"col.b{b}.g{g}"
                y = got[0][f"{key}.y"] if g else _cat(got, f"{key}.y", -1)
                _close(y, want[f"col.b{b}.y"], msg=key)
                _close(got[0][f"{key}.gx"], want[f"col.b{b}.gx"], msg=key)
                _close(_cat(got, f"{key}.grad.weight", 1), want[f"col.b{b}.grad.weight"])
                if b:
                    _close(_cat(got, f"{key}.grad.bias", 0), want[f"col.b{b}.grad.bias"])
        elif layer == "row":
            for p in (0, 1):
                key = f"row.b{b}.p{p}"
                _close(got[0][f"{key}.y"], want[f"row.b{b}.y"], msg=key)
                gx = _cat(got, f"{key}.gx", -1) if p else got[0][f"{key}.gx"]
                _close(gx, want[f"row.b{b}.gx"], msg=key)
                _close(_cat(got, f"{key}.grad.weight", 0), want[f"row.b{b}.grad.weight"])
                if b:
                    _close(got[0][f"{key}.grad.bias"], want[f"row.b{b}.grad.bias"])
    if layer == "vocab_embedding":
        _close(got[0]["emb.y"], want["emb.y"])
        _close(_cat(got, "emb.grad.weight", 0), want["emb.grad.weight"])
    if layer == "sequence_parallel":
        _close(_cat(got, "sp.y", 1), want["sp.y"])
        _close(_cat(got, "sp.gx", 1), want["sp.gx"])
        _close(_cat(got, "sp.grad.0.weight", 1), want["sp.grad.0.weight"])
        _close(_cat(got, "sp.grad.0.bias", 0), want["sp.grad.0.bias"])
        _close(_cat(got, "sp.grad.1.weight", 0), want["sp.grad.1.weight"])
        for r in got:                # the hook summed the bias's partial gradients
            _close(r["sp.grad.1.bias"], want["sp.grad.1.bias"])
    if layer == "cross_entropy":
        for r in got:
            _close(r["ce.loss"], want["ce.loss"])
        assert got[0]["ce.loss"][4] == 0.0            # the ignored label
        _close(_cat(got, "ce.grad", -1), want["ce.grad"])


@pytest.mark.parametrize("t", [2, 4])
def test_mp_layers_refuse_the_planted_faults(files, tp2, tp4, t):
    """A row layer without its all-reduce and a column layer whose backward
    skips its all-reduce both miss the reference by far more than the
    tolerance that the layers meet."""
    got = W.load(tp2 if t == 2 else tp4, f"mp_layers{t}", t)
    want = _ref_layers(files, t)
    assert _far(got[0]["fault.no_allreduce.y"], want["row.b1.y"])
    assert _far(got[0]["fault.no_backward_allreduce.gx"], want["col.b1.gx"])


# ---------------------------------------------------------------------------
# (b) the partitioner's specs
# ---------------------------------------------------------------------------


def test_partitioner_specs_of_the_micro_llama():
    """``tests/test_partitioning.py:143-157`` on the port: embed ("tensor",
    "fsdp"), q ("fsdp", "tensor"), down ("tensor", "fsdp"), norms (None),
    lm_head ("fsdp", "tensor"). K and V: one KV head does not split over
    tensor 2, so the port keeps them whole across it (the reference's
    GSPMD cuts the head's columns and regathers them)."""
    import torch

    from paddle_tpu_torch.distributed.mesh import build_program_mesh as port_mesh
    from paddle_tpu_torch.distributed.partitioning import Partitioner as PortPartitioner
    from paddle_tpu.distributed.partitioning import Partitioner

    from paddle_tpu_torch.models import llama as L

    cfg = L.LlamaConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=48,
                             num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                             max_position_embeddings=8, use_flash_attention=False)
    port = L.LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32)
    part = PortPartitioner(port_mesh(dp=2, fsdp=2, tensor=2))
    spec = {n: tuple(part.param_spec(p)) for n, p in port.named_parameters()}
    assert spec["llama.embed_tokens.weight"] == ("tensor", "fsdp")
    assert spec["llama.layers.0.self_attn.q_proj.weight"] == ("fsdp", "tensor")
    assert spec["llama.layers.0.self_attn.o_proj.weight"] == ("tensor", "fsdp")
    assert spec["llama.layers.0.self_attn.k_proj.weight"] == ("fsdp", None)
    assert spec["llama.layers.0.mlp.down_proj.weight"] == ("tensor", "fsdp")
    assert spec["llama.layers.0.input_layernorm.weight"] == (None,)
    assert spec["lm_head.weight"] == ("fsdp", "tensor")
    assert part.batch_spec() == (("dp", "fsdp"),) and part.data_axis_size() == 4
    paddle.seed(7)
    ref = Partitioner(build_program_mesh(dp=2, fsdp=2, tensor=2))
    for n, p in _micro().named_parameters():
        if "k_proj" not in n and "v_proj" not in n:
            assert tuple(ref.param_spec(p)) == spec[n], n


# ---------------------------------------------------------------------------
# (c) PartitionedTrainStep over the tensor axis, (d) sequence parallelism
# ---------------------------------------------------------------------------


def _ref_run(files, cfg, opt_name, axes):
    return _ref_run_at(files[cfg], files[f"{cfg}_tok"], cfg, opt_name,
                       tuple(sorted(axes.items())))


@functools.lru_cache(maxsize=None)
def _ref_run_at(weights, tokens, cfg, opt_name, axes):
    """The reference's PartitionedTrainStep over ``axes`` and its TrainStep
    oracle: (losses, oracle losses, parameters)."""
    axes = dict(axes)
    from paddle_tpu.distributed.partitioning import Partitioner, PartitionedTrainStep

    def run(partitioned):
        set_mesh(None)
        model = _micro() if cfg == "micro" else _tiny()
        model.set_state_dict({k: Tensor(v) for k, v in np.load(weights).items()})
        if opt_name == "sgd":
            opt = paddle.optimizer.SGD(0.01, parameters=model.parameters())
        else:
            opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                         weight_decay=0.1,
                                         grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
        loss_fn = lambda ids, lab: model(ids, labels=lab)[0]  # noqa: E731
        step = (PartitionedTrainStep(model, opt, loss_fn,
                                     partitioner=Partitioner(build_program_mesh(**axes)))
                if partitioned else TrainStep(model, opt, loss_fn))
        tok = np.load(tokens)
        losses = [float(step(Tensor(tok[f"ids{i}"]), Tensor(tok[f"labels{i}"]))._data)
                  for i in range(3)]
        set_mesh(None)
        return losses, _state(model)

    losses, state = run(True)
    oracle, _ = run(False)
    return losses, oracle, state


def _ref_grads(files, cfg):
    return _ref_grads_at(files[cfg], files[f"{cfg}_tok"], cfg)


@functools.lru_cache(maxsize=None)
def _ref_grads_at(weights, tokens, cfg):
    """The reference's gradients of the mean loss on the first batch."""
    set_mesh(None)
    model = _micro() if cfg == "micro" else _tiny()
    model.set_state_dict({k: Tensor(v) for k, v in np.load(weights).items()})
    tok = np.load(tokens)
    loss, _ = model(Tensor(tok["ids0"]), labels=Tensor(tok["labels0"]))
    loss.backward()
    return float(loss.numpy()), {n: p.grad.numpy() for n, p in model.named_parameters()}


def _run_name(cfg, opt, axes, sp=0):
    tag = "_".join(f"{a}{v}" for a, v in sorted(axes.items()))
    return f"tp_{cfg}_{opt}_{tag}_sp{sp}"


def _assembled(ranks, prefix, full_shapes):
    """Each parameter's whole array from the ranks' slices (their specs
    name the cut dims; a dim cut over fsdp x tensor is placed by the
    ranks' coordinates)."""
    out = {}
    for key, shape in full_shapes.items():
        full = np.full(shape, np.nan, np.float64)
        for r, rank in enumerate(ranks):
            idx = tuple(slice(a, b) for a, b in rank[f"index.{key}"])
            full[idx] = rank[f"{prefix}.{key}"]
        assert not np.isnan(full).any(), key
        out[key] = full
    return out


CASES = [("micro", "sgd", "micro22", 4), ("micro", "adamw", "micro22", 4),
         ("tiny", "adamw", "tiny2", 2), ("tiny", "adamw", "tiny4", 4)]


@pytest.mark.parametrize("cfg,opt,axes,n", CASES, ids=[f"{c}-{o}-{a}" for c, o, a, _ in CASES])
def test_partitioned_step_matches_the_reference(files, tp2, tp4, cfg, opt, axes, n):
    """3 steps: losses against the reference's PartitionedTrainStep and
    its TrainStep oracle at rtol 2e-5, and the parameters gathered whole
    against the reference's."""
    ranks = W.load(tp2 if n == 2 else tp4, _run_name(cfg, opt, AXES[axes]), n)
    losses, oracle, state = _ref_run(files, cfg, opt, AXES[axes])
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank["losses"], oracle, rtol=LOSS_RTOL)
    assert len(set(np.asarray(ranks[0]["losses"]).tolist())) == 3
    got = {k: ranks[0][f"param.{k}"] for k in state}
    if cfg == "micro":
        for k, w in state.items():
            _close(got[k], w, PARAM_FRAC, msg=k)
    else:       # AdamW magnifies a rounding of a gradient near 0 (see the docstring)
        close_params(got, state, 1e-3)


@pytest.mark.parametrize("cfg,opt,axes,n", CASES, ids=[f"{c}-{o}-{a}" for c, o, a, _ in CASES])
def test_partitioned_gradients_and_replicas(files, tp2, tp4, cfg, opt, axes, n):
    """The first batch's reduced gradients, reassembled from the ranks'
    slices, against the reference's backward (1e-5 of each leaf's
    largest); every parameter that the tensor axis does not cut
    (norms, the micro Llama's K and V) bit-identical across the ranks
    after 3 steps; the slices cut by the spec."""
    ranks = W.load(tp2 if n == 2 else tp4, _run_name(cfg, opt, AXES[axes]), n)
    loss, want = _ref_grads(files, cfg)
    np.testing.assert_allclose(ranks[0]["loss0"], loss, rtol=LOSS_RTOL)
    got = _assembled(ranks, "grad", {k: v.shape for k, v in want.items()})
    for k, w in want.items():
        _close(got[k], w, msg=k)
    for k in want:
        spec = str(ranks[0][f"spec.{k}"])
        if "tensor" not in spec:
            same = [rank for rank in ranks
                    if np.array_equal(rank[f"index.{k}"], ranks[0][f"index.{k}"])]
            assert len(same) >= 2, k
            for rank in same:
                np.testing.assert_array_equal(rank[f"local.{k}"], ranks[0][f"local.{k}"],
                                              err_msg=k)
    if cfg == "micro":
        assert str(ranks[0]["spec.llama.layers.0.self_attn.k_proj.weight"]) == \
            "PartitionSpec('fsdp', None)"


# the sentinels' f32 sums of squares against an f64 sum of the same gradients
NORM_RTOL = 1e-6
NUMERICS_CASES = [c + (0,) for c in CASES] + [("tiny", "adamw", "tiny2", 2, 1)]


@pytest.mark.parametrize("cfg,opt,axes,n,sp", NUMERICS_CASES,
                         ids=[f"{c}-{o}-{a}-sp{s}" for c, o, a, _, s in NUMERICS_CASES])
def test_partitioned_numerics_read_the_reduced_gradients(files, tp2, tp4, cfg, opt, axes, n,
                                                         sp):
    """The numerics plane of PartitionedTrainStep over the tensor axis:
    every rank publishes the same loss (the returned global mean), grad
    norm, digest and nonfinite count each step; the first step's digest is
    that of the first batch's reduced gradients gathered whole (the
    tensor-partial ones summed), its grad norm their norm (NORM_RTOL) and
    the reference's backward's (2e-5); under AdamW's clip the norm is the
    clip's."""
    ranks = W.load(tp2 if n == 2 else tp4, _run_name(cfg, opt, AXES[axes], sp), n)
    for rank in ranks:
        for k in ("sent_grad_norm", "sent_digest", "sent_loss", "sent_nonfinite"):
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)
        np.testing.assert_array_equal(rank["sent_loss"], rank["losses"].astype(np.float64))
        assert not rank["sent_nonfinite"].any()
        assert int(rank["sent_digest"][0]) == int(rank["reduced_digest0"])
        np.testing.assert_allclose(rank["sent_grad_norm"][0], rank["reduced_norm0"],
                                   rtol=NORM_RTOL)
        if "clip_scales" in rank:
            clipped = rank["clip_scales"] < 1
            np.testing.assert_allclose(rank["sent_grad_norm"][clipped],
                                       0.5 / rank["clip_scales"][clipped], rtol=1e-5)
            assert (rank["sent_grad_norm"][~clipped] <= 0.5).all()
    _, want = _ref_grads(files, cfg)
    ref_norm = np.sqrt(sum(np.sum(np.asarray(w, np.float64) ** 2) for w in want.values()))
    np.testing.assert_allclose(ranks[0]["sent_grad_norm"][0], ref_norm, rtol=LOSS_RTOL)


def test_sequence_parallel_matches_the_reference(files, tp2):
    """The tiny Llama with sequence_parallel at tensor 2: the norms on half
    the positions, their gradients summed over the tensor ranks inside the
    step; losses of 3 AdamW steps against the reference's TrainStep and
    every reduced gradient (the norms' among them) against the reference's
    backward, the same as without sequence parallelism."""
    sp = W.load(tp2, _run_name("tiny", "adamw", AXES["tiny2"], 1), 2)
    plain = W.load(tp2, _run_name("tiny", "adamw", AXES["tiny2"], 0), 2)
    _, oracle, _ = _ref_run(files, "tiny", "adamw", AXES["tiny2"])
    loss, want = _ref_grads(files, "tiny")
    got = _assembled(sp, "grad", {k: v.shape for k, v in want.items()})
    for k, w in want.items():
        _close(got[k], w, msg=k)
    norms = [k for k in want if "norm" in k]
    assert len(norms) == 5
    for k in norms:
        np.testing.assert_array_equal(sp[0][f"grad.{k}"], sp[1][f"grad.{k}"])
    for rank in sp:
        np.testing.assert_allclose(rank["losses"], oracle, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank["losses"], plain[0]["losses"], rtol=LOSS_RTOL)
    calls = json.loads(str(sp[0]["collectives"]))["calls"]
    assert calls.get("reduce_scatter", 0) > 0 and calls.get("all_gather", 0) > 0


def test_fleet_mp_and_parallelize_mp_config(files, tp2):
    """fleet.init(mp_degree=2): the model group's getters, the model cut by
    distributed_model, and the losses of 3 TrainStep calls through
    distributed_optimizer; parallelize(mp_config) over an mp mesh the same;
    a model without its own schedule (Embedding, Linear, Linear marked on
    mp) cut by parallelize computes what it computed whole; the
    model-parallel RNG differs across the tensor ranks and the shared one
    agrees."""
    r = W.load(tp2, "tp_fleet", 2)
    set_mesh(None)
    model = _tiny()
    model.set_state_dict({k: Tensor(v) for k, v in np.load(files["tiny"]).items()})
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                                 weight_decay=0.1)
    step = TrainStep(model, opt, lambda ids, lab: model(ids, labels=lab)[0])
    tok = np.load(files["tiny_tok"])
    want = [float(step(Tensor(tok[f"ids{i}"]), Tensor(tok[f"labels{i}"]))._data)
            for i in range(3)]
    for rank, got in enumerate(r):
        np.testing.assert_array_equal(got["hcg"], [2, rank, 0])
        assert str(got["mode"]) == "model_parallel"
        for how in ("fleet", "parallelize"):
            np.testing.assert_allclose(got[f"{how}.losses"], want, rtol=LOSS_RTOL)
            np.testing.assert_array_equal(got[f"{how}.q_shape"], [256, 128])
        _close(got["generic.cut"], got["generic.whole"], msg="generic")
        np.testing.assert_array_equal(got["generic.shapes"], [[8, 8], [8, 6], [6, 8]])
    assert not np.array_equal(r[0]["rng.mp"], r[1]["rng.mp"])
    np.testing.assert_array_equal(r[0]["rng.shared"], r[1]["rng.shared"])


# ---------------------------------------------------------------------------
# (e) the semi-auto API, (f) checkpoints
# ---------------------------------------------------------------------------


def test_shard_and_reshard(tp4):
    """``tests/test_distributed.py:18-33`` on dp 2 x mp 2: shard_tensor keeps
    each rank its block and is value-preserving, reshard to Replicate gives
    every rank the whole, the gradient flows back whole; Partial raises;
    shard_layer replicates by default."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for rank, r in enumerate(W.load(tp4, "semi_auto", 4)):
        dp, mp = divmod(rank, 2)
        np.testing.assert_array_equal(r["local"], x[4 * dp:4 * dp + 4, 2 * mp:2 * mp + 2])
        np.testing.assert_array_equal(r["full"], x)
        np.testing.assert_array_equal(r["replicated"], x)
        np.testing.assert_array_equal(r["grad"], np.ones((8, 4), np.float32))
        assert bool(r["has_attr"]) and "Partial" in str(r["partial"])
        assert all(p == "[Replicate(), Replicate()]" for p in r["layer"])


def test_checkpoint_at_fsdp2_tensor2_reshards_and_reaches_the_reference(files, tp4):
    """Saved at fsdp 2 x tensor 2 after two AdamW steps: loaded at fsdp 4
    (tensor 1) the third step's loss is the unbroken run's; the saved
    parameters read by the reference's load_state_dict are those the
    ranks held."""
    from paddle_tpu.distributed import checkpoint as rckpt

    r = W.load(tp4, "tp_ckpt", 4)[0]
    assert bool(r["resharded"])
    np.testing.assert_allclose(r["loss3_loaded"], r["losses"][2], rtol=LOSS_RTOL)
    saved = {k[len("saved."):]: v for k, v in r.items() if k.startswith("saved.")}
    target = {"model": {k: Tensor(np.zeros_like(v)) for k, v in saved.items()}}
    rckpt.load_state_dict(target, files["ckpt"])
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(target["model"][k]._data), v, err_msg=k)
    assert os.path.exists(os.path.join(files["ckpt"], "sharding_manifest.json"))
