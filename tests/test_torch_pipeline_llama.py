"""PyTorch port: the pipeline at pp 2 over two gloo processes: a Llama
split into embedding / decoder layers / norm + head, the rule table's
``stage`` axis (``pipeline_from_rules``) and fleet at ``pp_degree`` 2,
held against the reference on the conftest's CPU mesh.

One launch of 2 ranks of ``tests/torch_dist_worker.py`` feeds every test:
``pipeline_from_rules`` over ``build_program_mesh(pipe=2)``, a direct
``PipelineParallel`` over a ``pp`` axis and one over fleet's mesh (the
reference's ``tests/test_partitioning.py:344-420`` model, V 32, H 16), and
``LlamaConfig.tiny()`` at M 2 in f32 and in bf16, its weights the
reference's by key.

Tolerances: the f32 Llama's loss rtol 1e-5 and every gradient rtol 1e-4 /
atol 1e-5 against the reference's sequential forward and backward (the
reference's own pipeline bounds, ``tests/test_pipeline.py:141-154``); the
three ways to build the pipeline bit for bit; the bf16 stage outputs bit
for bit against the port's one-process traced forward of the same
microbatch, and the untraced forward (RMSNorm's other rounding) must
differ.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as nn
import torch_dist_worker as W
from paddle_tpu.distributed.mesh import set_mesh
from test_partitioning import _Block, _Head

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _shim_state():
    paddle.seed(7)
    emb, layers, head = nn.Embedding(32, 16), [_Block(16) for _ in range(2)], _Head(16, 32)
    out = {f"emb.{k}": np.asarray(v._data) for k, v in emb.state_dict().items()}
    for i, lyr in enumerate(layers):
        out.update({f"layers.{i}.{k}": np.asarray(v._data) for k, v in lyr.state_dict().items()})
    out.update({f"head.{k}": np.asarray(v._data) for k, v in head.state_dict().items()})
    return out


def _llama():
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    paddle.seed(3)
    return LlamaForCausalLM(LlamaConfig.tiny())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppllama")
    set_mesh(None)
    np.savez(tmp / "shim.npz", **_shim_state())
    np.savez(tmp / "llama.npz", **{k: np.asarray(v._data)
                                   for k, v in _llama().state_dict().items()})
    rng = np.random.RandomState(5)
    data = {"shim_ids": rng.randint(0, 32, (4, 8)), "shim_labels": rng.randint(0, 32, (4, 8))}
    tok = np.random.RandomState(13).randint(0, 1024, (4, 17))
    data["llama_ids"], data["llama_labels"] = tok[:, :-1], tok[:, 1:]
    np.savez(tmp / "data.npz", **data)
    return {k: str(tmp / f"{k}.npz") for k in ("shim", "llama", "data")}


@pytest.fixture(scope="module")
def launched(files, tmp_path_factory):
    f = files
    return W.Launch(str(tmp_path_factory.mktemp("pp2")), 2, [
        ["pp_rules", f["shim"], f["data"]], ["pp_llama", f["llama"], f["data"], "float32"],
        ["pp_llama", f["llama"], f["data"], "bfloat16"]])


@pytest.fixture(scope="module")
def reference(files, launched):
    """The reference Llama's loss and gradients on the whole batch."""
    model = _llama()
    d = np.load(files["data"])
    loss, _ = model(paddle.Tensor(jnp.asarray(d["llama_ids"])),
                    labels=paddle.Tensor(jnp.asarray(d["llama_labels"])))
    loss.backward()
    return (float(loss._data), {k: np.asarray(p.grad._data) for k, p in model.named_parameters()},
            model.config.num_hidden_layers)


@pytest.fixture(scope="module")
def pp2(launched, reference):
    return str(launched)


def test_pipeline_from_rules_equals_a_direct_pipeline_and_fleets(pp2):
    """Also make_pipeline_step over functions of parameter trees, bit for
    bit."""
    for got in W.load(pp2, "pp_rules", 2):
        assert list(got["rules_axis"]) == ["pipe", "2", "['pipe']"]
        keys = [k for k in got if k.startswith("direct/")]
        assert len(keys) > 1
        for other in ("rules", "fleet", "functional"):
            assert sorted(k for k in got if k.startswith(other + "/")) == sorted(
                other + k[len("direct"):] for k in keys)
            for k in keys:
                np.testing.assert_array_equal(got[other + k[len("direct"):]], got[k])


def test_one_stage_over_two_data_replicas_matches(pp2):
    """pp 1 x dp 2 under vpp (chunks hand over within the rank), each
    replica on half the rows: the loss and the gradients of pp 2 within
    the pipeline's f32 tolerances."""
    got = W.load(pp2, "pp_rules", 2)
    want = {**{k: v for k, v in got[0].items() if k.startswith("direct/")},
            **{k: v for k, v in got[1].items() if k.startswith("direct/")}}
    for g in got:
        np.testing.assert_allclose(float(g["one_stage/loss"]), float(want["direct/loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["one_stage/first/weight"], want["direct/first/weight"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for k in ("norm.weight", "proj.weight", "proj.bias"):
            np.testing.assert_allclose(g[f"one_stage/last/{k}"], want[f"direct/last/{k}"],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for k in ("fc1.weight", "fc2.bias"):
            stacked = g[f"one_stage/stack/{k}"]     # [1, V, 1, ...]: layer v
            for v in range(2):
                np.testing.assert_allclose(stacked[0, v, 0], got[v][f"direct/stack/{k}"][0, 0],
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_fleet_at_pp_degree_2_gives_the_pipe_topology(pp2):
    for r, got in enumerate(W.load(pp2, "pp_rules", 2)):
        assert list(got["fleet_hcg"]) == [
            "pipeline", str(r), str(r), "2", "[0, 1]", str(r == 0), str(r == 1), str(1 - r),
            str(1 - r)]
        assert bool(got["fleet_model_same"])
        assert list(got["fleet_mesh"]) == ["pp", "dp", "sharding", "sep", "mp", "2", "1", "1",
                                           "1", "1"]


def test_llama_f32_matches_the_reference(pp2, reference):
    loss, want, n_layers = reference
    for got in W.load(pp2, "pp_llama_float32", 2):
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
        seen = {"llama.embed_tokens.weight": got["first/weight"],
                "llama.norm.weight": got["last/norm.weight"],
                "lm_head.weight": got["last/lm_head.weight"]}
        for k, v in got.items():
            if k.startswith("stack/"):
                flat = v.reshape((n_layers,) + v.shape[2:])
                for i in range(n_layers):
                    seen[f"llama.layers.{i}.{k[len('stack/'):]}"] = flat[i]
        assert sorted(seen) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(seen[k], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_llama_bf16_stages_run_the_traced_rounding(pp2):
    """Trap: the stages run inside tracing.traced(), so RMSNorm takes the
    composed form's rounding (the reference's stages are traced)."""
    for got in W.load(pp2, "pp_llama_bfloat16", 2):
        assert got["equal_traced"].all(), got["equal_traced"]
        assert not got["equal_untraced"].any(), got["equal_untraced"]
