"""PyTorch port: the functional Llama decode against the reference.

One tiny GQA model (2 layers, H 4, Hk 2, f32) is built by the reference;
its ``decode_weights`` tree goes to the port through numpy
(``weights_from_numpy``), so both sides compute the same function. Each
piece (rope tables, RMSNorm, masked attention), whole ``decode_step``
logits in f32 and int8, and greedy generation are compared. Tolerances:
f32 products and sums in another order, at magnitudes of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as ref
from paddle_tpu_torch.models import llama as port

VOCAB = 61
ATOL = RTOL = 1e-5          # single ops
LOGITS_ATOL = 1e-4          # 2-layer decode_step, logits of order 1


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    cfg = ref.LlamaConfig.tiny(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=84,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        use_flash_attention=False)
    model = ref.LlamaForCausalLM(cfg)
    model.eval()
    tree = jax.tree_util.tree_map(np.asarray, ref.decode_weights(model))
    pcfg = port.LlamaConfig.tiny(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=84,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    pmodel = port.LlamaForCausalLM(pcfg, device="cpu")
    pmodel.load_decode_weights(port.weights_from_numpy(tree, device="cpu"))
    return model, pmodel


def test_parameter_names_and_layouts_mirror_reference(models):
    model, pmodel = models
    names = dict(pmodel.named_parameters())
    for key in ("llama.embed_tokens.weight", "llama.norm.weight", "lm_head.weight",
                "llama.layers.1.self_attn.k_proj.weight",
                "llama.layers.0.mlp.down_proj.weight",
                "llama.layers.0.post_attention_layernorm.weight"):
        assert key in names
    assert tuple(names["llama.layers.0.self_attn.k_proj.weight"].shape) == (32, 16)
    assert tuple(names["llama.layers.0.mlp.down_proj.weight"].shape) == (84, 32)
    assert tuple(names["lm_head.weight"].shape) == (32, VOCAB)
    want = np.asarray(model.llama.layers[1].mlp.gate_proj.weight._data)
    np.testing.assert_array_equal(
        names["llama.layers.1.mlp.gate_proj.weight"].detach().numpy(), want)


def test_training_forward_waits_for_its_slice(models):
    """The training forward has landed: on the same weights its logits match
    the reference model's forward (composed attention, f32)."""
    model, pmodel = models
    ids = np.random.RandomState(3).randint(0, VOCAB, (2, 7)).astype(np.int64)
    want = model(paddle.to_tensor(ids)).numpy()
    got = pmodel(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == (2, 7, VOCAB)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=LOGITS_ATOL)


@pytest.mark.parametrize("theta,hd", [(10000.0, 8), (500000.0, 128)])
def test_rope_tables(theta, hd):
    pos = np.array([0, 1, 7, 63, 511], np.int32)
    s_ref, c_ref = ref.rope_tables(jnp.asarray(pos), theta, hd)
    s, c = port.rope_tables(torch.from_numpy(pos), theta, hd)
    # angles up to 511 rad: f32 sin/cos of large arguments agree to ~1e-5
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-4)
    x = np.random.RandomState(0).randn(5, 3, hd).astype(np.float32)
    want = ref.rope_rotate(jnp.asarray(x), s_ref[:, None, :], c_ref[:, None, :])
    got = port.rope_rotate(torch.from_numpy(x), s[:, None, :], c[:, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_rms():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 1, 32) * 4).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    want = ref.decode_rms(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = port.decode_rms(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rep", [1, 2])
def test_masked_attend(rep):
    rng = np.random.RandomState(2 + rep)
    b, S, Hk, hd = 3, 11, 2, 8
    q = rng.randn(b, Hk * rep, hd).astype(np.float32)
    kc = rng.randn(b, S, Hk, hd).astype(np.float32)
    vc = rng.randn(b, S, Hk, hd).astype(np.float32)
    vis = np.arange(S)[None, :] <= np.array([0, 4, 10])[:, None]
    want = ref.masked_attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(vis))
    got = port.masked_attend(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _dense_step(decode, cfg, w, caches, tok, pos, max_len, lib):
    """One decode_step over dense caches prefilled with the same random
    rows on both sides, at one shared position."""
    if lib == "ref":
        kv = ref.DenseDecodeKV([(jnp.asarray(k), jnp.asarray(v)) for k, v in caches],
                               jnp.asarray(pos, jnp.int32), max_len)
        logits = decode(cfg, w, jnp.asarray(tok),
                        kv, jnp.full((len(tok),), pos, jnp.int32))
        return np.asarray(logits)
    kv = port.DenseDecodeKV([(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                             for k, v in caches], pos, max_len)
    logits = decode(cfg, w, torch.from_numpy(tok), kv,
                    torch.full((len(tok),), pos, dtype=torch.int32))
    return logits.numpy()


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_logits(models, quantized):
    model, pmodel = models
    cfg = model.config
    w_ref = ref.decode_weights(model)
    w_port = port.decode_weights(pmodel)
    if quantized:
        w_ref = ref.quantize_decode_weights(w_ref)
        w_port = port.quantize_decode_weights(w_port)
    rng = np.random.RandomState(4)
    max_len, pos = 9, 5
    caches = [(rng.randn(3, max_len, 2, 8).astype(np.float32),
               rng.randn(3, max_len, 2, 8).astype(np.float32)) for _ in range(2)]
    tok = np.array([3, 17, 60], np.int32)
    want = _dense_step(ref.decode_step, cfg, w_ref, caches, tok, pos, max_len, "ref")
    got = _dense_step(port.decode_step, pmodel.config, w_port, caches, tok, pos,
                      max_len, "port")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=LOGITS_ATOL)


def test_greedy_generator_tokens_equal(models):
    model, pmodel = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB, rng.randint(1, 8)).tolist() for _ in range(5)]
    ids = np.zeros((5, max(map(len, prompts))), np.int32)
    plen = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    max_len = 14
    out, glen = ref.LlamaGreedyGenerator(model, max_len=max_len, eos_token_id=-1)(
        paddle.to_tensor(ids), paddle.to_tensor(plen))
    pout, pglen = port.LlamaGreedyGenerator(pmodel, max_len=max_len)(ids, plen)
    np.testing.assert_array_equal(pglen.numpy(), np.asarray(glen._data))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(out._data))


def test_generator_eos_and_sampling_guard(models):
    _, pmodel = models
    ids = np.array([[5, 9]], np.int32)
    out, glen = port.LlamaGreedyGenerator(pmodel, max_len=10)(ids, np.array([2]))
    eos = int(out[0, 2])
    out2, glen2 = port.LlamaGreedyGenerator(pmodel, max_len=10, eos_token_id=eos)(
        ids, np.array([2]))
    # the lane finished at its first generated token, so the loop stopped
    assert int(glen2[0]) == 3 and int(out2[0, 2]) == eos
    assert out2[0, :3].tolist() == out[0, :3].tolist()
    # sampling with top_k=1 keeps only the largest logit: greedy again
    out3, glen3 = port.LlamaGreedyGenerator(pmodel, max_len=10, do_sample=True, top_k=1,
                                            seed=3)(ids, np.array([2]))
    assert out3.tolist() == out.tolist() and glen3.tolist() == glen.tolist()
