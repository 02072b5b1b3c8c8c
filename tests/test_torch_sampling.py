"""PyTorch port: the sampling head and its threefry generator, on the CPU.

The port draws sampled tokens as the reference does, from threefry keys
(``paddle_tpu_torch.random``) held as int64 words: ``PRNGKey``, ``split``
and the raw bits are held bit for bit against ``jax.random`` (with the
partitionable threefry this jax runs), and so is the uniform draw built on
them. The Gumbel noise ``-log(-log(u))`` goes through two libraries' log,
which differ by at most one f32 ulp on some draws: it is held to 2 ulps
(of the larger of the value and 1),
and ``categorical`` (the argmax of logits plus that noise) must still give
the reference's index on every row here (a near-tie between two noisy
logits within an ulp could decide otherwise; none of these rows has one).

The serving head's filters (``filter_logits``, ``filtered_probs``) and its
per-lane pick (``sample_tokens``) are held against the reference's
``sampling`` module under ``jax.vmap`` on the same f32 logits: the filter
bit for bit, the probabilities to 1e-6 (softmax in another order), the
tokens and the advanced keys exactly. Last, the dense generator's sampled
decoding (``LlamaGreedyGenerator(do_sample=True)``) against the
reference's on a tiny f32 Llama: identical ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import sampling as ref_s
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch import random as R
from paddle_tpu_torch.inference.serving import sampling as port_s
from paddle_tpu_torch.models import llama as port_llama

SEEDS = [0, 1, 7, 100, 123456, 2 ** 31 - 1, -5]
TINY = np.finfo(np.float32).tiny
GUMBEL_ULPS = 2
PROBS_ATOL = 1e-6


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_bits_bit_for_bit(seed):
    k = jax.random.PRNGKey(seed)
    pk = R.prng_key(seed)
    np.testing.assert_array_equal(pk.numpy(), _key(seed))
    for num in (2, 5):
        np.testing.assert_array_equal(R.split(pk, num).numpy(),
                                      np.asarray(jax.random.split(k, num), np.int64))
    # a key split twice: the chain the engine follows once a token
    chained = R.split(R.split(pk)[0])[1]
    np.testing.assert_array_equal(
        chained.numpy(), np.asarray(jax.random.split(jax.random.split(k)[0])[1], np.int64))
    for shape in ((7,), (3, 61), (2, 3, 5)):
        np.testing.assert_array_equal(R.random_bits(pk, shape).numpy(),
                                      np.asarray(jax.random.bits(k, shape), np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_exact_and_gumbel_within_two_ulps(seed):
    k, pk = jax.random.PRNGKey(seed), R.prng_key(seed)
    np.testing.assert_array_equal(R.uniform(pk, (4096,), TINY).numpy(),
                                  np.asarray(jax.random.uniform(k, (4096,), minval=TINY)))
    np.testing.assert_array_equal(R.uniform(pk, (300,)).numpy(),
                                  np.asarray(jax.random.uniform(k, (300,))))
    want = np.asarray(jax.random.gumbel(k, (4096,)))
    got = R.gumbel(pk, (4096,)).numpy()
    # the ulp of the larger of |g| and 1: near g = 0 the error is that of
    # the inner log, an ulp of its value near 1
    limit = GUMBEL_ULPS * np.spacing(np.maximum(np.abs(want), np.float32(1)))
    assert np.all(np.abs(got - want) <= limit)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_categorical_one_key_and_a_key_a_row(seed):
    rng = np.random.RandomState(seed % 1000)
    lg = (rng.randn(5, 61) * 2).astype(np.float32)
    k, pk = jax.random.PRNGKey(seed), R.prng_key(seed)
    np.testing.assert_array_equal(R.categorical(pk, torch.from_numpy(lg)).numpy(),
                                  np.asarray(jax.random.categorical(k, lg, axis=-1)))
    keys = jax.random.split(k, 5)
    want = jax.vmap(lambda kk, row: jax.random.categorical(kk, row))(keys, lg)
    np.testing.assert_array_equal(
        R.categorical(R.split(pk, 5), torch.from_numpy(lg)).numpy(), np.asarray(want))


def _lanes(seed, L=6, V=61):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(L, V) * 3).astype(np.float32)
    lg[1, 5] = lg[1, 9] = lg[1].max() + 1.0          # an exact tie at the top
    topk = np.array([0, 1, 5, 0, 7, V], np.int32)[:L]
    topp = np.array([1.0, 0.5, 0.9, 0.3, 1.0, 0.0], np.float32)[:L]
    temp = np.array([1.0, 0.7, 1.3, 0.9, 1e-9, 2.0], np.float32)[:L]
    do = np.array([1, 0, 1, 1, 1, 1], bool)[:L]
    keys = np.stack([_key(100 + i) for i in range(L)])
    return lg, topk, topp, temp, do, keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filters_match_the_reference(seed):
    lg, topk, topp, temp, _, _ = _lanes(seed)
    want = jax.vmap(ref_s.filter_logits)(jnp.asarray(lg), jnp.asarray(topk), jnp.asarray(topp))
    got = port_s.filter_logits(torch.from_numpy(lg), torch.from_numpy(topk),
                               torch.from_numpy(topp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_p = jax.vmap(ref_s.filtered_probs)(jnp.asarray(lg), jnp.asarray(temp),
                                            jnp.asarray(topk), jnp.asarray(topp))
    got_p = port_s.filtered_probs(torch.from_numpy(lg), torch.from_numpy(temp),
                                  torch.from_numpy(topk), torch.from_numpy(topp))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=PROBS_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_tokens_match_the_reference(seed):
    lg, topk, topp, temp, do, keys = _lanes(seed)
    toks, keys2 = ref_s.sample_tokens(jnp.asarray(lg), jnp.asarray(keys.astype(np.uint32)),
                                      jnp.asarray(temp), jnp.asarray(topk),
                                      jnp.asarray(topp), jnp.asarray(do))
    ptoks, pkeys2 = port_s.sample_tokens(
        torch.from_numpy(lg), torch.from_numpy(keys), torch.from_numpy(temp),
        torch.from_numpy(topk), torch.from_numpy(topp), torch.from_numpy(do))
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(pkeys2.numpy(), np.asarray(keys2, np.int64))
    # a greedy lane takes the first of two tied maxima, as argmax does
    assert ptoks[1].item() == 5


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    kw = dict(vocab_size=61, hidden_size=32, intermediate_size=84, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2)
    model = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(use_flash_attention=False,
                                                                  **kw))
    model.eval()
    tree = jax.tree_util.tree_map(np.asarray, ref_llama.decode_weights(model))
    pmodel = port_llama.LlamaForCausalLM(port_llama.LlamaConfig.tiny(**kw), device="cpu")
    pmodel.load_decode_weights(port_llama.weights_from_numpy(tree, device="cpu"))
    return model, pmodel


@pytest.mark.parametrize("kw", [
    dict(do_sample=True, seed=5),
    dict(do_sample=True, top_k=5, top_p=0.8, temperature=0.7, seed=9),
    dict(do_sample=True, top_p=0.5, seed=2 ** 31 - 1),
    dict(do_sample=True, top_k=1, seed=3),
])
def test_sampled_generator_matches_the_reference(models, kw):
    model, pmodel = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 61, n).tolist() for n in (3, 7, 1, 5)]
    ids = np.zeros((4, 7), np.int32)
    plen = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    out, glen = ref_llama.LlamaGreedyGenerator(model, max_len=14, **kw)(
        paddle.to_tensor(ids), paddle.to_tensor(plen))
    pout, pglen = port_llama.LlamaGreedyGenerator(pmodel, max_len=14, **kw)(ids, plen)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(out._data))
    np.testing.assert_array_equal(pglen.numpy(), np.asarray(glen._data))
