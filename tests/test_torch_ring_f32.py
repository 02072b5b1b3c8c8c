"""PyTorch port: the ring in f32 and at head dims the wgmma kernels do not
take, on the CPU.

On a TPU the reference's ring takes its ring-flash kernels for any dtype
when ``s_local % 128 == 0`` and ``head_dim % 8 == 0``
(``paddle_tpu/ops/pallas/ring_attention.py:54-66``); the port's gate
follows the head_dim rule on the card, for a shard of any length (the
128 is the TPU kernel's tiling limit), with the flash kernels' f32 and
padded routes, and the merge kernel takes an f32 partial. Here, on the
CPU, with the same numpy inputs:

- the gate's rule, on stand-ins for CUDA tensors;
- the merge with an f32 partial against the reference's ``_merge``;
- the port's ring-flash schedule (its plain kernel versions) in f32 at
  ``S / P = 128`` and head_dim 96, forward and gradients, against the
  reference's composed ring under ``shard_map`` (4-device ``cp`` axis) and
  against the port's full flash attention, causal or not.

Tolerances: outputs 2e-5 and gradients 5e-5 absolute, f32 sums in another
order over at most 512 keys of order-1 terms (as the flash tests); the
merge 1e-6 (the same f32 formula, exp of two libraries).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as PS

import paddle_tpu.distributed as ref_dist
from paddle_tpu.ops.pallas import ring_flash as ref_ring_flash
from paddle_tpu.ops.pallas.ring_attention import ring_attention as ref_ring_attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_attention as ra
from paddle_tpu_torch.ops import ring_flash as rf

ATOL = 2e-5
GRAD_ATOL = 5e-5
MERGE_ATOL = 1e-6
P = 4


def _cuda_like(dtype, s_local, d):
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=(1, s_local, 4, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gate_follows_the_reference_rule_on_the_card(dtype):
    """A CUDA call goes to the kernels when head_dim % 8 == 0, in every
    kernel dtype, whatever the shard's length: the reference's S / P % 128
    is its TPU kernel's tiling limit, and the port's kernels take a ragged
    shard. Other head dims and dtypes stay composed, as the reference keeps
    them; CPU tensors always stay composed."""
    assert ra.flash_runs(_cuda_like(dtype, 128, 128))
    assert ra.flash_runs(_cuda_like(dtype, 512, 96))
    assert ra.flash_runs(_cuda_like(dtype, 1000, 128))
    assert ra.flash_runs(_cuda_like(dtype, 100, 64))
    assert not ra.flash_runs(_cuda_like(dtype, 128, 100))
    assert not ra.flash_runs(_cuda_like(torch.float64, 128, 128))
    assert not ra.flash_runs(torch.zeros((1, 128, 4, 128), dtype=dtype))


def test_merge_takes_an_f32_partial():
    rng = np.random.RandomState(2)
    N, S, H, D = 2, 16, 3, 8
    acc = rng.randn(N, S, H, D).astype(np.float32)
    out_b = rng.randn(N, S, H, D).astype(np.float32)
    lse = (rng.randn(N, H, S) * 3).astype(np.float32)
    lse_b = (rng.randn(N, H, S) * 3).astype(np.float32)
    lse_b[:, :, ::4] = -1e30

    def bhsd(a):   # the reference's layout: [N * H, S, D], lse [N * H, 1, S]
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(N * H, S, D))

    want_acc, want_lse = ref_ring_flash._merge(
        bhsd(acc), jnp.asarray(lse.reshape(N * H, 1, S)), bhsd(out_b),
        jnp.asarray(lse_b.reshape(N * H, 1, S)))
    got_acc, got_lse = torch.from_numpy(acc.copy()), torch.from_numpy(lse.copy())
    out = torch.zeros((1, S, H, D))
    rf.ring_merge(got_acc, got_lse, torch.from_numpy(out_b), torch.from_numpy(lse_b), out)
    np.testing.assert_allclose(
        got_acc.numpy(), np.asarray(want_acc).reshape(N, H, S, D).transpose(0, 2, 1, 3),
        atol=MERGE_ATOL, rtol=MERGE_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(N, H, S),
                               atol=MERGE_ATOL, rtol=MERGE_ATOL)
    assert torch.equal(out, got_acc[:1])


def _reference_ring(q, k, v, do, causal):
    mesh = ref_dist.ProcessMesh(shape=[P], dim_names=["cp"])
    spec = PS(None, "cp")
    ring = shard_map(
        lambda a, b, c: ref_ring_attention(a, b, c, axis_name="cp", causal=causal,
                                           impl="composed"),
        mesh=mesh.jax_mesh, in_specs=(spec, spec, spec), out_specs=spec, check_rep=False)

    def loss(a, b, c):
        return jnp.sum(ring(a, b, c) * jnp.asarray(do))

    out = np.asarray(jax.jit(ring)(q, k, v))
    grads = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]
    return out, grads


def _port(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
def test_f32_ring_flash_at_head_dim_96_matches_the_reference(causal):
    """B 1, S 512 (128 a rank), H 4 over Hk 2, head_dim 96, f32."""
    rng = np.random.RandomState(7 + causal)
    B, S, H, Hk, D = 1, 4 * 128, 4, 2, 96
    q, do = (rng.randn(B, S, H, D).astype(np.float32) for _ in "qo")
    k, v = (rng.randn(B, S, Hk, D).astype(np.float32) for _ in "kv")
    want_out, want_grads = _reference_ring(q, k, v, do, causal)
    for fn in (lambda a, b, c: rf.ring_flash_attention(a, b, c, P, causal),
               lambda a, b, c: fa.flash_attention(a, b, c, causal)):
        out, grads = _port(fn, q, k, v, do)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, want_out, atol=ATOL)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL)
