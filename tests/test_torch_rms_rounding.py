"""PyTorch port: where RMSNorm rounds, on the CPU.

The reference's ``rms_norm`` (``paddle_tpu/nn/functional/norm.py:67-94``)
has two forms. Eager f32 and bf16 calls take its fused kernel, which
applies the weight in f32 before its one rounding; traced calls, its whole
compiled ``TrainStep`` included, take the composed form, which rounds the
normalised row to x's dtype and then multiplies by the weight in that
dtype; fp16 is always composed. The port marks a traced call with
``paddle_tpu_torch.tracing`` (``jit.TrainStep`` enters it) and gives its
RMSNorm kernel the composed form's rounding there (``round_first``), so
the kernel stays on the training path:

- inside ``traced()``, the port's ``rms_norm`` in bf16 and fp16 with a
  non-unit weight against the reference's ``rms_norm`` under ``jax.jit``
  with ``jax.grad``: the forward bit for bit, dx and dw within a step;
- ``TrainStep`` and ``EvalStep`` of a bf16 ``RMSNorm`` layer take that
  form (the eval output bit for bit against the reference's jitted
  ``EvalStep``; one SGD step at lr 1 moves the weight by the reference's
  gradient);
- eager calls keep the fused form, bit for bit against the reference's
  fused Pallas kernel in interpret mode.

Each forward hold has a control: in bf16 the other form, held the same way,
fails (the forms differ on about a quarter of the elements).

Tolerances: the forward is the same f32 arithmetic in another summation
order, then the same roundings, and is bit for bit at these shapes. dx is
a difference of two terms as large as the largest dx (``inv * dn - x *
c``) and dw a sum over rows; the reference under ``jax.jit`` may keep
excess precision where the composed form rounds (XLA on the CPU keeps
``d_out * w`` in f32), so each is held to one step of the dtype (2^-7
bf16, 2^-10 fp16), relative and of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as RF
from paddle_tpu.ops.pallas import fused_norm as ref_fn
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import tracing
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional.norm import rms_norm_composed
from paddle_tpu_torch.ops import fused_norm as fn
from paddle_tpu_torch.optimizer import SGD

EPS = 1e-6
STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
ATOL_FRAC = 1e-3


def _draw(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    w = (rng.rand(shape[-1]) * 1.5 + 0.25).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    # both sides start from the same values of the low-precision type
    x = torch.from_numpy(x).to(dtype).float().numpy()
    w = torch.from_numpy(w).to(dtype).float().numpy()
    return x, w, g


def _reference(x, w, g, dtype):
    """The reference's rms_norm traced under jax.jit: out, dx, dw."""
    def loss(xa, wa):
        out = RF.rms_norm(Tensor(xa), Tensor(wa), EPS)._data
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), (dx, dw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x, JNP[dtype]), jnp.asarray(w, JNP[dtype]))
    return [np.asarray(a, np.float32) for a in (out, dx, dw)]


def _port(x, w, g, dtype, traced: bool):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    with tracing.traced() if traced else torch.enable_grad():
        out = PF.rms_norm(xt, wt, EPS)
        (out.float() * torch.from_numpy(g)).sum().backward()
    return [a.detach().float().numpy() for a in (out, xt.grad, wt.grad)]


def _close(got, want, rtol, atol_frac=ATOL_FRAC):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(6, 64), (5, 3, 40), (16, 256)])
def test_traced_rms_norm_is_the_references_jitted_form(dtype, shape):
    x, w, g = _draw(sum(shape), shape, dtype)
    want = _reference(x, w, g, dtype)
    got = _port(x, w, g, dtype, traced=True)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        _close(a, b, STEP[dtype], STEP[dtype])
    if dtype == torch.bfloat16:
        # control: the eager (fused) form fails this forward hold
        assert (_port(x, w, g, dtype, traced=False)[0] != want[0]).mean() > 0.05


def test_fp16_is_composed_eager_or_traced(monkeypatch):
    """fp16 never reaches the kernel op, as the reference's rule keeps it
    off its kernel; eager and traced give the same values."""
    monkeypatch.setattr(fn, "rms_norm_2d", lambda *a, **k: pytest.fail("kernel op called"))
    x, w, g = _draw(3, (4, 48), torch.float16)
    np.testing.assert_array_equal(_port(x, w, g, torch.float16, traced=False)[0],
                                  _port(x, w, g, torch.float16, traced=True)[0])


@pytest.mark.parametrize("shape", [(16, 128), (8, 256)])
def test_eager_bf16_keeps_the_fused_kernels_rounding(shape):
    x, w, _ = _draw(9 + shape[1], shape, torch.bfloat16)
    want = np.asarray(ref_fn.rms_norm_2d(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16), EPS).astype(jnp.float32))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    np.testing.assert_array_equal(PF.rms_norm(xt, wt, EPS).float().numpy(), want)
    with tracing.traced():
        # control: the traced (composed) form fails this hold
        assert (PF.rms_norm(xt, wt, EPS).float().numpy() != want).mean() > 0.05


def test_eval_step_runs_traced_and_is_the_references_jitted_eval_step(monkeypatch):
    """An EvalStep of a bf16 RMSNorm layer with a non-unit weight runs its
    rms_norm traced, in the kernel op's round_first mode, and gives the
    reference's jitted EvalStep's output bit for bit."""
    from paddle_tpu import jit as ref_jit
    from paddle_tpu import nn as ref_nn

    modes = []
    real = fn.rms_norm_2d
    monkeypatch.setattr(fn, "rms_norm_2d",
                        lambda x, w, eps, round_first=False:
                        modes.append(round_first) or real(x, w, eps, round_first))
    x, w, _ = _draw(33, (8, 64), torch.bfloat16)
    layer = RMSNorm(64, epsilon=EPS, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    (got,) = EvalStep(layer, lambda a: layer(a))(torch.from_numpy(x).bfloat16())
    assert modes == [True] and not tracing.is_traced()
    ref = ref_nn.RMSNorm(64, epsilon=EPS)
    ref.weight._data = jnp.asarray(w, jnp.bfloat16)
    (want,) = ref_jit.EvalStep(ref, lambda a: ref(a))(Tensor(jnp.asarray(x, jnp.bfloat16)))
    want = np.asarray(want._data, np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # control: the eager (fused) form fails this hold
    assert (PF.rms_norm(torch.from_numpy(x).bfloat16(), layer.weight.detach(), EPS)
            .float().numpy() != want).mean() > 0.05


def test_train_step_runs_traced_and_takes_the_composed_form(monkeypatch):
    """A TrainStep of a bf16 RMSNorm layer: its rms_norm call runs traced
    and reaches the kernel op in its round_first mode; one SGD step at lr 1
    moves the weight by the reference's jitted gradient."""
    modes = []
    real = fn.rms_norm_2d
    monkeypatch.setattr(fn, "rms_norm_2d",
                        lambda x, w, eps, round_first=False:
                        modes.append(round_first) or real(x, w, eps, round_first))
    x, w, g = _draw(21, (8, 64), torch.bfloat16)
    layer = RMSNorm(64, epsilon=EPS, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    opt = SGD(learning_rate=1.0, parameters=layer.parameters())
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g)
    step = TrainStep(layer, opt, lambda a: (layer(a).float() * gt).sum())
    assert not tracing.is_traced()
    step(xt)
    assert modes == [True] and not tracing.is_traced()
    _, _, dw = _reference(x, w, g, torch.bfloat16)
    want = (torch.from_numpy(w).bfloat16() - torch.from_numpy(dw).bfloat16()).float().numpy()
    step_ = STEP[torch.bfloat16]
    np.testing.assert_allclose(layer.weight.detach().float().numpy(), want,
                               rtol=step_, atol=step_ * np.abs(dw).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_round_first_is_the_composed_gradient(dtype):
    """The kernel's plain versions in ``round_first``: forward, dx and dw
    against torch autograd through the composed form itself."""
    x, w, g = _draw(13, (12, 96), dtype)
    xt, wt = (torch.from_numpy(a).to(dtype) for a in (x, w))
    out, inv = fn.rms_norm_fwd_ref(xt, wt, EPS, round_first=True)
    xc, wc = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    want = rms_norm_composed(xc, wc, EPS)
    (want.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.float().numpy(), want.detach().float().numpy())
    gd = torch.from_numpy(g).to(dtype)
    dx = fn.rms_norm_bwd_dx_ref(xt, wt, inv, gd, round_first=True)
    dw = fn.rms_norm_dw(xt, inv, gd, dtype, round_first=True)
    rtol = STEP.get(dtype, 1e-5)
    _close(dx.float().numpy(), xc.grad.float().numpy(), rtol, rtol)
    _close(dw.float().numpy(), wc.grad.float().numpy(), rtol, rtol)
