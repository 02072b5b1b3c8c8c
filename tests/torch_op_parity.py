"""Shared by the port's op parity tests (tests/test_torch_ops_*.py): one
case of ``paddle_tpu_torch.tools.op_cases`` through the reference and
through the port (on the CPU), on the same numpy inputs.

Values are held within the tolerance of their dtype class
(``op_cases.TOLERANCE``: f32 and complex64 results to rtol 1e-4 / atol
1e-5, a few special functions to ``op_cases.LOOSE``; integer and boolean
results exactly), dtype names equal, and for a differentiable case the
gradients of every float input under one seeded cotangent (the
reference's tape, i.e. ``jax.vjp``, against torch autograd) within the same
tolerance scaled by the largest gradient. A drawing op is held by shape
and dtype against the reference's, by its check of values (range,
moments), and by replay: ``seed(k)`` twice gives the same draws.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.ops import registry as ref_registry
from paddle_tpu_torch import seed as port_seed
from paddle_tpu_torch.tools import op_cases as oc

GRAD_RTOL = 1e-4


def _scatter_last(x, index, updates, overwrite=True):
    """Paddle's rule for duplicate indices: the last update wins."""
    idx = np.asarray(index._data)
    keep = np.array([k == max(np.nonzero(idx == i)[0]) for k, i in enumerate(idx)])
    return paddle.scatter(x, paddle.to_tensor(idx[keep]),
                          paddle.to_tensor(np.asarray(updates._data)[keep]))


def _scatter_zeroed(x, index, updates, overwrite=False):
    """Paddle's ``overwrite=False``: the written rows zeroed, then every
    update added (the reference adds onto them)."""
    idx = np.asarray(index._data)
    rows = np.ones(x.shape[0], np.float32)
    rows[idx] = 0
    zeroed = x * paddle.to_tensor(rows[:, None])
    return paddle.scatter(zeroed, index, updates, overwrite=False)


#: reference adapters where the port follows Paddle's documented rule and
#: the reference does not (``op_cases`` names them with ``@``)
ADAPTERS = {
    # the reference's add_n calls its own ``sum`` op (which shadows the
    # builtin in its math module) and raises: the sum by ``add``
    "@add_n": lambda xs: xs[0] + xs[1] + xs[2],
    # a 0 in the shape keeps that dimension (the reference's reshape takes no 0)
    "@reshape0": lambda x, shape: paddle.reshape(
        x, [x.shape[k] if s == 0 else s for k, s in enumerate(shape)]),
    "@scatter_last": _scatter_last,
    "@scatter_zeroed": _scatter_zeroed,
    # the mask broadcasts against x (the reference flattens the mask alone)
    "@masked_broadcast": lambda x, mask: paddle.masked_select(
        x, paddle.to_tensor(np.broadcast_to(np.asarray(mask._data), x.shape))),
    # the reference raises (no strided views): numpy's strided view
    "@as_strided": lambda x, shape, stride, offset=0: paddle.to_tensor(
        np.lib.stride_tricks.as_strided(np.ascontiguousarray(x._data).reshape(-1)[offset:],
                                        shape, [s * 4 for s in stride])),
}


def ref_fn(case):
    if case.ref in ADAPTERS:
        return ADAPTERS[case.ref]
    if case.ref:
        mod, _, attr = case.ref.rpartition(".")
        return getattr(importlib.import_module("paddle_tpu." + mod), attr)
    return ref_registry.OP_REGISTRY[case.op].fn


def _ref_arg(a, grad):
    if isinstance(a, oc.L):
        return [_ref_arg(x, grad) for x in a]
    if not isinstance(a, np.ndarray):
        return a
    t = paddle.to_tensor(a)
    if grad and np.issubdtype(a.dtype, np.floating):
        t.stop_gradient = False
    return t


def _ref_leaves(vals):
    out = []
    for x in vals:
        out.extend(_ref_leaves(x) if isinstance(x, list) else [x])
    return out


def ref_run(case, seed, grad):
    args, kw = oc.make_inputs(case, seed)
    rargs = [_ref_arg(a, grad) for a in args]
    rkw = {k: _ref_arg(a, grad) for k, a in kw.items()}
    outs = oc.flat_outputs(ref_fn(case)(*rargs, **rkw))
    if case.first:
        outs = outs[:1]
    grads = None
    leaves = [t for t in _ref_leaves(rargs) + _ref_leaves(list(rkw.values()))
              if isinstance(t, paddle.Tensor) and not t.stop_gradient]
    floats = [o for o in outs if isinstance(o, paddle.Tensor) and not o.stop_gradient]
    if grad and leaves and floats:
        rng = np.random.RandomState(seed + 1)
        loss = None
        for o in floats:
            cot = paddle.to_tensor(np.asarray(rng.standard_normal(o.shape), np.float32))
            cot = cot.astype(o.dtype)
            term = (o * cot).sum()
            loss = term if loss is None else loss + term
        grads = [None if g is None else np.asarray(g._data, np.float32)
                 for g in paddle.grad([loss], leaves, allow_unused=True)]
    vals, names = [], []
    for o in outs:
        if isinstance(o, paddle.Tensor):
            a = np.asarray(o._data)
            names.append(a.dtype.name)
            vals.append(a.astype(np.float32) if a.dtype.name == "bfloat16" else a)
        else:
            names.append(type(o).__name__)
            vals.append(np.asarray(o))
    return vals, names, grads


def check_case(case, seed):
    """Hold ``case`` on the port (CPU) against the reference."""
    grad = case.grad and case.draw is None
    rv, rn, rg = ref_run(case, seed, grad)
    pv, pn, pg = oc.run(case, "cpu", seed, grad=grad)
    assert pn == rn, (pn, rn)
    if case.draw is not None:
        assert [a.shape for a in pv] == [a.shape for a in rv]
        assert case.draw(pv[0]), pv[0]
        port_seed(11)
        once = oc.run(case, "cpu", seed)[0]
        port_seed(11)
        again = oc.run(case, "cpu", seed)[0]
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(once, again))
        return
    oc.compare(pv, rv, pn, case.tol)
    if rg is None:
        assert pg is None or all(g is None or not np.any(g) for g in pg)
        return
    if pg is None:          # the port's result carries no gradient: the reference's is 0
        assert all(w is None or not np.any(w) for w in rg)
        return
    assert len(pg) == len(rg)
    for g, w in zip(pg, rg):
        if w is None or g is None:
            assert (g is None or not np.any(g)) and (w is None or not np.any(w))
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        rtol, _ = case.tol or (GRAD_RTOL, 0)
        np.testing.assert_allclose(g, w, rtol=max(rtol, GRAD_RTOL), atol=GRAD_RTOL * scale)


def case_params(pred, slow=()):
    """``(case, seed)`` pairs of the cases ``pred`` keeps, with test ids
    ``<op>-<k>``: each op's first case (``<op>-0``) runs in tier 1, its
    further ones in the slow tier (``<op>-0`` is their tier-1 sibling), and
    every case of the ops in ``slow`` too (their caller names the tier-1
    sibling)."""
    out = []
    seen = {}
    for n, case in enumerate(oc.CASES):
        if pred(case):
            k = seen.get(case.op, 0)
            seen[case.op] = k + 1
            out.append(pytest.param(case, n, id=f"{case.op}-{k}",
                                    marks=[pytest.mark.slow] if k or case.op in slow else []))
    return out


@pytest.fixture(autouse=True)
def port_globals(monkeypatch):
    """The port's process-wide state, restored after each test: the default
    device (the CPU inside the test), the default dtype, the generators and
    their states, the global initializers and the grad mode."""
    import torch

    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch import dtype as pdtype
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.nn import initializer as pinit

    monkeypatch.setattr(pdevice, "_current", "cpu")
    monkeypatch.setattr(pdtype, "_default", pdtype._default)
    monkeypatch.setattr(prandom, "_seed", prandom._seed)
    gens = dict(prandom._generators)
    states = {d: g.get_state() for d, g in gens.items()}
    inits = dict(pinit._global)
    grad_mode = torch.is_grad_enabled()
    yield
    prandom._generators.clear()
    prandom._generators.update(gens)
    for d, state in states.items():
        gens[d].set_state(state)
    pinit._global.update(inits)
    torch.set_grad_enabled(grad_mode)


@pytest.fixture
def observability(monkeypatch, tmp_path):
    """Both packages' process-wide observability state, reset before and
    after a test: the telemetry registries (and through their reset hooks
    the goodput ledgers and attribution caches), the span rings, the flight
    recorders and the RecordEvent statistics; flight dumps and timeline
    exports go under ``tmp_path``. The goodput ledgers' step hooks are
    emptied for the test (an autopilot an earlier test of the process left
    installed would act on the reference's folds), and the stall factor is
    the default."""
    from paddle_tpu.profiler import flight_recorder as ref_flight
    from paddle_tpu.profiler import goodput as ref_goodput
    from paddle_tpu.profiler import spans as ref_spans
    from paddle_tpu.profiler import statistic as ref_stat
    from paddle_tpu.profiler import telemetry as ref_tel
    from paddle_tpu_torch.profiler import flight_recorder as port_flight
    from paddle_tpu_torch.profiler import goodput as port_goodput
    from paddle_tpu_torch.profiler import spans as port_spans
    from paddle_tpu_torch.profiler import statistic as port_stat
    from paddle_tpu_torch.profiler import telemetry as port_tel

    monkeypatch.setenv("PADDLE_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("PADDLE_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.delenv("PADDLE_GOODPUT_STALL_FACTOR", raising=False)
    for goodput in (ref_goodput, port_goodput):
        monkeypatch.setattr(goodput, "_step_hooks", [])

    def reset():
        for tel, spans, flight, stat in ((ref_tel, ref_spans, ref_flight, ref_stat),
                                         (port_tel, port_spans, port_flight, port_stat)):
            tel.reset()
            spans.enabled(refresh=True)
            spans.clear()
            flight.recorder().clear()
            stat.global_statistics().clear()

    reset()
    yield
    reset()
