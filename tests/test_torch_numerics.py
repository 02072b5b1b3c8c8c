"""PyTorch port: the numerics sentinels and the watchdog against the
reference's, on the CPU.

- ``sentinel_tree`` on the same seeded f32 and bf16 tensors, with NaN and
  Inf put into named groups: every count and the digest exactly the
  reference's (integers), ``grad_norm`` within 1e-6 relative (f32 sums in
  another order), ``trace`` mode's per-group max exactly and mean within
  1e-6 relative; the port's plain reduction against its own definition.
- ``resolve_mode`` and ``publish``'s registry entries equal.
- the watchdog fires at the same steps with the same event on a loss
  sequence with a spike and on one with a NaN; rollback mode is refused.
- the tiny Llama's ``TrainStep`` gives bit-identical losses and parameters
  with numerics ``off``, ``summary`` and ``trace`` (the sentinels are pure
  reads), as the reference pins in ``tests/test_numerics.py``, and its
  ``train.grad_norm`` is the reference's step's within 1e-4 relative (two
  f32 backward passes); a poisoned parameter group is named by the
  watchdog, counted and dumped.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import watchdog as ref_watchdog
from paddle_tpu.models import llama as ref
from paddle_tpu.profiler import numerics as ref_num
from paddle_tpu.profiler import telemetry as ref_tel
from paddle_tpu_torch.distributed.resilience import watchdog as port_watchdog
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.ops import sentinels
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import numerics as port_num
from paddle_tpu_torch.profiler import telemetry as port_tel
from torch_op_parity import observability, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("observability", "port_globals")

NORM_RTOL = 1e-6
STEP_NORM_RTOL = 1e-4


def _trees(dtype, poison=False):
    """(reference tree, port tree) of the same values: grads and params of
    three groups, f32 or bf16."""
    rng = np.random.RandomState(3)
    shapes = {"blocks.0.w": (4, 3), "blocks.0.b": (3,), "blocks.1.w": (5, 7),
              "head.w": (2, 2)}
    grads = {k: rng.randn(*s).astype(np.float32) * 3 for k, s in shapes.items()}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    if poison:
        grads["blocks.1.w"][1, 2:5] = np.nan
        grads["blocks.1.w"][0, 0] = -np.inf
        params["head.w"][0, 0] = np.inf
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def both(d):
        j = {k: jnp.asarray(v, jd) for k, v in d.items()}
        if dtype == "bf16":
            t = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(torch.bfloat16)
                 for k, v in j.items()}
        else:
            t = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in j.items()}
        return j, t

    (jg, tg), (jp, tp) = both(grads), both(params)
    loss = np.float32(np.nan if poison else 1.25)
    return (jnp.asarray(loss), jg, jp), (torch.tensor(loss), tg, tp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("mode", ["summary", "trace"])
def test_sentinel_tree_is_the_references(dtype, poison, mode):
    (rl, rg, rp), (pl, pg, pp) = _trees(dtype, poison)
    want = ref_num.host_sentinels(ref_num.sentinel_tree(rl, rg, rp, mode))
    got = port_num.host_sentinels(port_num.sentinel_tree(pl, pg, pp, mode))
    assert sorted(got) == sorted(want)
    for k in ("digest", "loss_nonfinite", "grad_nonfinite", "param_nonfinite", "nonfinite",
              "group_nonfinite_grad", "group_nonfinite_param"):
        assert got[k] == want[k], k
    if poison:
        assert np.isnan(got["grad_norm"]) and np.isnan(want["grad_norm"])
        assert port_num.nonfinite_groups(got) == ref_num.nonfinite_groups(want) == {
            "blocks.1": {"grad": 4}, "head": {"param": 1}}
    else:
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=NORM_RTOL)
    if mode == "trace":
        for g in want["group_absmax"]:
            a, b = got["group_absmax"][g], want["group_absmax"][g]
            assert a == b or (np.isnan(a) and np.isnan(b)) or (np.isinf(a) and np.isinf(b))
            assert got["group_absmean"][g] == pytest.approx(want["group_absmean"][g],
                                                            rel=NORM_RTOL, nan_ok=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_reduction_is_its_definition(dtype):
    """Sums of squares, digests of the f32 bit patterns (a bf16's bits
    shifted left by 16), counts of NaN and Inf."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(n, generator=g).to(dtype) for n in (1, 4097, 70000)]
    ts[1][7] = float("nan")
    ts[2][0:3] = float("inf")
    sq, ints = sentinels.tensor_stats(ts)
    for k, t in enumerate(ts):
        f = t.float().numpy()
        bits = f.view(np.uint32).astype(np.uint64).sum() % 2**32
        assert int(ints[0, k]) == int(bits)
        assert int(ints[1, k]) == int((~np.isfinite(f)).sum())
        want = np.float32(np.sum(f.astype(np.float64) ** 2))
        assert float(sq[k]) == pytest.approx(float(want), rel=1e-5, nan_ok=True)


@pytest.mark.parametrize("value,want", [
    (None, "summary"), ("off", "off"), ("0", "off"), ("false", "off"), ("none", "off"),
    ("1", "summary"), ("true", "summary"), ("ON", "summary"), ("TRACE", "trace")])
def test_resolve_mode_is_the_references(value, want):
    assert port_num.resolve_mode(value) == ref_num.resolve_mode(value) == want


def test_resolve_mode_env_and_refusal(monkeypatch):
    monkeypatch.setenv("PADDLE_NUMERICS", "trace")
    assert port_num.resolve_mode() == ref_num.resolve_mode() == "trace"
    assert port_num.resolve_mode("off") == "off"
    with pytest.raises(ValueError, match="numerics mode"):
        port_num.resolve_mode("verbose")
    assert port_num.group_of("blocks.0.fc1.weight") == ref_num.group_of("blocks.0.fc1.weight")
    assert port_num.group_names(["b.1.w", "b.0.w", "h.w"]) == ref_num.group_names(
        ["b.1.w", "b.0.w", "h.w"])


def test_publish_feeds_the_same_registry():
    sent = {"grad_norm": 3.5, "nonfinite": 3, "group_nonfinite_grad": {"blocks.1": 2},
            "group_nonfinite_param": {"head": 1, "blocks.0": 0}}
    for num in (ref_num, port_num):
        num.publish(sent, loss=2.25)
        num.publish({"grad_norm": 1.5, "nonfinite": 0}, loss=7.0)
    # the values booked: a registry keeps, at zero, the keys every earlier
    # test of the process made
    pick = lambda snap: {k: v for k, v in snap.items() if k.startswith("train.") and v}  # noqa: E731
    assert pick(port_tel.snapshot()) == pick(ref_tel.snapshot())
    assert port_tel.snapshot()['train.nonfinite{tensor="grad",tensor_group="blocks.1"}'] == 2


def _losses(kind):
    rng = np.random.RandomState(7)
    xs = list(2.0 + 0.01 * rng.randn(40))
    if kind == "spike":
        xs[20] = 9.0
    else:
        xs[25] = float("nan")
    return xs


@pytest.mark.parametrize("kind", ["spike", "nan"])
def test_watchdog_fires_at_the_references_steps(kind):
    got = []
    for wd_mod, tel in ((ref_watchdog, ref_tel), (port_watchdog, port_tel)):
        wd = wd_mod.NumericsWatchdog(rollback=False)
        events = []
        for step, loss in enumerate(_losses(kind)):
            sent = {"nonfinite": 0} if np.isfinite(loss) else {
                "nonfinite": 1, "loss_nonfinite": 1, "group_nonfinite_grad": {"blocks.0": 5}}
            ev = wd.observe(step, loss, sent)
            if ev is not None:
                ev = dict(ev)
                ev.pop("loss")
                events.append(ev)
        snap = tel.snapshot()
        # the numerics losses only: a registry keeps, at zero, the keys
        # every earlier test of the process made
        got.append((events, snap.get(f'train.numerics_events{{kind="{"spike" if kind == "spike" else "nonfinite"}"}}'),
                    sorted(k for k in snap if k.startswith('goodput.lost_us{reason="numerics"'))))
    assert got[1] == got[0]
    assert got[1][1] == 1 and len(got[1][0]) == 1
    assert got[1][0][0]["step"] == (20 if kind == "spike" else 25)


def test_watchdog_dumps_the_flight_ring_and_refuses_rollback(monkeypatch, tmp_path):
    wd = port_watchdog.NumericsWatchdog()
    wd.observe(3, float("nan"), {"nonfinite": 1, "loss_nonfinite": 1})
    path = os.path.join(os.environ["PADDLE_FLIGHT_DIR"], "flight.0.jsonl")
    header = json.loads(open(path).readline())
    assert header["reason"] == "numerics:nonfinite"
    monkeypatch.setenv("PADDLE_NUMERICS_ROLLBACK", "1")
    with pytest.raises(NotImplementedError, match="resilience.verified"):
        port_watchdog.NumericsWatchdog()
    assert port_watchdog._store_from_env() is None


def _pair(seed=3):
    paddle.seed(seed)
    cfg = ref.LlamaConfig.tiny()
    model = ref.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    return model, pmodel, state


def _batches(vocab, n=3):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, (2, 16)).astype(np.int64) for _ in range(n)]


def _port_run(state, mode, accumulate_steps=1):
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    opt = AdamW(1e-3, parameters=pmodel.parameters(), weight_decay=0.1)
    step = TrainStep(pmodel, opt, lambda x, y: pmodel(x, labels=y)[0], numerics=mode,
                     accumulate_steps=accumulate_steps)
    losses = [step(torch.from_numpy(b), torch.from_numpy(b)).numpy().copy()
              for b in _batches(pmodel.config.vocab_size)]
    return losses, {n: p.detach().numpy().copy() for n, p in pmodel.named_parameters()}


@pytest.mark.parametrize("accumulate_steps", [1, 2])
def test_train_step_bits_do_not_depend_on_the_sentinels(accumulate_steps):
    _, _, state = _pair()
    off = _port_run(state, "off", accumulate_steps)
    for mode in ("summary", "trace"):
        on = _port_run(state, mode, accumulate_steps)
        assert [x.tobytes() for x in on[0]] == [x.tobytes() for x in off[0]]
        assert all(on[1][n].tobytes() == off[1][n].tobytes() for n in off[1])
    snap = port_tel.snapshot()
    assert snap["train.loss.count"] == 6 and snap["train.grad_norm.count"] == 6


def test_train_step_grad_norm_is_the_references():
    from paddle_tpu.jit.training import TrainStep as RefTrainStep
    from paddle_tpu.optimizer import AdamW as RefAdamW

    model, pmodel, _ = _pair()
    b = _batches(model.config.vocab_size, 1)[0]
    rstep = RefTrainStep(model, RefAdamW(learning_rate=1e-3, parameters=model.parameters()),
                         lambda x, y: model(x, labels=y)[0])
    rstep(paddle.to_tensor(b), paddle.to_tensor(b))
    pstep = TrainStep(pmodel, AdamW(1e-3, parameters=pmodel.parameters()),
                      lambda x, y: pmodel(x, labels=y)[0])
    pstep(torch.from_numpy(b), torch.from_numpy(b))
    want = ref_tel.gauge("train.grad_norm").value
    assert port_tel.gauge("train.grad_norm").value == pytest.approx(want, rel=STEP_NORM_RTOL)
    assert port_tel.gauge("train.loss").value == pytest.approx(
        ref_tel.gauge("train.loss").value, rel=1e-5)


def test_a_poisoned_group_is_named_counted_and_dumped():
    _, pmodel, _ = _pair()
    step = TrainStep(pmodel, AdamW(1e-3, parameters=pmodel.parameters()),
                     lambda x, y: pmodel(x, labels=y)[0])
    b = torch.from_numpy(_batches(pmodel.config.vocab_size, 1)[0])
    step(b, b)
    with torch.no_grad():
        pmodel.llama.layers[1].mlp.up_proj.weight[0, :4] = float("nan")
    step(b, b)
    ev = step._num_watchdog.last_event
    assert ev["kind"] == "nonfinite" and ev["groups"]["llama.layers"]["param"] == 4
    assert port_tel.snapshot()['train.numerics_events{kind="nonfinite"}'] == 1
    path = os.path.join(os.environ["PADDLE_FLIGHT_DIR"], "flight.0.jsonl")
    assert json.loads(open(path).readline())["reason"] == "numerics:nonfinite"
