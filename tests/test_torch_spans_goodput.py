"""PyTorch port: spans and goodput against the reference's, on the CPU.

The same span nesting (attributes set while open, an instant event, an
exception), the same ring wrap and the same goodput folds (losses clamped
to a step's wall with the excess carried over, an unattributed stall past
twice the best step, a fully lost step) go through both packages: the
recorded structure (names, parents, steps, attributes, drop counts) and the
ledgers (each fold, the summary, the ``goodput.*`` metrics) are equal;
durations are host clock readings, held only to be non-negative and
nested. A slow dataset through the port's ``DataLoader`` and the
reference's gives one ``dataload.fetch`` span a batch plus the end-of-epoch
fetch in both, and both book the consumer's wait as goodput ``stall``
(site ``dataload``).
"""

import time

import numpy as np
import pytest

from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import goodput as ref_goodput
from paddle_tpu.profiler import spans as ref_spans
from paddle_tpu.profiler import telemetry as ref_tel
from paddle_tpu_torch.profiler import flight_recorder as port_flight
from paddle_tpu_torch.profiler import goodput as port_goodput
from paddle_tpu_torch.profiler import spans as port_spans
from paddle_tpu_torch.profiler import telemetry as port_tel
from torch_op_parity import observability, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("observability", "port_globals")

PAIRS = ((ref_spans, ref_flight), (port_spans, port_flight))


def _nest(spans, flight):
    with spans.span("outer", step=1, a=1) as o:
        with spans.span("inner", step=1) as i:
            i.set(b=2)
            spans.event("mark", step=1, c=3)
            flight.recorder().record("phase", op="inside", stack=False)
            assert spans.current_id() == i.sid
        with spans.span("inner2"):
            pass
        o.set(done=True)
    with pytest.raises(ValueError):
        with spans.span("fails"):
            raise ValueError("boom")
    assert spans.current_id() is None


def _structure(entries):
    index = {e["sid"]: k for k, e in enumerate(entries)}
    return [(e["name"], index.get(e["parent"]), e["step"], e["attrs"]) for e in entries]


def test_nesting_events_and_errors_are_the_references():
    got = []
    for spans, flight in PAIRS:
        t0 = time.time() * 1e6
        _nest(spans, flight)
        t1 = time.time() * 1e6
        entries = spans.entries()
        for e in entries:
            assert t0 - 1e3 <= e["ts_us"] <= t1 + 1e3 and e["dur_us"] >= 0
        outer = next(e for e in entries if e["name"] == "outer")
        inner = next(e for e in entries if e["name"] == "inner")
        assert outer["ts_us"] <= inner["ts_us"] and inner["dur_us"] <= outer["dur_us"]
        # a flight entry recorded inside a span carries the span's id
        assert flight.recorder().entries()[-1]["corr"] == inner["sid"]
        got.append(_structure(entries))
    assert got[1] == got[0]
    assert ("fails", None, None, {"error": "ValueError: boom"}) in got[1]


def test_ring_wrap_and_disable_are_the_references(monkeypatch):
    got = []
    for spans, _ in PAIRS:
        ring = spans.SpanRing(capacity=4)
        for k in range(6):
            ring.store({"sid": k + 1, "parent": None, "name": f"s{k}", "ts_us": float(k),
                        "dur_us": 1.0, "tid": 0, "step": k, "attrs": None})
        got.append((ring.dropped, [e["name"] for e in ring.entries()]))
        ring.clear()
        assert ring.entries() == [] and ring.dropped == 0
    assert got[1] == got[0] == (2, ["s2", "s3", "s4", "s5"])
    monkeypatch.setenv("PADDLE_SPANS", "0")
    for spans, _ in PAIRS:
        spans.enabled(refresh=True)
        with spans.span("off") as sp:
            pass
        assert sp.sid == 0 and spans.event("off") == 0 and spans.entries() == []
    monkeypatch.delenv("PADDLE_SPANS")
    for spans, _ in PAIRS:
        spans.enabled(refresh=True)


def _folds(goodput):
    out = []
    goodput.note_loss("retry", 300.0, site="transport.a")
    out.append(goodput.step(1000.0, kind="train", scope="s"))      # 300 lost
    goodput.note_loss("stall", 2500.0, site="dataload")
    out.append(goodput.step(1000.0, kind="train", scope="s"))      # clamped, 1500 carry
    out.append(goodput.step(2000.0, kind="train", scope="s"))      # the carry: best 500
    out.append(goodput.step(800.0, kind="train", scope="s"))
    out.append(goodput.step(5000.0, kind="train", scope="s"))      # past 2x best
    out.append(goodput.step(400.0, kind="serve", scope="t"))
    goodput.note_loss("eviction", 0.0, site="serve.cancel")        # ignored
    out.append(goodput.fraction())
    out.append(goodput.summary())
    return out


def test_goodput_folds_are_the_references():
    assert port_goodput.fraction() is None and ref_goodput.fraction() is None
    want, got = _folds(ref_goodput), _folds(port_goodput)
    assert got == want
    # the values booked: a registry keeps, at zero, the keys every earlier
    # test of the process made
    pick = lambda snap: {k: v for k, v in snap.items() if k.startswith("goodput.") and v}  # noqa: E731
    assert pick(port_tel.snapshot()) == pick(ref_tel.snapshot())
    assert got[4]["unattributed_us"] == 5000.0 - 2 * 500.0
    port_tel.reset()
    assert port_goodput.fraction() is None and port_goodput.summary()["lost_us"] == 0


class _Slow:
    """Eight items, each 4 ms to make."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(0.004)
        return np.full((3,), i, np.float32), np.int64(i)


def test_dataload_fetch_spans_and_stall_match_the_references():
    import paddle_tpu.io as ref_io
    import paddle_tpu_torch.io as port_io

    loaders = ((ref_io.DataLoader(_Slow(), batch_size=2), ref_spans, ref_tel),
               (port_io.DataLoader(_Slow(), batch_size=2, device="cpu"), port_spans, port_tel))
    got = []
    for loader, spans, tel in loaders:
        batches = list(loader)
        fetches = [e for e in spans.entries() if e["name"] == "dataload.fetch"]
        stall = tel.snapshot().get('goodput.lost_us{reason="stall",site="dataload"}', 0)
        waited = sum(e["dur_us"] for e in fetches if e["dur_us"] > 1000)
        # the stall booked is the fetches' waits past 1 ms (read just before
        # each span closes: within 1%)
        assert 0 < stall <= waited and stall == pytest.approx(waited, rel=0.01)
        got.append((len(batches), len(fetches), stall > 0))
    assert got[1] == got[0] == (4, 5, True)


def test_serving_spans_events_and_eviction_match_the_references():
    """The same trace through both engines (a cancel after the second step):
    the same spans and events by name, the same serving counters, and the
    cancelled lane's time booked as goodput ``eviction`` in both."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import ServingEngine as RefEngine
    from paddle_tpu.models import llama as ref
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models import llama as port

    paddle.seed(3)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny())
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    got = []
    for engine, spans, tel in ((RefEngine(model, num_lanes=2, max_seq_len=64, prefill_chunk=4),
                                ref_spans, ref_tel),
                               (ServingEngine(pmodel, num_lanes=2, max_seq_len=64,
                                              prefill_chunk=4, device="cpu"),
                                port_spans, port_tel)):
        reqs = [engine.submit(p, 5) for p in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [7, 8, 9], [4, 4])]
        engine.step()
        engine.step()
        engine.cancel(reqs[0])
        engine.run()
        names = {}
        for e in spans.entries():
            names[e["name"]] = names.get(e["name"], 0) + 1
        snap = tel.snapshot()
        counts = {k: snap[k] for k in ("serve.admitted", "serve.completed", "serve.steps",
                                       "serve.prefill_chunks", 'serve.evicted{reason="cancel"}',
                                       "serve.ttft_us.count", "serve.inter_token_us.count")}
        lost = snap.get('goodput.lost_us{reason="eviction",site="serve.cancel"}', 0)
        got.append((names, counts, lost > 0, [r.status for r in reqs]))
    assert got[1] == got[0]
    assert got[1][0]["serve.decode.dispatch"] == got[1][0]["serve.decode.sync"] > 0
