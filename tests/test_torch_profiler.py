"""PyTorch port: the profiler against the reference's, on the CPU.

- ``Profiler`` over ``torch.profiler`` (CPU target here): the scheduler's
  states are the reference's, ``RecordEvent`` ranges feed
  ``global_statistics`` with the reference's calls, the exported Chrome
  trace names the events and the spans, ``device_trace_summary`` finds the
  annotations, ``summary`` prints the tables;
- the flight recorder's ring, wrap and dump, and the timeline's export of
  two ranks merged by ``tools/trace_merge.py``: the same files (clock
  readings aside) and the same merge report as the reference's;
- attribution: the tiny Llama's ``TrainStep`` counted by the port's
  dispatch mode against the reference's ``cost_model`` over the step's
  unoptimized HLO (its compiled CPU module hides the products in library
  calls): matrix products within PRODUCT_RTOL, all FLOPs within
  TOTAL_RTOL. Elementwise FLOPs differ by design: the reference counts
  XLA's ops (an ``is-finite`` and a ``not`` an element for its
  sentinels' f32 copies, its own converts), the port torch's (the
  sentinels' squares and sums, autograd's accumulations);
- the metric names that each package's ``TrainStep`` and
  ``ServingEngine`` emit are equal but for JAX_ONLY and LATER.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as ref_prof
from paddle_tpu.models import llama as ref
from paddle_tpu.profiler import flight_recorder as ref_flight
from paddle_tpu.profiler import spans as ref_spans
from paddle_tpu.profiler import telemetry as ref_tel
from paddle_tpu.profiler import timeline as ref_timeline
from paddle_tpu_torch import profiler as port_prof
from paddle_tpu_torch.models import llama as port
from paddle_tpu_torch.profiler import attribution
from paddle_tpu_torch.profiler import flight_recorder as port_flight
from paddle_tpu_torch.profiler import spans as port_spans
from paddle_tpu_torch.profiler import telemetry as port_tel
from paddle_tpu_torch.profiler import timeline as port_timeline
from torch_op_parity import observability, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("observability", "port_globals")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT_RTOL = 0.01
TOTAL_RTOL = 0.05
#: metrics only the reference emits: JAX's compiles, its eager dispatch
#: cache (the ``dispatch.*`` family: which of its counters move depends on
#: what the process ran before) and its Pallas fallback probe
JAX_ONLY = {"jit.compiles", "dispatch.ops", "dispatch.cache_entries", "dispatch.cache_hits",
            "dispatch.cache_misses", "ops.pallas_fallback"}
#: emitted by the reference and by a later slice of the port: transfer
#: bytes; and serve.compiles, which the port counts at a CUDA-graph
#: capture, and the CPU engine captures nothing
LATER = {"transfer.h2d_bytes", "serve.compiles"}
#: emitted by either package when a step runs past twice the best one
#: (goodput's unattributed stall): the host's timing, not the code, decides
TIMING = {"goodput.lost_us"}


def _public(mod):
    """Public names of a package that are not modules."""
    import types

    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_public_names_are_the_references():
    import pkgutil

    def submodules(mod):
        return {m.name for m in pkgutil.iter_modules(mod.__path__)}

    assert submodules(port_prof) == submodules(ref_prof)
    want, got = _public(ref_prof), _public(port_prof)
    # the reference's scan of a JAX trace; the port's counterpart reads
    # torch.profiler's events
    assert want - got == {"xplane_device_summary"}
    assert got - want == {"device_time_under"}


def test_scheduler_states_are_the_references():
    for kw in (dict(closed=1, ready=1, record=2), dict(closed=0, record=1, skip_first=2)):
        want = [ref_prof.make_scheduler(**kw)(s).name for s in range(9)]
        assert [port_prof.make_scheduler(**kw)(s).name for s in range(9)] == want


def _session(prof_mod, spans_mod):
    x = torch.randn(32, 32)
    prof = prof_mod.Profiler(targets=[prof_mod.ProfilerTarget.CPU, prof_mod.ProfilerTarget.GPU],
                             scheduler=(1, 3))
    prof.start()
    for step in range(3):
        with prof_mod.RecordEvent("my.block"):
            with spans_mod.span("jit.dispatch", step=step):
                with prof_mod.RecordEvent("my.inner"):
                    (x @ x).relu().sum()
        prof.step()
    prof.stop()
    return prof


def test_profiler_record_event_and_summary(tmp_path, capsys):
    ref_session = _session(ref_prof, ref_spans)
    prof = _session(port_prof, port_spans)
    rows = {r["name"]: r["calls"] for r in port_prof.global_statistics().rows()}
    assert rows == {r["name"]: r["calls"] for r in ref_prof.global_statistics().rows()}
    assert rows == {"my.block": 3, "my.inner": 3}
    path = prof.export(str(tmp_path / "trace.json"))
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    # the RECORD window is steps 1 and 2: two of each range
    assert names.count("my.block") == names.count("jit.dispatch") == 2
    assert any(n == "aten::mm" for n in names)
    dev = prof.device_trace_summary(("jit.dispatch", "my.block", "absent"))
    assert dev["annotations_found"] == ["jit.dispatch", "my.block"]
    assert dev["annotations"]["jit.dispatch"]["calls"] == 2
    assert len(prof._step_times) == len(ref_session._step_times) == 3
    prof.summary()
    out = capsys.readouterr().out
    assert "my.block" in out and "steps: 3" in out
    with pytest.raises(ValueError, match="format='json'"):
        prof.export(str(tmp_path / "x"), format="xplane")


def test_export_chrome_tracing_handler(tmp_path):
    prof = port_prof.Profiler(on_trace_ready=port_prof.export_chrome_tracing(
        str(tmp_path), "w0"))
    with prof:
        torch.ones(3).sum()
    assert json.load(open(tmp_path / "w0.pt.trace.json"))["traceEvents"]


def _fill(flight):
    rec = flight.FlightRecorder(capacity=4, rank=3)
    for k in range(3):
        rec.record("collective", op="all_reduce", shapes=((4, k + 1),), dtypes=("float32",),
                   axes=("dp",), world=2, stack=False)
    seq = rec.record("phase", op="ckpt.save", phase="begin", stack=False)
    rec.update_duration(seq, 12.34)
    rec.record("p2p", op="send", peer=1, stack=False)
    rec.record("numerics", op="train.sentinel", extra={"step": 7, "groups": {"a": {"grad": 2}}},
               stack=False)
    return rec


def _strip(entries):
    return [{k: v for k, v in e.items() if k not in ("ts",)} for e in entries]


def test_flight_recorder_wrap_dump_and_load_are_the_references(tmp_path):
    got = []
    for flight, name in ((ref_flight, "ref"), (port_flight, "port")):
        rec = _fill(flight)
        path = rec.dump(str(tmp_path / f"{name}.jsonl"), reason="explicit")
        header, entries = flight.load_dump(path)
        header = {k: v for k, v in header.items() if k not in ("ts", "pid")}
        got.append((header, _strip(entries), rec.dropped))
    assert got[1] == got[0]
    assert got[1][2] == 2 and [e["cseq"] for e in got[1][1]] == [2, None, 3, None]
    assert port_tel.snapshot()['flight.dumps{reason="explicit"}'] == 1


def _trace_merge():
    spec = importlib.util.spec_from_file_location("trace_merge",
                                                  os.path.join(REPO, "tools", "trace_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rank_files(spans, timeline, d):
    paths = []
    for rank in (0, 1):
        ring = spans.SpanRing(capacity=8)
        base = 1.7e15 + rank * 250.0
        entries = [("backward", 0.0, 900.0, None), ("dp.bucket_sync", 400.0, 700.0,
                                                    {"host_us": 100.0}),
                   ("serve.admit", 1000.0, 50.0, {"req": 1, "trace": "t1"}),
                   ("serve.prefill_chunk", 1100.0, 80.0, {"req": 1, "trace": "t1"})]
        for k, (name, ts, dur, attrs) in enumerate(entries):
            ring.store({"sid": 10 * rank + k + 1, "parent": None, "name": name,
                        "ts_us": base + ts, "dur_us": dur, "tid": 5, "step": 2,
                        "attrs": attrs})
        paths.append(timeline.export_trace(os.path.join(d, f"trace.{rank}.json"), rank=rank,
                                           clock_offset_us=250.0 * rank, ring=ring))
    return paths


def test_timeline_export_and_merge_are_the_references(tmp_path):
    tm = _trace_merge()
    got = []
    for spans, timeline, name in ((ref_spans, ref_timeline, "ref"),
                                  (port_spans, port_timeline, "port")):
        d = tmp_path / name
        d.mkdir()
        doc, report = tm.merge(_rank_files(spans, timeline, str(d)))
        got.append((doc["traceEvents"], report))
    assert got[1] == got[0]
    assert got[1][1]["ranks"] == [0, 1] and got[1][1]["overlap_fraction"] is not None
    assert port_tel.snapshot()["spans.exports"] == 2


def test_h100_spec():
    spec = attribution.spec_for("cuda")
    assert (spec.peak_flops, spec.peak_flops_f32, spec.hbm_bps) == (989e12, 989e12 / 3,
                                                                    3.35e12)
    assert attribution.spec_for("cpu").name == "cpu-host"


def test_the_ratios_before_the_clamp_are_kept():
    """The gauges clamp MFU, the roofline fraction and the decode roofline
    fraction to 1; ``ProgramCosts.unclamped`` keeps each ratio as measured,
    so a count past the device's work (here 2 ms of bytes in a 1 ms wall)
    still shows."""
    from paddle_tpu_torch.profiler import telemetry

    spec = attribution.spec_for("cuda")
    costs = attribution.ProgramCosts()
    costs.put("decode", attribution.ProgramCost("decode", spec, flops=spec.peak_flops * 5e-4,
                                                hbm_bytes=spec.hbm_bps * 2e-3))
    costs.note_dispatch("decode", 1000.0)
    costs.note_decode_tokens("decode", 1000.0, 8)
    raw = costs.unclamped
    assert raw["decode"]["mfu"] == pytest.approx(0.5)
    assert raw["decode"]["roofline_frac"] == pytest.approx(2.0)
    assert raw["decode_roofline_frac"] == pytest.approx(2.0)
    assert telemetry.gauge("jit.program_mfu", program="decode").value == pytest.approx(0.5)
    assert telemetry.gauge("jit.program_roofline_frac", program="decode").value == 1.0
    assert telemetry.gauge("serve.decode_roofline_frac").value == 1.0


def _emitted(snap):
    out = set()
    for k, v in snap.items():
        for suf in (".count", ".sum", ".p50", ".p99"):
            if k.endswith(suf):
                k = k[:-len(suf)]
                break
        if v:
            out.add(k.split("{")[0])
    return out


@pytest.fixture(scope="module")
def runs():
    """The tiny Llama's TrainStep through both packages (two calls each on
    the same weights and tokens), then both ServingEngines on one trace,
    each from reset registries: the metric names each emitted, the port's
    counted cost and gauges, the reference's cost model over the step's
    unoptimized HLO."""
    from paddle_tpu.analysis import cost_model
    from paddle_tpu.analysis.hlo import lower_unoptimized
    from paddle_tpu.inference.serving import ServingEngine as RefEngine
    from paddle_tpu.jit.training import TrainStep as RefTrainStep
    from paddle_tpu.optimizer import AdamW as RefAdamW
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    paddle.seed(3)
    model = ref.LlamaForCausalLM(ref.LlamaConfig.tiny())
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    pmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu")
    port.load_reference_state_dict(pmodel, state)
    ids = np.random.RandomState(0).randint(0, model.config.vocab_size, (2, 16))
    ref_tel.reset()
    port_tel.reset()
    rs = RefTrainStep(model, RefAdamW(learning_rate=1e-3, parameters=model.parameters()),
                      lambda x, y: model(x, labels=y)[0])
    ps = TrainStep(pmodel, AdamW(1e-3, parameters=pmodel.parameters()),
                   lambda x, y: pmodel(x, labels=y)[0])
    for _ in range(2):
        rs(paddle.to_tensor(ids), paddle.to_tensor(ids))
        ps(torch.from_numpy(ids), torch.from_numpy(ids))
    snap = port_tel.snapshot()
    out = {"train": (_emitted(ref_tel.snapshot()), _emitted(snap)),
           "mfu": snap['jit.program_mfu{program="step"}'],
           "roofline": snap['jit.program_roofline_frac{program="step"}'],
           "cost": ps._prog_costs.get("step")}
    fn = rs._make_step_fn(rs._built_policy or "none", bump=False)
    out["ref_cost"] = cost_model.cost_module(
        lower_unoptimized(fn, *rs._planning_args(paddle.to_tensor(ids),
                                                 paddle.to_tensor(ids))).module)
    ref_tel.reset()
    port_tel.reset()
    for engine in (RefEngine(model, num_lanes=2, max_seq_len=64),
                   ServingEngine(pmodel, num_lanes=2, max_seq_len=64, device="cpu")):
        for prompt in ([1, 2, 3, 4, 5], [7, 8, 9]):
            engine.submit(prompt, 4)
        engine.run()
    out["serve"] = (_emitted(ref_tel.snapshot()), _emitted(port_tel.snapshot()))
    return out


def test_flop_count_is_the_reference_cost_models(runs):
    want, got = runs["ref_cost"], runs["cost"]
    dots = sum(c.flops for c in want.instr_costs if c.opcode in ("dot", "convolution"))
    assert got.flops_f32 == pytest.approx(dots, rel=PRODUCT_RTOL)
    assert got.flops == pytest.approx(want.flops, rel=TOTAL_RTOL)
    assert 0 < runs["mfu"] <= 1 and 0 < runs["roofline"] <= 1


def test_metric_names_are_the_references(runs):
    for want, got in (runs["train"], runs["serve"]):
        assert got - TIMING == want - JAX_ONLY - LATER - TIMING
        assert not got & (JAX_ONLY | LATER)
    assert {"train.grad_norm", "jit.program_mfu", "goodput.fraction"} <= runs["train"][1]
    assert {"serve.ttft_us", "serve.decode_roofline_frac", "serve.completed"} <= runs["serve"][1]


def test_kv_audit_books_a_violation_in_the_registry_and_the_ring(monkeypatch):
    """``PADDLE_KV_AUDIT=1``: an allocator count made to drift is booked as
    ``serve.audit_failures`` and a ``kv_audit`` flight record, and the engine
    serves on."""
    from paddle_tpu_torch.inference.serving import ServingEngine

    monkeypatch.setenv("PADDLE_KV_AUDIT", "1")
    engine = ServingEngine(port.LlamaForCausalLM(port.LlamaConfig.tiny(), device="cpu"),
                           num_lanes=2, max_seq_len=64, device="cpu")
    req = engine.submit([1, 2, 3], 3)
    engine.step()
    assert port_tel.snapshot()["serve.audit_failures"] == 0
    engine._kv._ref[0, 5] += 1
    engine.step()
    assert port_tel.snapshot()["serve.audit_failures"] == 1
    assert port_flight.recorder().entries()[-1]["op"] == "serve.audit"
    engine._kv._ref[0, 5] -= 1
    engine.run()
    assert req.status == "done"
