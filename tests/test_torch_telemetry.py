"""PyTorch port: the telemetry registry against the reference's, on the CPU.

One scripted sequence of counter, gauge and histogram operations (labels,
``bump``, ``+=``, ``observe`` over every bucket and the overflow one,
collectors, reset hooks) goes into both registries; their ``snapshot()``,
``prometheus_text()``, ``histogram_summaries()`` and ``export_jsonl``
records (timestamps aside) are equal, exactly: the registries hold
integers and the same float sums of the same values in the same order.
The port's producers that moved onto the registry (the optimizer's,
``clip``'s, ``amp``'s) keep their ``stats()``.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import telemetry as ref_tel
from paddle_tpu_torch.profiler import telemetry as port_tel
from torch_op_parity import observability, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("observability", "port_globals")

PREFIX = "test.parity"


def _script(tel):
    """The scripted operations, on one registry."""
    rng = np.random.RandomState(0)
    c = tel.counter(f"{PREFIX}.hits")
    c.bump()
    c.value += 2
    tel.counter(f"{PREFIX}.labeled", kind="x", site="a").bump(5)
    tel.counter(f"{PREFIX}.labeled", kind="y", site="a").bump(7)
    tel.gauge(f"{PREFIX}.depth").set(3)
    tel.gauge(f"{PREFIX}.depth").set(11)
    tel.gauge(f"{PREFIX}.frac", lane="0").set(0.625)
    h = tel.histogram(f"{PREFIX}.lat_us")
    for v in [0.5, 1, 2.5, 7, 99, 1234.5, 3e6, 2e7] + list(rng.exponential(500.0, 40)):
        h.observe(float(v))
    tel.histogram(f"{PREFIX}.bytes", kind="allgather").observe(4096)
    assert tel.counter(f"{PREFIX}.hits") is c  # memoized per name and labels


def _ours(snap):
    return {k: v for k, v in snap.items() if k.startswith(PREFIX)}


def _prom(text):
    return [ln for ln in text.splitlines() if "test_parity" in ln]


def test_snapshot_and_prometheus_text_are_the_references():
    _script(ref_tel)
    _script(port_tel)
    assert _ours(port_tel.snapshot()) == _ours(ref_tel.snapshot())
    assert _prom(port_tel.prometheus_text()) == _prom(ref_tel.prometheus_text())
    ours = {k: v for k, v in port_tel.histogram_summaries().items() if k.startswith(PREFIX)}
    assert ours == {k: v for k, v in ref_tel.histogram_summaries().items()
                    if k.startswith(PREFIX)}
    assert ours[f"{PREFIX}.lat_us"]["count"] == 48


def test_reset_zeroes_and_keeps_the_objects_and_runs_the_hooks():
    hooked = []
    for tel in (ref_tel, port_tel):
        _script(tel)
        held = tel.counter(f"{PREFIX}.hits")
        tel.register_reset_hook(lambda tel=tel: hooked.append(tel))
        tel.reset()
        assert held.value == 0 and tel.counter(f"{PREFIX}.hits") is held
        held.bump()
    assert hooked == [ref_tel, port_tel]
    assert _ours(port_tel.snapshot()) == _ours(ref_tel.snapshot())
    for tel in (ref_tel, port_tel):
        tel._reset_hooks.pop()


def test_collectors_merge_into_the_snapshot():
    for tel in (ref_tel, port_tel):
        tel.register_collector(lambda: {f"{PREFIX}.pulled": 42})
        tel.register_collector(lambda: 1 / 0)   # a broken collector is skipped
    try:
        assert port_tel.snapshot()[f"{PREFIX}.pulled"] == ref_tel.snapshot()[f"{PREFIX}.pulled"]
    finally:
        for tel in (ref_tel, port_tel):
            del tel._collectors[-2:]


def _records(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith(f"telemetry/{PREFIX}"):
                rec.pop("ts")
                out.append(rec)
    return out


def test_export_jsonl_records_are_the_references(tmp_path):
    _script(ref_tel)
    _script(port_tel)
    rp = ref_tel.export_jsonl(str(tmp_path / "ref"), step=3)
    pp = port_tel.export_jsonl(str(tmp_path / "port"), step=3)
    assert os.path.basename(pp) == os.path.basename(rp) == f"telemetry.{os.getpid()}.jsonl"
    assert _records(pp) == _records(rp) and _records(pp)


def test_threads_bumping_lose_no_update():
    import threading

    c = port_tel.counter(f"{PREFIX}.threads")
    h = port_tel.histogram(f"{PREFIX}.threads_us")

    def work():
        for _ in range(2000):
            c.bump()
            h.observe(3)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == 8000 and h.count == 8000 and h.total == 24000


def test_stats_read_the_registry():
    """The optimizer's, clip's and amp's counters live in the registry;
    each ``stats()`` reads them."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, fused_step

    w = torch.nn.Parameter(torch.ones(4))
    opt = SGD(0.1, parameters=[w], grad_clip=ClipGradByGlobalNorm(1.0))
    w.grad = torch.full((4,), 2.0)
    opt.step()
    snap = port_tel.snapshot()
    st = fused_step.stats()
    assert st["dispatches"] == snap["opt.dispatches"] == 1
    assert st["fused_steps"] == snap["opt.fused_steps"] == 1
    assert st["fused_cache_misses"] + st["fused_cache_hits"] == 1
    assert snap['opt.step_us{regime="fused"}.count'] == 1
    ClipGradByGlobalNorm(1.0)([(w, w.grad)])
    assert port_tel.snapshot()["clip.fused_calls"] == 1
    scaler = amp.GradScaler(init_loss_scaling=2.0)
    scaler.unscale_(opt)
    assert amp.stats()["unscale_dispatches"] == port_tel.snapshot()["amp.unscale_dispatches"] == 1
