"""PyTorch port: the pipeline's schedule tables and ``PipelineLayer``
against the reference, with no launch.

The port keeps its own copy of the reference's schedule tables
(``paddle_tpu/distributed/fleet/pipeline_parallel.py:71-307``): its
tables (``action``, ``mb``, ``chunk``), ``ring`` and ``num_chunks`` equal
the reference's array for array over the reference's own grid
(``tests/test_pipeline.py:80-124``) for every style, ``schedule_cost``
equal, ``verify_schedule`` refusing the same corrupted tables with the same
message, and the same ``ValueError``\\ s. ``PipelineLayer``'s segments,
stage layers, shared layers and eager forward (with and without
``labels=``) against the reference's, its layers' weights carried by key
(outputs within 1e-6 of their largest entry: the same f32 products).
Also here: the rule table's ``stage`` axis and its refusal, ``parallelize``
with ``pp_config`` / ``dp_config``, and the refusals of ``activation_spec``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.fleet.pipeline_parallel as RPP
import paddle_tpu_torch.distributed.fleet.pipeline_parallel as PPP
from paddle_tpu.distributed.fleet import pp_layers as rpl
from paddle_tpu_torch.distributed.fleet import pp_layers as ppl

STYLES = ["1f1b", "fthenb", "gpipe", "zero_bubble", "zbh2"]
GRID = [(2, 2), (4, 4), (4, 8), (2, 6), (4, 16)]
VPP_GRID = [(2, 2), (2, 4), (4, 8)]
CASES = ([(s, P, M, 1) for s in STYLES for P, M in GRID]
         + [("vpp", P, M, V) for V in (2, 4) for P, M in VPP_GRID])


def _same(a, b):
    for f in ("action", "mb", "chunk"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert (a.ring, a.num_chunks, a.style) == (b.ring, b.num_chunks, b.style)


@pytest.mark.parametrize("style,P,M,V", CASES, ids=[f"{c[0]}-P{c[1]}-M{c[2]}-V{c[3]}"
                                                     for c in CASES])
def test_the_tables_are_the_references(style, P, M, V):
    ref = RPP.build_pipeline_schedule(P, M, style, num_chunks=V)
    got = PPP.build_pipeline_schedule(P, M, style, num_chunks=V)
    _same(got, ref)
    assert PPP.schedule_cost(got) == RPP.schedule_cost(ref)
    PPP.verify_schedule(got, M)


def _corrupt(sched, how):
    a, m, c = sched.action.copy(), sched.mb.copy(), sched.chunk.copy()
    if how == "missing_backward":
        t = int(np.argwhere(a[:, 0] == 2)[-1][0])
        a[t, 0] = 0
    elif how == "forward_before_input":
        t = int(np.argwhere(a[:, 1] == 1)[0][0])
        a[0, 1], m[0, 1], c[0, 1] = 1, m[t, 1], c[t, 1]
        a[t, 1] = 0
    elif how == "duplicate_forward":
        t = int(np.argwhere(a[:, 0] == 0)[-1][0])
        a[t, 0], m[t, 0], c[t, 0] = 1, 0, 0
    elif how == "weight_before_backward":
        tw = int(np.argwhere(a[:, 0] == 3)[0][0])
        tb = int(np.argwhere((a[:, 0] == 2) & (m[:, 0] == m[tw, 0]))[0][0])
        a[[tw, tb], 0] = a[[tb, tw], 0]
    return sched._replace(action=a, mb=m, chunk=c)


@pytest.mark.parametrize("how,style", [("missing_backward", "1f1b"),
                                       ("forward_before_input", "fthenb"),
                                       ("duplicate_forward", "1f1b"),
                                       ("weight_before_backward", "zero_bubble")])
def test_verify_schedule_refuses_what_the_reference_refuses(how, style):
    msgs = []
    for mod in (RPP, PPP):
        bad = _corrupt(mod.build_pipeline_schedule(2, 4, style), how)
        with pytest.raises(AssertionError) as e:
            mod.verify_schedule(bad, 4)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("args", [(4, 6, "vpp", 2), (2, 4, "vpp", 1), (2, 4, "1f1b", 2),
                                  (2, 4, "nope", 1)])
def test_the_same_value_errors(args):
    msgs = []
    for mod in (RPP, PPP):
        with pytest.raises(ValueError) as e:
            mod.build_pipeline_schedule(*args[:3], num_chunks=args[3])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_the_stash_bounds_are_the_references():
    """1F1B keeps P graphs in flight, FThenB all M, zero-bubble one more
    than 1F1B (H1) and about 2P (H2)."""
    for style, want in (("1f1b", 4), ("fthenb", 16), ("zero_bubble", 5), ("zbh2", 8)):
        assert PPP.build_pipeline_schedule(4, 16, style).ring == want


# ---------------------------------------------------------------------------
# PipelineLayer
# ---------------------------------------------------------------------------


def _port_linear(i, o):
    from paddle_tpu_torch import nn

    return nn.Linear(i, o, device="cpu")


def _pair(n, shared=False):
    """(reference PipelineLayer, port PipelineLayer) of ``n`` Linear(8, 8)
    (two places naming one shared key when ``shared``), the port's
    weights the reference's by key."""
    from paddle_tpu import nn as rnn

    paddle.seed(11)
    rdescs = [rpl.LayerDesc(rnn.Linear, 8, 8) for _ in range(n)]
    pdescs = [ppl.LayerDesc(_port_linear, 8, 8) for _ in range(n)]
    if shared:
        rdescs[0] = rdescs[-1] = rpl.SharedLayerDesc("tied", rnn.Linear, None, "weight", 8, 8)
        pdescs[0] = pdescs[-1] = ppl.SharedLayerDesc("tied", _port_linear, None, "weight", 8, 8)
    loss_r = lambda y, lab: ((y - lab) ** 2).mean()  # noqa: E731
    loss_p = lambda y, lab: ((y - lab) ** 2).mean()  # noqa: E731
    ref = rpl.PipelineLayer(rdescs, num_stages=2, loss_fn=loss_r)
    port = ppl.PipelineLayer(pdescs, num_stages=2, loss_fn=loss_p)
    port.set_state_dict({k: np.asarray(v._data) for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("n,stages", [(4, 1), (4, 2), (5, 2), (7, 3), (6, 4), (3, 4)])
def test_segments_and_stage_layers_are_the_references(n, stages):
    from paddle_tpu import nn as rnn
    from paddle_tpu_torch import nn as pnn

    ref = rpl.PipelineLayer([rpl.LayerDesc(rnn.ReLU) for _ in range(n)], num_stages=stages)
    port = ppl.PipelineLayer([ppl.LayerDesc(pnn.ReLU) for _ in range(n)], num_stages=stages)
    assert port.segment_parts == ref.segment_parts
    assert port.num_stages == ref.num_stages == stages
    for s in range(stages):
        got = [id(x) for x in port.get_stage_layers(s)]
        assert got == [id(port.run_function[i]) for i in range(ref.segment_parts[s],
                                                                ref.segment_parts[s + 1])]
        assert len(got) == len(ref.get_stage_layers(s))


def test_num_stages_from_the_topology():
    from paddle_tpu.distributed.fleet.topology import CommunicateTopology as RT
    from paddle_tpu_torch.distributed.fleet.topology import CommunicateTopology as PT

    descs = [ppl.LayerDesc(_port_linear, 8, 8) for _ in range(6)]
    port = ppl.PipelineLayer(descs, topology=PT(dims=[1, 3, 1, 1, 1]))
    ref = rpl.PipelineLayer([], topology=RT(dims=[1, 3, 1, 1, 1]))
    assert port.num_stages == ref.num_stages == 3
    assert port.segment_parts == [0, 2, 4, 6]


@pytest.mark.parametrize("shared", [False, True])
def test_the_eager_forward_is_the_references(shared):
    ref, port = _pair(4, shared)
    if shared:
        assert port.run_function[0] is port.run_function[3]
        assert ref.run_function[0] is ref.run_function[3]
        assert len(port.parameters()) == len(ref.parameters()) == 6
    rng = np.random.RandomState(2)
    x, lab = rng.randn(3, 8).astype(np.float32), rng.randn(3, 8).astype(np.float32)
    want = np.asarray(ref(paddle.to_tensor(x))._data)
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    want_loss = float(ref(paddle.to_tensor(x), labels=paddle.to_tensor(lab))._data)
    got_loss = port(torch.from_numpy(x), labels=torch.from_numpy(lab)).item()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)


def test_a_bad_desc_raises_as_the_reference():
    with pytest.raises(TypeError, match="unsupported layer desc"):
        ppl.PipelineLayer([object()])
    with pytest.raises(TypeError, match="unsupported layer desc"):
        rpl.PipelineLayer([object()])


# ---------------------------------------------------------------------------
# the rule table's stage axis, parallelize, the refusals
# ---------------------------------------------------------------------------


def test_the_stage_axis_resolves_as_the_references():
    from paddle_tpu.distributed.partitioning import Partitioner as RP
    from paddle_tpu.distributed.partitioning.pipeline import resolve_stage_axis as rresolve
    from paddle_tpu_torch.distributed import build_program_mesh
    from paddle_tpu_torch.distributed.partitioning import Partitioner, pipeline_from_rules
    from paddle_tpu_torch.distributed.partitioning import resolve_stage_axis

    import paddle_tpu.distributed.mesh as rmesh

    for kw in ({"pipe": 2}, {"dp": 2, "fsdp": 2, "tensor": 2}, {"dp": 4}):
        got = resolve_stage_axis(Partitioner(build_program_mesh(**kw)))
        want = rresolve(RP(rmesh.build_program_mesh(**kw)))
        rmesh.set_mesh(None)
        assert got == want
    assert resolve_stage_axis(Partitioner(build_program_mesh(pipe=2))) == "pipe"
    assert resolve_stage_axis(Partitioner(build_program_mesh(dp=2), rules=[("batch", "dp")])) \
        is None
    with pytest.raises(ValueError, match="stage"):
        pipeline_from_rules(None, [], None, None,
                            partitioner=Partitioner(build_program_mesh(dp=2, fsdp=2, tensor=2)))


def test_parallelize_takes_pp_config_and_dp_config():
    from paddle_tpu_torch import distributed as dist

    lin = _port_linear(4, 4)
    w = lin.weight.detach().clone()
    try:
        got = dist.parallelize(lin, mesh=dist.ProcessMesh(shape=[2], dim_names=["pp"]),
                               config={"pp_config": {"split_spec": "layers"},
                                       "dp_config": {"sharding_level": 0}})
    finally:
        dist.set_mesh(None)
    assert got is lin and torch.equal(lin.weight, w)


@pytest.mark.parametrize("how", ["step", "layer"])
def test_activation_spec_waits_for_the_pipeline_beside_the_tensor_axis(how, monkeypatch):
    """activation_spec waited for the pipeline beside the tensor axis,
    which has come: both entry points take it and go on to the mesh's
    groups (here, with no process group, init_parallel_env's error), and
    it cuts the dim that it puts on a tensor axis over the tensor group
    beside the pipe, none without one (the runs:
    tests/test_torch_hybrid_parallel.py)."""
    import types

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet import PipelineParallel, make_pipeline_step
    from paddle_tpu_torch.distributed.fleet import pipeline_parallel as ppmod

    monkeypatch.setattr(ppmod._env, "device", lambda: torch.device("cpu"))
    mesh = dist.ProcessMesh(shape=[2], dim_names=["pp"])
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        if how == "step":
            make_pipeline_step(None, None, None, mesh=mesh, num_stages=2, num_microbatches=2,
                               activation_spec=("dp", "mp"))
        else:
            PipelineParallel(None, [object()] * 2, None, None, mesh=mesh, num_microbatches=2,
                             activation_spec=("dp", "mp"))
    for group, spec, want in ((object(), ("dp", "mp"), 1), (object(), (None, None, "tensor"), 2),
                              (object(), ("dp", None), None), (None, ("dp", "mp"), None)):
        link = types.SimpleNamespace(tensor_group=group, seq_dim=None)
        ppmod._Link.cut_by(link, spec)
        assert link.seq_dim == want, (spec, want)


def test_the_references_argument_checks():
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet import PipelineParallel

    mesh = dist.ProcessMesh(shape=[2], dim_names=["pp"])
    with pytest.raises(ValueError, match="requires num_chunks >= 2"):
        PipelineParallel(None, [object()] * 4, None, None, mesh=mesh, schedule="vpp")
    with pytest.raises(ValueError, match="does not use model chunks"):
        PipelineParallel(None, [object()] * 4, None, None, mesh=mesh, num_chunks=2)
    with pytest.raises(AssertionError, match="not divisible"):
        PipelineParallel(None, [object()] * 3, None, None, mesh=mesh)
