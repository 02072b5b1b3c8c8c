"""Pipeline parallelism, one process a stage (counterpart of
``paddle_tpu/distributed/fleet/pipeline_parallel.py:1-790``).

The schedule half is numpy and the port's own copy of the reference's:
:class:`PipelineSchedule`, :func:`build_pipeline_schedule` (styles
``1f1b``, ``fthenb`` / ``gpipe``, ``vpp`` / ``interleaved`` over
``num_chunks`` model chunks, ``zero_bubble`` / ``zb`` / ``zbh1`` /
``zbh2`` with the backward split into B and W), :func:`verify_schedule`
and :func:`schedule_cost` give the reference's tables, array for array.

The runtime is Paddle's imperative design rather than the reference's
single SPMD program (a ``lax.scan`` over ticks in which every stage takes
its branch): each rank holds its stages' layers as live ``nn.Layer``\\ s on
its device and walks its column of the same table. At each tick it runs
its action on one (chunk, microbatch):

- F: the forward under autograd, inside ``tracing.traced()`` (the
  reference's stages are traced, so ``rms_norm`` takes the composed form's
  rounding, as in ``TrainStep``). The first virtual stage starts from
  ``first`` on the microbatch's ids, the others from the activation
  received; the last virtual stage ends in ``last`` and the loss. The
  graph of every microbatch in flight is kept until its backward (until
  its W under zero-bubble) and freed there, so the number in flight on a
  chunk never passes the table's ``ring``: 1F1B's activation memory grows
  with the stages, FThenB's with the microbatches.
- B: the backward of that graph, seeded with the cotangent received (the
  last virtual stage with ``1/M`` on its loss, ``:416``, ``:461``),
  accumulating the parameters' gradients in their own dtype, as the
  reference's accumulator. Under zero-bubble B is the gradient of the
  stage's output with respect to its input only, the graph kept, and W the
  deferred gradient with respect to the stage's parameters; the first
  virtual stage has no input to differentiate, so its B only records the
  cotangent for its W.

After the action the rank posts the sends and receives that the table
implies for it and its neighbours (activations to stage ``p + 1``, from
stage ``P - 1`` chunk ``v`` to stage 0 chunk ``v + 1``, cotangents the
other way) and keeps what arrives in the ``(chunk, microbatch)`` slot the
reference computes (``lslot`` / ``rslot``): :mod:`._pipe_p2p`. The loss is
the last stage's sum over microbatches over ``M``, given to every stage
(the reference's ``psum``).

Beside the pipe axis (the reference leaves them to GSPMD inside its
manual pipe region, ``:27-29``): each replica of the data axes (``dp``,
``sharding``, ``fsdp``) takes its contiguous share of the batch rows, and
the ranks of the tensor axis (``mp`` / ``tensor`` / ``model``) of a stage
take the same rows and compute on slices of its Layers. Every group of
those axes is made up front, in the mesh's order (``_Link``). After the
schedule, gradients replicated across tensor but partial on each rank
(uncut K / V under cut heads, the norms under sequence parallelism) are
summed over the tensor group, and the stage gradients and the loss are
averaged over the data group, one ``fused_allreduce`` each.
``activation_spec`` (``P("dp", "mp")``, the reference's ``:502-510``)
cuts the activations between stages on the dim it puts on the tensor axis
(the sequence): where a stage's Layers give the whole activation the
runtime sends this rank's part (``scatter_seq``, whose backward gathers
the cotangent) and the receiver gathers it (``gather_seq``); where they
give this rank's part already (a Llama with ``sequence_parallel``) it
goes as it is. Stage 0 tells which at the first tick.

Beside a context-parallel axis (``sep`` / ``cp`` across processes) each
rank of it takes its positions of every row (dim 1 of the ids and the
labels, ``_rows``) and a stage sends them to the same ``sep`` coordinate
of the next stage (the pipe group holds the ranks of one coordinate);
the stages' decoder layers run the ring or Ulysses over the axis (the
mesh must be the current one, as ``fleet.init`` makes it). The loss is
each rank's mean over its positions, so the axis averages the loss and
the gradients with the data axes: the global token mean where every rank
counts its positions alike.

:class:`PipelineParallel` takes the reference's arguments, checks and
messages; a rank keeps only its own stages' parameters and optimizer state
on its device (the other stages' Layers are moved to the CPU). On a mesh
with a tensor, sharding or fsdp axis it places its stages by their
parameters' specs (the reference stacks them ``P(pp, None, *spec)``,
``:644-651``) through ``distributed._sharded.plan_specs``: tensor-cut
Layers compute on their slices with the collectives of
``distributed.tensor_parallel`` (the last stage's head keeps its
vocabulary columns when the loss is ``ParallelCrossEntropy``, whose
per-token losses over them are averaged; any other loss gets the logits
gathered), fsdp-cut weights stay at rest and are gathered where their
block runs, and beside a ``sharding`` axis the optimizer state lives on a
slice of it (fleet's ``sharding_configs["stage"]``, 1 or 2; 3 cuts the
rest of the weights at rest). ``train_batch`` takes one optimizer step
through the fused update (``optimizer.fused_step``; on such a mesh the
sharded update, ``_sharded.ShardedUpdate``) over the stage's trainable
tensors, as the reference's ``opt_cls.update`` leaf by leaf: frozen
parameters are masked out, no ``grad_clip`` is read (the reference's
``train_batch`` reads none), the step count and learning rate as at
``:768-773``. ``sync_to_model`` broadcasts each stage's trained tensors,
whole over tensor and fsdp, over the pipe group into the Layers of every
rank that does not run it; :func:`gather_pipeline_tree` reassembles a
tree of per-rank leaves into the reference's global layout.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ... import tracing
from .. import collective as C
from .. import env as _env
from ._pipe_p2p import StageLink
from .sequence_parallel import deferred_hooks

__all__ = ["PipelineSchedule", "build_pipeline_schedule", "verify_schedule", "schedule_cost",
           "make_pipeline_step", "PipelineParallel", "gather_pipeline_tree"]

_IDLE, _FWD, _BWD, _WGT = 0, 1, 2, 3


class PipelineSchedule(NamedTuple):
    """Static schedule tables: at tick t, stage p performs ``action[t, p]``
    (0 idle / 1 forward / 2 backward / 3 weight-grad) on microbatch
    ``mb[t, p]`` of model chunk ``chunk[t, p]``. ``ring`` is the most
    microbatches in flight on any (stage, chunk): the activation stash (F
    to B, F to W under zero-bubble)."""

    action: np.ndarray      # [T, P] int32
    mb: np.ndarray          # [T, P] int32
    chunk: np.ndarray       # [T, P] int32
    ring: int
    num_chunks: int
    style: str


def _stage_events(style: str, Pn: int, M: int, V: int, p: int):
    """Stage ``p``'s event order, ``[(kind, chunk, microbatch)]``."""
    if style in ("1f1b",):
        warm = min(Pn - 1 - p, M)
        ev = [("F", 0, m) for m in range(warm)]
        nf, nb = warm, 0
        while nb < M:
            if nf < M:
                ev.append(("F", 0, nf))
                nf += 1
            ev.append(("B", 0, nb))
            nb += 1
    elif style in ("fthenb", "gpipe"):
        ev = ([("F", 0, m) for m in range(M)] +
              [("B", 0, m) for m in range(M)])
    elif style in ("vpp", "interleaved"):
        # interleaved 1F1B over V chunks: virtual stage v * Pn + p holds
        # chunk v on stage p; microbatches in groups of Pn per chunk
        total = M * V
        warm = min((Pn - p - 1) * 2 + (V - 1) * Pn, total)

        def fpos(k):
            return ((k % (Pn * V)) // Pn,
                    (k // (Pn * V)) * Pn + k % Pn)

        def bpos(k):
            return (V - 1 - (k % (Pn * V)) // Pn,
                    (k // (Pn * V)) * Pn + k % Pn)

        ev = [("F",) + fpos(k) for k in range(warm)]
        nf, nb = warm, 0
        while nb < total:
            if nf < total:
                ev.append(("F",) + fpos(nf))
                nf += 1
            ev.append(("B",) + bpos(nb))
            nb += 1
    elif style in ("zero_bubble", "zb", "zbh1", "zbh2"):
        # one more warm-up forward than 1F1B; W passes deferred while the
        # F -> W window allows (H2: P - 1 wider)
        warm = min(Pn - p, M)
        win = warm + (Pn - 1 if style == "zbh2" else 0)
        ev = [("F", 0, m) for m in range(warm)]
        nf, nb, nw = warm, 0, 0
        pend = []
        while nb < M:
            ev.append(("B", 0, nb))
            pend.append(nb)
            nb += 1
            if nf < M:
                ev.append(("F", 0, nf))
                nf += 1
            while pend and nf - nw > win:
                ev.append(("W", 0, pend.pop(0)))
                nw += 1
        for m in pend:
            ev.append(("W", 0, m))
    else:
        raise ValueError(f"unknown pipeline schedule {style!r}")
    return ev


def build_pipeline_schedule(num_stages: int, num_microbatches: int, style: str = "1f1b",
                            num_chunks: int = 1) -> PipelineSchedule:
    """The static schedule table of ``style`` (see the module docstring)."""
    Pn, M, V = num_stages, num_microbatches, num_chunks
    if style in ("vpp", "interleaved"):
        if V < 2:
            raise ValueError("vpp needs num_chunks >= 2")
        if M % Pn != 0:
            raise ValueError(
                f"vpp needs num_microbatches ({M}) divisible by "
                f"num_stages ({Pn})")
    else:
        if V != 1:
            raise ValueError(f"style {style!r} does not use model chunks")
    S = Pn * V
    events = [_stage_events(style, Pn, M, V, p) for p in range(Pn)]
    ring = 1
    for p in range(Pn):
        live = {v: 0 for v in range(V)}
        has_w = any(k == "W" for k, _v, _m in events[p])
        for kind, v, _m in events[p]:
            if kind == "F":
                live[v] += 1
            elif kind == ("W" if has_w else "B"):
                live[v] -= 1
            ring = max(ring, live[v])

    # greedy timing over virtual stages s = v * Pn + p: F(s, m) after
    # F(s - 1, m), B(s, m) after B(s + 1, m) (the last after its own F),
    # W(s, m) after B(s, m); a stage whose next F / B is not ready fires a
    # pending W instead
    done_f: dict = {}
    done_b: dict = {}
    rows_a, rows_m, rows_c = [], [], []
    evq = [list(e) for e in events]
    t = 0
    while any(evq):
        act_row, mb_row, c_row = [_IDLE] * Pn, [0] * Pn, [0] * Pn
        fired = []
        for p in range(Pn):
            if not evq[p]:
                continue
            idx = None
            kind, v, m = evq[p][0]
            s = v * Pn + p
            if kind == "F":
                ok = s == 0 or done_f.get((s - 1, m), t) < t
            elif kind == "B":
                ok = (done_b.get((s + 1, m), t) < t) if s < S - 1 \
                    else (done_f.get((s, m), t) < t)
            else:
                ok = done_b.get((s, m), t) < t
            if ok:
                idx = 0
            else:
                for i, (k2, v2, m2) in enumerate(evq[p]):
                    if k2 == "W" and done_b.get((v2 * Pn + p, m2), t) < t:
                        idx = i
                        break
            if idx is not None:
                kind, v, m = evq[p][idx]
                act_row[p] = {"F": _FWD, "B": _BWD, "W": _WGT}[kind]
                mb_row[p] = m
                c_row[p] = v
                fired.append((p, idx, kind, v, m))
        for p, idx, kind, v, m in fired:
            if kind == "F":
                done_f[(v * Pn + p, m)] = t
            elif kind == "B":
                done_b[(v * Pn + p, m)] = t
            del evq[p][idx]
        rows_a.append(act_row)
        rows_m.append(mb_row)
        rows_c.append(c_row)
        t += 1
        assert t < 8 * V * (M + Pn) + 8, "schedule simulation did not converge"

    return PipelineSchedule(np.asarray(rows_a, np.int32),
                            np.asarray(rows_m, np.int32),
                            np.asarray(rows_c, np.int32),
                            int(ring), V, style)


def verify_schedule(sched: PipelineSchedule, num_microbatches: int) -> None:
    """Replay the table; ``AssertionError`` on a missing pass or a broken
    dependency."""
    T, Pn = sched.action.shape
    V, M, S = sched.num_chunks, num_microbatches, sched.num_chunks * Pn
    done_f, done_b, done_w = {}, {}, {}
    split = bool((sched.action == _WGT).any())
    for t in range(T):
        for p in range(Pn):
            a = int(sched.action[t, p])
            m = int(sched.mb[t, p])
            s = int(sched.chunk[t, p]) * Pn + p
            if a == _FWD:
                assert (s, m) not in done_f, f"duplicate F({s},{m})"
                if s > 0:
                    assert done_f.get((s - 1, m), T) < t, \
                        f"F({s},{m}) before input"
                done_f[(s, m)] = t
            elif a == _BWD:
                assert (s, m) not in done_b, f"duplicate B({s},{m})"
                assert done_f.get((s, m), T) < t, f"B({s},{m}) before F"
                if s < S - 1:
                    assert done_b.get((s + 1, m), T) < t, \
                        f"B({s},{m}) before cotangent"
                done_b[(s, m)] = t
            elif a == _WGT:
                assert (s, m) not in done_w, f"duplicate W({s},{m})"
                assert done_b.get((s, m), T) < t, f"W({s},{m}) before B"
                done_w[(s, m)] = t
    assert len(done_f) == S * M, "missing forwards"
    assert len(done_b) == S * M, "missing backwards"
    if split:
        assert len(done_w) == S * M, "missing weight-grad passes"


def schedule_cost(sched: PipelineSchedule) -> float:
    """Lockstep time model: each tick costs its most expensive action (a
    forward chunk 1 / V, a combined backward 2 / V, a split B or W 1 / V);
    the busy work is the same in every style, so a lower cost is a smaller
    bubble."""
    V = sched.num_chunks
    split = bool((sched.action == _WGT).any())
    per = {_IDLE: 0.0, _FWD: 1.0 / V,
           _BWD: (1.0 if split else 2.0) / V, _WGT: 1.0 / V}
    return float(sum(max(per[int(a)] for a in row) for row in sched.action))


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


def _loss_seed(num_microbatches: int) -> float:
    """The cotangent of each microbatch's loss (the reference's ``1/M``)."""
    return 1.0 / num_microbatches


def _graph_of(v: int, m: int) -> int:
    """The microbatch whose kept graph the cotangent of microbatch ``m`` of
    chunk ``v`` is taken through (itself)."""
    return m


class _Link:
    """A mesh's pipe group for this rank: the transport and the stage; the
    tensor axis beside it (its name and group: this stage's ranks that
    compute on slices of its Layers); the data axes (every other axis above
    1: ``dp``, ``sharding``, ``fsdp``), their group and this rank's part of
    the batch; and the device. Every group of the mesh's axes beside the
    pipe is made here, up front, in the mesh's order on every rank: a
    stage's placement asks for them in the order of its own parameters."""

    def __init__(self, mesh, axis_name: str, num_stages: int):
        if axis_name not in mesh.dim_names:
            raise ValueError(f"{mesh} has no axis {axis_name!r}")
        if num_stages != mesh.get_dim_size(axis_name):
            raise ValueError(f"num_stages={num_stages}: the port runs one process a stage, so "
                             f"it must be the size of the mesh's {axis_name!r} axis "
                             f"({mesh.get_dim_size(axis_name)})")
        from ..mesh import CONTEXT_AXES, TENSOR_AXES

        others = [n for n, s in zip(mesh.dim_names, mesh.shape) if n != axis_name and s > 1]
        tensor = [n for n in others if n in TENSOR_AXES]
        if len(tensor) > 1:
            raise ValueError(f"{mesh} has two tensor axes above 1: {tensor}")
        self.tensor_axis = tensor[0] if tensor else None
        self.context_axes = tuple(n for n in others if n in CONTEXT_AXES)
        self.data_axes = tuple(n for n in others if n != self.tensor_axis
                               and n not in self.context_axes)
        self.device = _env.device()
        group = mesh.get_group(axis_name)
        for k in range(len(others) + 1):
            for axes in itertools.combinations(others, k):
                mesh.get_group(axes)
        self.p2p = StageLink(group, mesh.axis_ranks(axis_name), self.device)
        self.stage = self.p2p.stage
        self.tensor_group = mesh.get_group(self.tensor_axis) if self.tensor_axis else None
        # the loss and the gradients are averaged over the data and context axes
        self.mean_axes = tuple(n for n in others if n in self.data_axes + self.context_axes)
        self.data_group = mesh.get_group(self.mean_axes) if self.mean_axes else None
        coords = mesh.coordinate()
        self.data_index, self.data_size = 0, 1
        for n in self.data_axes:
            self.data_index = self.data_index * mesh.get_dim_size(n) + coords[n]
            self.data_size *= mesh.get_dim_size(n)
        self.seq_index, self.seq_size = 0, 1
        for n in self.context_axes:
            self.seq_index = self.seq_index * mesh.get_dim_size(n) + coords[n]
            self.seq_size *= mesh.get_dim_size(n)
        self.seq_dim = None     # the activations' dim that activation_spec cuts over tensor

    def cut_by(self, activation_spec) -> None:
        """Read ``activation_spec`` (one entry a dim of the activations
        between stages): the dim it puts on a tensor axis is cut over this
        mesh's tensor axis; its data entries are the rows the data axes
        already split."""
        from ..mesh import TENSOR_AXES

        if activation_spec is None or self.tensor_group is None:
            return
        for d, entry in enumerate(tuple(activation_spec)):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if any(a in TENSOR_AXES for a in axes if a is not None):
                self.seq_dim = d
                return


def _rows(x, link: _Link, num_microbatches: int, device):
    """This data replica's rows of ``x`` on ``device`` (beside a context
    axis, this rank's positions of them: dim 1), cut into
    ``num_microbatches`` contiguous microbatches ``[M, rows / M, ...]``."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if link.data_size > 1:
        if x.shape[0] % link.data_size:
            raise ValueError(f"a batch of {x.shape[0]} rows over {link.data_size} data replicas")
        n = x.shape[0] // link.data_size
        x = x[link.data_index * n:(link.data_index + 1) * n]
    if link.seq_size > 1:
        if x.dim() < 2 or x.shape[1] % link.seq_size:
            raise ValueError(f"a batch of shape {tuple(x.shape)}: its positions (dim 1) over "
                             f"{link.seq_size} context ranks must divide")
        n = x.shape[1] // link.seq_size
        x = x[:, link.seq_index * n:(link.seq_index + 1) * n]
    if x.shape[0] % num_microbatches:
        raise ValueError(f"a batch of {x.shape[0]} rows into {num_microbatches} microbatches")
    x = x.to(device)
    return x.reshape((num_microbatches, x.shape[0] // num_microbatches) + tuple(x.shape[1:]))


def _run_schedule(sched: PipelineSchedule, link: _Link, M: int, forward: Callable,
                  params_of: Callable, meta: dict, key, full_len: int | None) -> tuple:
    """Walk this rank's column of ``sched``. ``forward(v, m, x)`` -> (the
    chunk's output, None) or, on the last virtual stage, (None, f32 loss);
    ``params_of(v)``: the tensors chunk v's backward accumulates ``.grad``
    into. ``meta[key]`` caches the activations' (shape, dtype, cut), which
    stage 0 gives the pipe group at the first tick; ``cut`` says whether
    the runtime cuts them on ``link.seq_dim`` over the tensor axis (a whole
    activation, of ``full_len`` there, the microbatch's) or the stages'
    Layers already give this rank's part. Returns (the last stage's loss
    sum / M, else None; the most microbatches in flight on a chunk)."""
    from ..tensor_parallel import gather_seq, scatter_seq

    P, V, p = link.p2p.num_stages, sched.num_chunks, link.stage
    split = bool((sched.action == _WGT).any())
    recv_act, recv_grad, stash = {}, {}, {}
    live = [0] * V
    peak = 0
    loss_sum = None
    dev, d = link.device, link.seq_dim
    tell = key not in meta and P > 1     # the same on every rank: the same batches so far
    for t in range(sched.action.shape[0]):
        a, m, v = (int(sched.action[t, p]), int(sched.mb[t, p]), int(sched.chunk[t, p]))
        is_first, is_last = p == 0 and v == 0, p == P - 1 and v == V - 1
        send_act = send_grad = None
        if a == _FWD:
            x = None if is_first else recv_act.pop((v, m)).requires_grad_(True)
            with tracing.traced():
                h = x if x is None or not meta[key][2] else gather_seq(x, link.tensor_group, d)
                out, loss = forward(v, m, h)
                if not is_last:
                    if key not in meta:
                        meta[key] = _layout(out, d, link, full_len)
                    if meta[key][2]:
                        out = scatter_seq(out, link.tensor_group, d)
            if is_last:
                stash[(v, m)] = [x, loss, None]
                loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            else:
                stash[(v, m)] = [x, out, None]
                send_act = out.detach().to(meta[key][1])
            live[v] += 1
            peak = max(peak, live[v])
        elif a == _BWD:
            g = _graph_of(v, m)
            if is_last:
                cot = torch.full((), _loss_seed(M), dtype=torch.float32, device=dev)
            else:
                cot = recv_grad.pop((v, m))
            x, target, _ = stash[(v, g)]
            if split:
                stash[(v, g)][2] = cot
                if x is not None:
                    (send_grad,) = torch.autograd.grad(target, x, cot, retain_graph=True)
            else:
                del stash[(v, g)]
                live[v] -= 1
                inputs = params_of(v) + ([x] if x is not None else [])
                if inputs and target.requires_grad:
                    torch.autograd.backward(target, cot, inputs=inputs)
                if x is not None:
                    send_grad = x.grad
                del x, target
        elif a == _WGT:
            x, target, cot = stash.pop((v, m))
            live[v] -= 1
            inputs = params_of(v)
            if inputs and target.requires_grad:
                torch.autograd.backward(target, cot, inputs=inputs)
            del x, target, cot
        if t == 0 and tell:
            box = [meta.get(key)]
            C.broadcast_object_list(box, src=link.p2p.ranks[0], group=link.p2p.group)
            meta[key] = box[0]
        _exchange(sched, link, t, send_act, send_grad, recv_act, recv_grad, meta.get(key))
    if stash or recv_act or recv_grad:
        raise AssertionError(f"the schedule ended with graphs {sorted(stash)}, activations "
                             f"{sorted(recv_act)} and cotangents {sorted(recv_grad)} left")
    return (None if loss_sum is None else loss_sum / M), peak


def _layout(out, d, link: _Link, full_len) -> tuple:
    """(shape, dtype, cut) of the activations between stages, from stage
    0's first output (see :func:`_run_schedule`)."""
    if d is None:
        return tuple(out.shape), out.dtype, False
    n, k = out.shape[d], link.tensor_group.nranks
    if n == full_len:
        if n % k:
            raise ValueError(f"activation_spec cuts dim {d} of size {n} over {k} tensor ranks: "
                             "they must divide")
        shape = list(out.shape)
        shape[d] //= k
        return tuple(shape), out.dtype, True
    if n * k == full_len:
        return tuple(out.shape), out.dtype, False
    raise ValueError(f"activation_spec cuts dim {d} of the activations {tuple(out.shape)}: it "
                     f"is neither the microbatch's {full_len} nor this rank's part of it")


def _exchange(sched, link, t, send_act, send_grad, recv_act, recv_grad, meta) -> None:
    """Tick ``t``'s transfers for this rank, from the table alone (the
    reference's ``:519-544``): what it sends, and what its neighbours' row
    says they sent it, kept in the reference's slots."""
    P, V, p = link.p2p.num_stages, sched.num_chunks, link.stage
    sends = []
    if send_act is not None:
        sends.append(((p + 1) % P, send_act))
    if send_grad is not None:
        sends.append(((p - 1) % P, send_grad))
    left, right = (p - 1) % P, (p + 1) % P
    recvs, slots = [], []
    l_a, l_m, l_c = (int(sched.action[t, left]), int(sched.mb[t, left]),
                     int(sched.chunk[t, left]))
    if l_a == _FWD and not (left == P - 1 and l_c == V - 1):
        recvs.append((left, meta[0], meta[1]))
        slots.append((recv_act, (l_c + (1 if p == 0 else 0), l_m)))
    r_a, r_m, r_c = (int(sched.action[t, right]), int(sched.mb[t, right]),
                     int(sched.chunk[t, right]))
    if r_a == _BWD and not (right == 0 and r_c == 0):
        recvs.append((right, meta[0], meta[1]))
        slots.append((recv_grad, (r_c - (1 if p == P - 1 else 0), r_m)))
    if not sends and not recvs:
        return
    for (store, slot), got in zip(slots, link.p2p.exchange(sends, recvs)):
        store[slot] = got


def _finish(link: _Link, loss, grads: list, partial=(), done=()) -> tuple:
    """The loss on every rank of the pipe group (from the last stage); the
    gradients at the indices ``partial`` (replicated across the tensor
    axis, each rank's partial) summed over the tensor group; and with a
    data group the loss and the gradients not at the indices ``done``
    (reduced already, by the gathers of parameters kept at rest) averaged
    over it, one ``fused_allreduce`` a group (a two-byte float in f32
    over gloo)."""
    from .._sharded import _reduce_dtype

    buf = (loss.reshape(1).clone() if loss is not None
           else torch.zeros(1, dtype=torch.float32, device=link.device))
    link.p2p.broadcast([buf], link.p2p.num_stages - 1)
    grads = list(grads)

    def reduce(idx, group, op):
        if not idx:
            return
        got = C.fused_allreduce([grads[i].to(_reduce_dtype(grads[i].dtype, group))
                                 for i in idx], op=op, group=group)
        for i, g in zip(idx, got):
            grads[i] = g.to(grads[i].dtype)

    if link.tensor_group is not None:
        reduce(sorted(partial), link.tensor_group, C.ReduceOp.SUM)
    if link.data_group is not None:
        idx = [i for i in range(len(grads)) if i not in set(done)]
        grads.append(buf)
        reduce(idx + [len(grads) - 1], link.data_group, C.ReduceOp.AVG)
        buf = grads.pop()
    return buf.reshape(()), grads


def make_pipeline_step(first_fn, chunk_fn, last_fn, *, mesh, num_stages: int,
                       num_microbatches: int, axis_name: str = "pp", schedule: str = "1f1b",
                       activation_spec=None, num_chunks: int = 1):
    """``step(params, ids, labels) -> (loss, grads)`` over this rank's stage.

    ``first_fn(w_first, ids_mb) -> h`` on the first virtual stage,
    ``chunk_fn(w_chunk, h) -> h`` (``w_chunk`` a tree of ``[Lc, ...]``
    leaves: one chunk's layers), ``last_fn(w_last, h, labels_mb) -> loss``
    on the last. ``params`` is this rank's tree: ``first`` (on stage 0,
    else empty), ``stack`` with the local stage dim ``[1, Lc, ...]``
    (``[1, V, Lc, ...]`` when ``num_chunks=V > 1``) and ``last`` (on the
    last stage). ``ids`` and ``labels`` are the whole batch on every rank;
    the ranks of a tensor axis take the same rows (the functions place
    their own tensor collectives), and ``activation_spec`` cuts the
    activations between stages over it. Returns the loss on every rank and
    the gradients of this rank's tree, in its shape, each carrying the
    layout (``dist_shard``) of the leaf it is taken for
    (:func:`gather_pipeline_tree` reassembles the reference's global
    one)."""
    from .. import _sharded

    sched = build_pipeline_schedule(num_stages, num_microbatches, schedule, num_chunks)
    link = _Link(mesh, axis_name, num_stages)
    link.cut_by(activation_spec)
    V, M = num_chunks, num_microbatches
    meta: dict = {}

    def leaf(t):
        t = torch.as_tensor(t)
        return t.detach().requires_grad_(True) if t.is_floating_point() else t.detach()

    def step(params, ids, labels):
        w_first = {k: leaf(t) for k, t in (params.get("first") or {}).items()}
        w_last = {k: leaf(t) for k, t in (params.get("last") or {}).items()}
        stack = params.get("stack") or {}
        w_chunks = [{k: leaf(t[0] if V == 1 else t[0][v]) for k, t in stack.items()}
                    for v in range(V)]
        x_mb = _rows(ids, link, M, link.device)
        y_mb = _rows(labels, link, M, link.device)
        P, p = num_stages, link.stage

        def forward(v, m, x):
            h = first_fn(w_first, x_mb[m]) if (p == 0 and v == 0) else x
            h = chunk_fn(w_chunks[v], h)
            if p == P - 1 and v == V - 1:
                return None, last_fn(w_last, h, y_mb[m]).float()
            return h, None

        def params_of(v):
            ws = list(w_chunks[v].values())
            if p == 0 and v == 0:
                ws += list(w_first.values())
            if p == P - 1 and v == V - 1:
                ws += list(w_last.values())
            return [w for w in ws if w.requires_grad]

        full = None if link.seq_dim is None else x_mb.shape[1 + link.seq_dim]
        with deferred_hooks():
            loss, _ = _run_schedule(sched, link, M, forward, params_of, meta,
                                    tuple(x_mb.shape), full)
        gf = {k: _grad(w) for k, w in w_first.items()}
        gl = {k: _grad(w) for k, w in w_last.items()}
        gc = [{k: _grad(w) for k, w in c.items()} for c in w_chunks]
        flat = list(gf.values()) + [g for c in gc for g in c.values()] + list(gl.values())
        loss, flat = _finish(link, loss, flat)
        it = iter(flat)
        gf = {k: next(it) for k in gf}
        gc = [{k: next(it) for k in c} for c in gc]
        gl = {k: next(it) for k in gl}
        gs = {k: (gc[0][k] if V == 1 else torch.stack([c[k] for c in gc]))[None]
              for k in stack}
        out = {"first": gf, "stack": gs, "last": gl}
        for part, tree in out.items():
            for k, g in tree.items():
                info = _sharded.info_of((params.get(part) or {})[k])
                if info is not None:
                    _sharded.register(g, info)
        return loss, out

    step.schedule = sched
    step.link = link
    return step


def _grad(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


class PipelineParallel:
    """Model-level pipeline trainer over one process a stage.

    first:   Layer mapping token ids -> hidden (e.g. Embedding). Stage 0.
    layers:  uniform list of Layers (decoder blocks); virtual stage
             ``s = v * P + p`` (chunk v of stage p) holds layers
             ``[s * Lc, (s + 1) * Lc)``.
    last:    Layer mapping hidden -> output (e.g. norm + head). Last stage.
    loss_fn: (output, labels) -> scalar loss, run with ``last``; or
             ``ParallelCrossEntropy``, whose per-token losses over the
             head's vocabulary columns are averaged over the tokens that
             are not ``ignore_index``.

    Every rank builds the same Layers; this rank's stages are moved to its
    device and the rest to the CPU, and on a mesh with a tensor, sharding
    or fsdp axis this rank's stages are placed by their parameters' specs
    (``param_spec(p)``, default the marks ``shard_axes`` through
    :func:`~paddle_tpu_torch.distributed.parallelize.param_spec`; see the
    module docstring)."""

    def __init__(self, first, layers: Sequence, last, loss_fn: Callable, *,
                 mesh, num_stages: int | None = None, num_microbatches: int = 1,
                 schedule: str = "1f1b", axis_name: str = "pp", remat: bool = False,
                 activation_spec=None, num_chunks: int = 1, param_spec: Callable | None = None):
        from .mp_layers import ParallelCrossEntropy

        self.first, self.layers, self.last = first, list(layers), last
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis_name = axis_name
        self.num_stages = num_stages or mesh.get_dim_size(axis_name)
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.remat = remat
        if schedule in ("vpp", "interleaved"):
            if num_chunks < 2:
                raise ValueError("schedule='vpp' requires num_chunks >= 2")
        elif num_chunks != 1:
            raise ValueError(
                f"schedule={schedule!r} does not use model chunks; "
                "pass schedule='vpp' for interleaved chunking")
        self.num_chunks = num_chunks
        self.activation_spec = activation_spec
        Pn, V, L = self.num_stages, self.num_chunks, len(self.layers)
        assert L % (Pn * V) == 0, \
            f"{L} layers not divisible by {Pn} stages x {V} chunks"
        self._sched = build_pipeline_schedule(Pn, num_microbatches, schedule, num_chunks)
        self.link = _Link(mesh, axis_name, Pn)
        self.link.cut_by(activation_spec)
        self.stage = p = self.link.stage
        Lc = L // (Pn * V)
        self._lc = Lc
        self.chunks = [self.layers[(v * Pn + p) * Lc:(v * Pn + p + 1) * Lc] for v in range(V)]
        mine = {id(m) for c in self.chunks for m in c}
        dev, cpu = self.link.device, torch.device("cpu")
        for layer in self.layers:
            layer.to(dev if id(layer) in mine else cpu)
        first.to(dev if p == 0 else cpu)
        last.to(dev if p == Pn - 1 else cpu)
        self._keys = [k for k, _ in self.layers[0].named_parameters()]
        self._meta: dict = {}
        self._opt_cls = None
        self._opt_state = None
        self._layout = (None, None)
        self.peak_in_flight = 0
        self._pce = isinstance(loss_fn, ParallelCrossEntropy)
        self._update = None
        self._partial, self._done = set(), set()
        if self.link.tensor_axis is not None or {"sharding", "fsdp"} & set(self.link.data_axes):
            self._place(param_spec)

    # ---- this rank's placement ----
    def _pieces(self) -> list:
        p, P = self.stage, self.num_stages
        return (([self.first] if p == 0 else []) + [m for c in self.chunks for m in c]
                + ([self.last] if p == P - 1 else []))

    def _place(self, param_spec) -> None:
        """Cut this rank's stages by their parameters' specs over the tensor
        axis (resident: the Layers compute on their slices through the
        tensor collectives, the last stage's head keeping its columns for
        ``ParallelCrossEntropy``) and the fsdp / sharding axes (kept at
        rest and gathered where their block runs), and keep the optimizer
        state on a slice of the sharding axis at fleet's sharding stage 1
        or 2 (``distributed._sharded.plan_specs``). The pipe axis neither
        cuts nor reduces them."""
        from .. import _sharded
        from .. import tensor_parallel as TP
        from ..parallelize import param_spec as marks_spec, stage3_specs
        from ..partitioning.rules import PartitionSpec
        from . import fleet as _fleet

        mesh, link = self.mesh, self.link
        spec_of = param_spec or (lambda q: marks_spec(q, mesh))
        pieces = self._pieces()
        params = [q for piece in pieces for q in piece.parameters()]
        specs = {}
        for q in params:
            specs[id(q)] = PartitionSpec(*[None if e in (self.axis_name,) or (
                isinstance(e, tuple) and self.axis_name in e) else e for e in spec_of(q)])
        stage = _fleet._sharding_stage() if _fleet._mesh is mesh else 1
        if stage == 3:
            stage3_specs(params, specs, mesh)
        partial = set()
        if link.tensor_group is not None:
            for piece in pieces:
                partial |= TP.install(piece, link.tensor_group, specs, link.tensor_axis,
                                      gather_output=not (self._pce and piece is self.last))
        partial |= {id(q) for q in params if getattr(q, "sequence_parallel", False)}
        self._update = _sharded.plan_specs(pieces, mesh, specs, link.mean_axes,
                                           link.tensor_axis or "", stage=stage,
                                           partial=partial)
        self._partial = partial
        self._done = {id(q) for q in params if (_sharded.info_of(q) is not None and
                                                _sharded.info_of(q).at_rest and
                                                _sharded.info_of(q).dim is not None)}

    # ---- this rank's tensors ----
    def _owned(self) -> list:
        """[(tree, key, parameter)] of this rank's stages: ``first`` on
        stage 0, each chunk's layers, ``last`` on the last stage."""
        out = []
        if self.stage == 0:
            out += [("first", k, q) for k, q in self.first.named_parameters()]
        for v, chunk in enumerate(self.chunks):
            for j, layer in enumerate(chunk):
                out += [("stack", (k, v, j), q) for k, q in layer.named_parameters()]
        if self.stage == self.num_stages - 1:
            out += [("last", k, q) for k, q in self.last.named_parameters()]
        return out

    def _params_of(self, v: int) -> list:
        ws = [q for layer in self.chunks[v] for q in layer.parameters()]
        if self.stage == 0 and v == 0:
            ws += list(self.first.parameters())
        if self.stage == self.num_stages - 1 and v == self.num_chunks - 1:
            ws += list(self.last.parameters())
        return [q for q in ws if q.requires_grad]

    def _tree(self, values: dict) -> dict:
        """``{(tree, key): tensor}`` of :meth:`_owned` -> the reference's
        tree of this rank: first, stack ``[1, Lc, ...]`` (``[1, V, Lc,
        ...]``), last; a leaf carries its parameter's layout."""
        from .. import _sharded

        tree = {"first": {}, "stack": {}, "last": {}}
        for (part, key), t in values.items():
            if part != "stack":
                tree[part][key] = t
        for k in self._keys:
            per = [torch.stack([values[("stack", (k, v, j))] for j in range(self._lc)])
                   for v in range(self.num_chunks)]
            tree["stack"][k] = (per[0] if self.num_chunks == 1 else torch.stack(per))[None]
            info = _sharded.info_of(values[("stack", (k, 0, 0))])
            if info is not None:
                _sharded.register(tree["stack"][k], info)
        return tree

    # ---- the schedule ----
    def _loss(self, out, labels):
        if not self._pce:
            return self.loss_fn(out, labels)
        ignore = self.loss_fn.ignore_index
        flat = labels.reshape(-1)
        if self.link.tensor_group is not None:
            from ..tensor_parallel import parallel_cross_entropy

            per = parallel_cross_entropy(out.reshape(-1, out.shape[-1]), flat,
                                         self.link.tensor_group, ignore)
        else:
            per = self.loss_fn(out.reshape(-1, out.shape[-1]), flat)
        return per.sum() / torch.clamp_min((flat != ignore).sum(), 1)

    def _forward_backward(self, ids, labels, reduce: bool = True) -> tuple:
        """(loss on every rank, [(tree, key, parameter, gradient)] of this
        rank): each gradient summed over the tensor axis where partial and
        averaged over the data group (``reduce``), or this rank's own (for
        the sharded update, which reduces them)."""
        from .. import _sharded

        link, M, V = self.link, self.num_microbatches, self.num_chunks
        P, p = self.num_stages, self.stage
        owned = self._owned()
        for _, _, q in owned:
            q.grad = None
        x_mb = _rows(ids, link, M, link.device) if p == 0 else None
        y_mb = _rows(labels, link, M, link.device) if p == P - 1 else None
        key = tuple(np.shape(ids))
        full = None if link.seq_dim is None or x_mb is None else x_mb.shape[1 + link.seq_dim]
        from ..recompute import recompute

        def forward(v, m, x):
            h = self.first(x_mb[m]) if (p == 0 and v == 0) else x
            for layer in self.chunks[v]:
                h = recompute(layer, h) if self.remat else layer(h)
            if p == P - 1 and v == V - 1:
                return None, self._loss(self.last(h), y_mb[m]).float()
            return h, None

        with deferred_hooks():
            loss, peak = _run_schedule(self._sched, link, M, forward, self._params_of,
                                       self._meta, key, full)
        self.peak_in_flight = peak
        grads = [_grad(q) for _, _, q in owned]
        for _, _, q in owned:
            q.grad = None
        if reduce:
            done = [i for i, (_, _, q) in enumerate(owned) if id(q) in self._done]
            partial = [i for i, (_, _, q) in enumerate(owned)
                       if id(q) in self._partial and i not in done]
            loss, grads = _finish(link, loss, grads, partial, done)
        else:
            loss, _ = _finish(link, loss, [])
        for (_, _, q), g in zip(owned, grads):
            info = _sharded.info_of(q)
            if info is not None:
                _sharded.register(g, info)
        return loss, [(part, key, q, g) for (part, key, q), g in zip(owned, grads)]

    def forward_backward_pipeline(self, ids, labels):
        """(loss, this rank's gradients as the reference's tree) of one
        pass of the schedule (``:723``)."""
        loss, got = self._forward_backward(ids, labels)
        return loss, self._tree({(part, key): g for part, key, _, g in got})

    def train_batch(self, data, optimizer, scaler=None):
        """One optimizer step over a global batch (``:727-774``); ``scaler``
        is taken and never read, as in the reference."""
        from ...ops import fused_optimizer
        from ...optimizer import fused_step

        ids, labels = data
        opt_cls = type(optimizer)
        if self._opt_cls is None:
            self._opt_cls = opt_cls
        elif opt_cls is not self._opt_cls:
            raise TypeError(
                f"train_batch was compiled for {self._opt_cls.__name__}; "
                f"got {opt_cls.__name__} — create a new PipelineParallel to "
                "switch optimizers")
        optimizer._step_count += 1
        lr = optimizer.get_lr()
        t = optimizer._step_count
        hyper = optimizer._hyper()
        if self._update is not None:
            loss, got = self._forward_backward(ids, labels, reduce=False)
            train = [(q, g.to(q.dtype)) for _, _, q, g in got if q.requires_grad]
            n = len(train)
            self._update.step(opt_cls, [q for q, _ in train], [g for _, g in train], [lr] * n,
                              [hyper] * n, [False] * n, None, t)
            return loss.detach()
        if self._opt_state is None:
            self._opt_state = {id(q): opt_cls.init_state(q.detach())
                               for _, _, q in self._owned() if q.requires_grad}
        loss, got = self._forward_backward(ids, labels)
        entries = [fused_optimizer.Entry(q.detach(), g.to(q.dtype), self._opt_state[id(q)],
                                         lr, hyper, None)
                   for _, _, q, g in got if q.requires_grad]
        if entries:
            sig = tuple(map(fused_optimizer.signature, entries))
            if self._layout[0] != sig:
                self._layout = (sig, fused_step.layout_of(opt_cls, entries))
            with torch.no_grad():
                fused_step.apply_update(opt_cls, entries, t, self._layout[1])
        return loss.detach()

    def _stage_params(self, q: int) -> list:
        P, V, Lc = self.num_stages, self.num_chunks, self._lc
        ts = list(self.first.parameters()) if q == 0 else []
        for v in range(V):
            for layer in self.layers[(v * P + q) * Lc:(v * P + q + 1) * Lc]:
                ts += list(layer.parameters())
        if q == P - 1:
            ts += list(self.last.parameters())
        return ts

    def sync_to_model(self):
        """Write every stage's parameters, whole (gathered over its tensor
        and fsdp axes), into the Layers of every rank of the pipe group
        that does not run that stage (``:776-790``); a rank's own stages
        keep their slices, which its Layers compute on."""
        from .. import _sharded

        for q in range(self.num_stages):
            ts = self._stage_params(q)
            if q == self.stage:
                ts = [_sharded.gather_full(t) for t in ts]
            self.link.p2p.broadcast(ts, q)


def _whole(t, stacked: bool):
    """Leaf ``t`` whole over its stage's tensor and fsdp axes (its layout
    ``dist_shard``); a ``stack`` leaf layer by layer."""
    from .. import _sharded

    info = _sharded.info_of(t)
    if info is None or not info.sliced:
        return t
    if not stacked:
        return _sharded.gather_full(t, info)
    lead = t.ndim - len(info.full_shape)
    flat = t.reshape((-1,) + tuple(t.shape[lead:]))
    whole = torch.stack([_sharded.gather_full(x, info) for x in flat])
    return whole.reshape(tuple(t.shape[:lead]) + tuple(whole.shape[1:]))


def gather_pipeline_tree(tree: dict, pipeline) -> dict:
    """Every rank's tree of ``first`` / ``stack`` / ``last`` leaves (as
    ``forward_backward_pipeline`` returns) reassembled on every rank of the
    pipe group into the reference's global layout: each leaf whole over its
    stage's tensor and fsdp axes, ``first`` from stage 0, ``last`` from the
    last stage, ``stack`` the stages' ``[1, ...]`` leaves in stage order,
    ``[P, Lc, ...]`` (``[P, V, Lc, ...]`` under vpp). ``pipeline`` is a
    :class:`PipelineParallel` or a step of :func:`make_pipeline_step`."""
    link = pipeline.link.p2p
    tree = {part: {k: _whole(t, part == "stack") for k, t in tree[part].items()}
            for part in ("first", "stack", "last")}
    mine = {part: [(k, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                   for k, t in tree[part].items()] for part in ("first", "stack", "last")}
    every = []
    C.all_gather_object(every, mine, group=link.group)
    by_stage = [every[link.group.ranks.index(r)] for r in link.ranks]
    out = {"first": {}, "stack": {}, "last": {}}
    stacks = {}
    for q, meta in enumerate(by_stage):
        ts = []
        for part in ("first", "stack", "last"):
            for k, shape, dtype in meta[part]:
                if q == link.stage:
                    t = tree[part][k].detach().clone()
                else:
                    t = torch.empty(shape, dtype=getattr(torch, dtype), device=link.device)
                ts.append(t)
                if part == "stack":
                    stacks.setdefault(k, []).append(t)
                else:
                    out[part][k] = t
        link.broadcast(ts, q)
    out["stack"] = {k: torch.cat(v) for k, v in stacks.items()}
    return out
