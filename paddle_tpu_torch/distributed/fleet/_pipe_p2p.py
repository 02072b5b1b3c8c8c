"""The pipeline's transport between stages.

It stands for the reference's pair of ``ppermute`` calls a tick
and the slots they land in (``paddle_tpu/distributed/fleet/pipeline_parallel.py:519-544``:
every stage ships its tick's activation to the next stage and its
cotangent to the previous one, and keeps what its neighbours' row of the
table says was sent), and for the ``psum`` that carries the first and
last stages' results to the whole pipe axis (``:553-555``). Paddle's own
counterpart is ``pp_utils/p2p_communication.py``.

The port runs one process a stage, so it moves only what the table says
is sent: :meth:`StageLink.exchange` posts a tick's sends and receives
with ``batch_isend_irecv`` over the pipe group and waits for them. NCCL
matches the operations of one (source, destination) pair in the order
they are posted, with no tags, so both ends derive them from the one
table in one order (activations before cotangents); a stage sends at most
one tensor a tick, so a pair carries at most one a tick each way.

On NCCL device tensors go directly. On gloo a device tensor is staged
through a pinned host buffer (``collective.host_buffer``, reused tick
after tick: copied out before the send, in after the receive), which
``collective.stats()`` counts under ``pipe_host_stage`` (calls and
bytes), beside the ``send`` and ``recv`` of the host buffers;
the stages' compute stays on their devices. :meth:`StageLink.broadcast`
moves a list of tensors from one stage to the whole pipe group as one
buffer a dtype (``sync_to_model``, ``gather_pipeline_tree``, the loss).
"""

from __future__ import annotations

import torch

from .. import collective as C
from .. import env as _env

__all__ = ["StageLink"]


class StageLink:
    """The transport of one rank of a pipe group: ``group`` (a
    ``collective.Group``), ``stage_ranks`` the group's global ranks in stage
    order, ``device`` where the stages compute."""

    def __init__(self, group, stage_ranks, device):
        self.group = group
        self.ranks = [int(r) for r in stage_ranks]
        self.stage = self.ranks.index(_env.get_rank())
        self.num_stages = len(self.ranks)
        self.device = torch.device(device)
        self.staged = group.backend == "gloo" and self.device.type == "cuda"
        self._pinned: dict = {}

    def exchange(self, sends, recvs) -> list:
        """Post ``sends`` ([(stage, tensor)]) and ``recvs`` ([(stage, shape,
        dtype)]) at once and wait for them; returns the received tensors on
        this rank's device, in ``recvs``' order. A transfer to this rank's
        own stage (a pipe group of one) is a local move."""
        ops, got, local = [], [], []
        for i, (q, t) in enumerate(sends):
            if q == self.stage:
                local.append(t.detach())
                continue
            t = t.detach().contiguous()
            if self.staged:
                host = C.host_buffer(self._pinned, ("s", i), t.shape, t.dtype)
                host.copy_(t)
                C._count("pipe_host_stage", t)
                t = host
            ops.append(C.P2POp(C.isend, t, self.ranks[q], self.group))
        for i, (q, shape, dtype) in enumerate(recvs):
            if q == self.stage:
                got.append(local.pop(0))
                continue
            shape = torch.Size(shape)
            buf = (C.host_buffer(self._pinned, ("r", i), shape, dtype) if self.staged
                   else torch.empty(shape, dtype=dtype, device=self.device))
            ops.append(C.P2POp(C.irecv, buf, self.ranks[q], self.group))
            got.append(buf)
        for task in C.batch_isend_irecv(ops):
            task.wait()
        if self.staged:
            out = []
            for (q, _, _), t in zip(recvs, got):
                if q != self.stage:
                    C._count("pipe_host_stage", t)
                    t = t.to(self.device)
                out.append(t)
            got = out
        return got

    def broadcast(self, tensors, src_stage: int) -> None:
        """Copy stage ``src_stage``'s ``tensors`` into every stage's
        ``tensors`` (same shapes and dtypes, on any device), one buffer a
        dtype."""
        if self.num_stages == 1 or not tensors:
            return
        mine = self.stage == src_stage
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        where = torch.device("cpu") if self.staged or self.device.type == "cpu" else self.device
        for dtype in sorted(by_dtype, key=str):
            ts = by_dtype[dtype]
            if mine:
                buf = torch.cat([t.detach().reshape(-1).to(where) for t in ts])
                if self.staged:
                    C._count("pipe_host_stage", buf)
            else:
                buf = torch.empty(sum(t.numel() for t in ts), dtype=dtype, device=where)
            C.broadcast(buf, src=self.ranks[src_stage], group=self.group)
            if not mine:
                if self.staged:
                    C._count("pipe_host_stage", buf)
                off = 0
                with torch.no_grad():
                    for t in ts:
                        n = t.numel()
                        t.copy_(buf[off:off + n].view(t.shape))
                        off += n
