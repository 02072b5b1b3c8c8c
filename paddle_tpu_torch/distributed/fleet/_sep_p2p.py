"""The context-parallel axis's transport between processes.

It stands for the reference's ``ppermute`` around the ``sep`` / ``cp``
axis (``paddle_tpu/ops/pallas/ring_flash.py:77-139``, the composed ring
``ring_attention.py:95-113``) and for the all-to-all that GSPMD lowers
Ulysses' sharding change to (``fleet/sequence_parallel.py:119-137``).
A :class:`SepLink` is this rank's place on the axis: its group, its
coordinate (``index``) and its neighbours on the ring.

- :meth:`SepLink.hop` posts one hop of the ring, one
  ``batch_isend_irecv`` over the group: each tensor goes to the next rank
  (``index + 1``) and a tensor of its shape comes from the previous one;
  :meth:`Hop.wait` waits for it and gives the received tensors. Posting
  before a step's compute and waiting after it lets NCCL overlap the
  transfer with the compute across cards.
- :meth:`SepLink.all_to_all` sends part ``j`` of a list to rank ``j`` and
  gives the part each rank sent here, in coordinate order.

On NCCL device tensors go directly. On gloo, which aborts on a CUDA
``send``, a hop's device tensor is staged through a pinned host buffer
(``collective.host_buffer``: copied out before the send, in after the
receive), which ``collective.stats()`` counts under ``sep_host_stage``
(calls and bytes), beside the ``send`` / ``recv`` of the host tensors; the
all-to-all is ``collective.all_to_all``, which stages as
``collective.all_to_all_single`` does (``host_stage``).
"""

from __future__ import annotations

import torch

from .. import collective as C

__all__ = ["SepLink", "Hop"]


class Hop:
    """One posted hop: :meth:`wait` returns the received tensors on the
    device of the tensors sent."""

    def __init__(self, tasks, bufs, device, staged):
        self.tasks, self.bufs, self.device, self.staged = tasks, bufs, device, staged

    def wait(self) -> list:
        for task in self.tasks:
            task.wait()
        if not self.staged:
            return self.bufs
        out = []
        for b in self.bufs:
            C._count("sep_host_stage", b)
            out.append(b.to(self.device))
        return out


class SepLink:
    """This rank's place on a context-parallel axis of ``group`` (a
    ``collective.Group`` whose ranks, in order, are the axis's coordinates)."""

    def __init__(self, group):
        self.group = group
        self.size = group.nranks
        self.index = group.rank
        self.next = group.ranks[(self.index + 1) % self.size]
        self.prev = group.ranks[(self.index - 1) % self.size]
        self._pinned: dict = {}

    def _staged(self, t) -> bool:
        return self.group.backend == "gloo" and t.device.type == "cuda"

    def hop(self, tensors, key: str = "", reverse: bool = False) -> Hop:
        """Post one hop of ``tensors`` around the ring (see the module
        docstring); ``reverse``: to the previous rank, from the next (the
        hop's transpose). ``key`` names the hop's staging buffers: hops in
        flight together take different keys."""
        dst, src = (self.prev, self.next) if reverse else (self.next, self.prev)
        tensors = [t.detach().contiguous() for t in tensors]
        staged = self._staged(tensors[0])
        ops, bufs = [], []
        for i, t in enumerate(tensors):
            if staged:
                host = C.host_buffer(self._pinned, (key, "s", i), t.shape, t.dtype)
                host.copy_(t)
                C._count("sep_host_stage", t)
                t = host
            buf = (C.host_buffer(self._pinned, (key, "r", i), t.shape, t.dtype) if staged
                   else torch.empty_like(t))
            ops.append(C.P2POp(C.isend, t, dst, self.group))
            ops.append(C.P2POp(C.irecv, buf, src, self.group))
            bufs.append(buf)
        return Hop(C.batch_isend_irecv(ops), bufs, tensors[0].device, staged)

    def all_to_all(self, parts) -> list:
        """``parts[j]`` to rank ``j`` of the axis; returns what each rank
        sent here, in order (a failed exchange raises)."""
        if len(parts) != self.size:
            raise ValueError(f"all_to_all over {self.size} ranks got {len(parts)} parts")
        got: list = []
        C.all_to_all(got, [p.contiguous() for p in parts], group=self.group)
        return got
