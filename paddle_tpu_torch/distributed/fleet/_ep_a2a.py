"""The expert axis's transport between processes, where a
Mixture-of-Experts layer's experts are cut over a data axis.

It stands for the all-to-all that GSPMD lowers the reference's dispatch
and combine einsums to when the expert weights are sharded over ``dp``
(``paddle_tpu/distributed/fleet/moe.py:296-298``, ``:333-337``). An
:class:`ExpertLink` is this rank's place on the axis: its group (the
experts' owners, rank ``j`` holding experts ``j E / n ..``) and where each
member stands in the layer's routing group (the data ranks in the global
batch's order).

- :meth:`ExpertLink.plan` gives, from the routing's :class:`GlobalView`,
  how many rows each member sends here and the global slot of each row:
  a member's kept choices of an expert hold consecutive slots (its first
  choices after the earlier ranks' first choices, its second choices after
  every first choice and the earlier ranks' second choices), and it sends
  them in expert order, first choices first, in token order. No count
  travels: every rank holds every rank's counts.
- :meth:`ExpertLink.exchange` is one ``all_to_all_single`` with uneven
  splits (a split may be 0) as an autograd function: its backward is the
  inverse exchange of the gradients. The combine is the same exchange with
  the splits swapped.

``collective.stats()`` counts each exchange under ``all_to_all_single``
(the rows given, all of them) and, on gloo, each host staging under
``host_stage``. The link counts the rows its forward exchanges gave
(:attr:`ExpertLink.rows`: a layer's forward and backward move twice as
many) and the kept choices of the routing group's global batch
(:attr:`ExpertLink.kept`), from which a check reckons the bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import collective as C

__all__ = ["ExpertLink"]


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, link, send, recv):
        ctx.link, ctx.send, ctx.recv = link, send, recv
        return link.all_to_all(rows, send, recv)

    @staticmethod
    def backward(ctx, g):
        return ctx.link.all_to_all(g, ctx.recv, ctx.send), None, None, None


class ExpertLink:
    """This rank's place on an expert axis of ``group`` (a
    ``collective.Group`` whose ranks, in order, own the experts in order)
    inside the routing group ``route`` (None: the group is the routing
    group)."""

    def __init__(self, group, route=None):
        self.group = group
        self.size = group.nranks
        self.index = group.rank
        ranks = route.ranks if route is not None else group.ranks
        self.route_index = [ranks.index(r) for r in group.ranks]
        self.rows = 0           # rows given to forward exchanges
        self.kept = 0           # kept choices of the global batches planned

    def plan(self, view, capacity: int, local_experts: int, device) -> tuple:
        """``(rows from each member, slots)``: the rows each member of the
        axis sends here under ``view`` (list), and the slot in this rank's
        ``[local_experts * capacity]`` buffers of every row received, in
        the order they arrive (int64 on ``device``)."""
        from .moe import kept_counts

        self.kept += sum(int(kept_counts(view, r, capacity)[0].sum())
                         for r in range(view.counts.shape[0]))
        e0 = self.index * local_experts
        recv, slots = [], []
        for r in self.route_index:
            kept, start = kept_counts(view, r, capacity)
            n = 0
            for e in range(e0, e0 + local_experts):
                for k in range(kept.shape[0]):
                    c = int(kept[k, e])
                    if c:
                        slots.append(np.arange(start[k, e], start[k, e] + c)
                                     + (e - e0) * capacity)
                        n += c
            recv.append(n)
        flat = np.concatenate(slots) if slots else np.zeros(0, np.int64)
        return recv, torch.from_numpy(flat.astype(np.int64)).to(device)

    def all_to_all(self, rows, send, recv):
        """``rows`` cut into ``send[j]`` rows for member ``j``; returns the
        ``recv[j]`` rows from each member, in member order (not
        differentiable)."""
        out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
        C.all_to_all_single(out, rows.contiguous(), out_split_sizes=list(recv),
                            in_split_sizes=list(send), group=self.group)
        return out

    def exchange(self, rows, send, recv):
        """:meth:`all_to_all` whose backward sends the gradients back."""
        self.rows += sum(send)
        return _Rows.apply(rows, self, send, recv)
