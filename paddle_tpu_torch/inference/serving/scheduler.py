"""Continuous-batching scheduler policy, host-side bookkeeping only
(counterpart of ``paddle_tpu/inference/serving/scheduler.py``).

- Admission order is ``(priority, deadline, submit order)``: lower
  priority classes first, earliest deadline first within a class,
  requests without a deadline after every deadlined peer, ties in submit
  order. With every request on the defaults this is plain FIFO.
- Head-of-line blocking: candidates are walked in that order and the walk
  STOPS at the first one that cannot be placed, so a large urgent request
  is never starved by a stream of small late ones.
- Lanes are scanned in index order everywhere, so a run is a function of
  the submit/step sequence alone.
"""

from __future__ import annotations

from collections import deque

from .request import PREFILLING, RUNNING, WAITING, Request

__all__ = ["Scheduler"]

_NO_DEADLINE = float("inf")


def _admission_key(req: Request):
    dl = req.deadline if req.deadline is not None else _NO_DEADLINE
    return (req.priority, dl, req.id)


class Scheduler:
    def __init__(self, num_lanes: int):
        self.num_lanes = int(num_lanes)
        self.waiting: deque = deque()
        #: lane index -> Request occupying it (None = free)
        self.lanes: list = [None] * self.num_lanes

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def drop_waiting(self, req: Request) -> bool:
        """Remove a still-queued request (cancellation before admission)."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def free_lanes(self) -> list:
        return [i for i, r in enumerate(self.lanes) if r is None]

    def occupied_lanes(self) -> list:
        return [i for i, r in enumerate(self.lanes) if r is not None]

    def running_lanes(self) -> list:
        return [i for i, r in enumerate(self.lanes)
                if r is not None and r.status == RUNNING]

    def prefilling_lanes(self) -> list:
        return [i for i, r in enumerate(self.lanes)
                if r is not None and r.status == PREFILLING]

    def pick_admissions(self, can_admit) -> list:
        """Pop admissible ``(request, lane)`` pairs in admission order;
        ``can_admit(req, lane)`` is the cache's full-reservation test.
        Each candidate takes the lowest free lane that can host it; the
        first candidate with none blocks the queue."""
        out = []
        self.waiting = deque(r for r in self.waiting if r.status == WAITING)
        free = self.free_lanes()
        for req in sorted(self.waiting, key=_admission_key):
            if not free:
                break
            lane = next((ln for ln in free if can_admit(req, ln)), None)
            if lane is None:
                break
            free.remove(lane)
            self.waiting.remove(req)
            self.lanes[lane] = req
            req.lane = lane
            out.append((req, lane))
        return out

    def release(self, lane: int) -> None:
        req = self.lanes[lane]
        self.lanes[lane] = None
        if req is not None:
            req.lane = None

    def pending(self) -> bool:
        """Work left? (anything queued or occupying a lane)"""
        return bool(self.waiting) or any(r is not None for r in self.lanes)
