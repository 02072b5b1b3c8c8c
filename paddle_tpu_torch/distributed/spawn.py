"""``paddle.distributed.spawn`` (counterpart of the reference's
``paddle_tpu/distributed/launch.py:24-50``): ``func(*args)`` in
``nprocs`` processes of this machine, each with Paddle's variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_LOCAL_SIZE``) and a file store in a fresh directory for
:func:`~paddle_tpu_torch.distributed.env.init_parallel_env`, so that no
port is fixed. The processes start with ``multiprocessing``'s "spawn":
``func`` must be importable by name.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import uuid

__all__ = ["spawn", "SpawnContext"]


def _rendezvous(directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    return "file://" + os.path.join(os.path.abspath(directory), f"rendezvous.{uuid.uuid4().hex}")


def _worker_env(rank, world, local_rank, local_size, init=None, master=None, devices=None):
    env = {"PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
           "PADDLE_LOCAL_RANK": str(local_rank), "PADDLE_LOCAL_SIZE": str(local_size)}
    if init:
        env["PADDLE_DIST_INIT"] = init
    if master:
        env["PADDLE_MASTER"] = master
    if devices:
        env["PADDLE_DEVICES"] = devices
    return env


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


class SpawnContext:
    """The processes of :func:`spawn`; :meth:`join` waits for them."""

    def __init__(self, processes, store_dir):
        self.processes = processes
        self._store_dir = store_dir

    def join(self, timeout=None) -> bool:
        """Wait for every process (at most ``timeout`` seconds). A process
        that exits with another code than 0, or the limit passing, stops
        the others and raises ``RuntimeError``; returns True."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in self.processes]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"spawn: rank {bad[0][0]} exited with code {bad[0][1]}")
                if all(c == 0 for c in codes):
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(f"spawn: the processes did not end within {timeout} s")
                time.sleep(0.05)
        finally:
            for p in self.processes:
                if p.exitcode is None:
                    p.kill()
                    p.join(10)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (-1: one a card),
    each with Paddle's variables and a file store for
    ``init_parallel_env``. ``options``: ``backend`` (PADDLE_DISTRI_BACKEND)
    and ``timeout`` (seconds :meth:`SpawnContext.join` waits).
    With ``join`` it waits and returns the :class:`SpawnContext`."""
    if nprocs is None or nprocs <= 0:
        import torch

        nprocs = torch.cuda.device_count()
        if nprocs == 0:
            raise ValueError("spawn: nprocs=-1 starts one process a card, and there is no "
                             "card; pass nprocs")
    store_dir = tempfile.mkdtemp(prefix="paddle_spawn_")
    init = _rendezvous(store_dir)
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = _worker_env(rank, nprocs, rank, nprocs, init=init)
        if options.get("backend"):
            env["PADDLE_DISTRI_BACKEND"] = options["backend"]
        p = ctx.Process(target=_spawn_entry, args=(func, tuple(args), env), daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, store_dir)
    if join:
        context.join(options.get("timeout"))
    return context
