"""The multi-process launcher (counterpart of
``paddle_tpu/distributed/launch.py:24-372``).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
[--nnodes M --rank R --master host:port] [--devices 0,1] [--log_dir DIR]
script.py args`` starts N processes of ``script.py`` on this node, one a
card, each with Paddle's variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``,
``PADDLE_DEVICES``) and a rendezvous for
:func:`~paddle_tpu_torch.distributed.env.init_parallel_env`:

- on one node, a file store in a fresh directory (under ``--log_dir`` when
  given), so no port is fixed and launches side by side never collide;
- across nodes, ``--master host:port`` (rank 0's worker hosts the TCP
  store there), given to every node.

A worker's output goes to ``DIR/workerlog.<rank>`` with ``--log_dir``. The
workers find the packages of the directory the launcher runs from
(``PYTHONPATH``). When a worker exits with another code than 0, the
launcher stops the others and exits with 1, printing the end of that
worker's log. ``--max_restart`` and ``--elastic_level`` (the reference's
restart and rescale) wait for the port's ``elastic`` module and raise.
A launcher that is itself stopped (SIGTERM) stops its workers first.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

from .spawn import _rendezvous, _worker_env

__all__ = ["launch"]

_ELASTIC = ("--max_restart and --elastic_level (restarting and rescaling a world) wait for "
            "the port's distributed.elastic module")


def _parse_args(argv):
    ap = argparse.ArgumentParser("python -m paddle_tpu_torch.distributed.launch")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--nproc_per_node", type=int, default=None,
                    help="processes on this node (default: one a card of --devices, or of "
                         "the node)")
    ap.add_argument("--master", type=str, default=None, help="host:port of rank 0's store")
    ap.add_argument("--rank", type=int, default=0, help="this node's rank")
    ap.add_argument("--devices", type=str, default=None,
                    help="the cards this node's ranks take, e.g. 0,1")
    ap.add_argument("--log_dir", type=str, default=None)
    ap.add_argument("--max_restart", type=int, default=0)
    ap.add_argument("--elastic_level", type=int, default=0)
    ap.add_argument("script", type=str)
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def _stop(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p, _ in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path, n=40) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def launch(argv=None) -> int:
    """The launcher's command line (see the module docstring); returns the
    exit code."""
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if args.max_restart or args.elastic_level:
        raise NotImplementedError(_ELASTIC)
    devices = args.devices
    nproc = args.nproc_per_node
    if nproc is None:
        if devices:
            nproc = len([d for d in devices.split(",") if d])
        else:
            import torch

            nproc = max(torch.cuda.device_count(), 1)
    world = args.nnodes * nproc
    master = init = None
    if args.nnodes > 1:
        if not args.master or ":" not in args.master:
            sys.stderr.write("launch: --nnodes > 1 needs --master host:port on every node\n")
            return 2
        master = args.master
    elif args.master:
        master = args.master
    else:
        init = _rendezvous(args.log_dir or tempfile.mkdtemp(prefix="paddle_launch_"))
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    path = os.pathsep.join([os.getcwd()] + ([os.environ["PYTHONPATH"]]
                                            if os.environ.get("PYTHONPATH") else []))
    procs = []
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        for local in range(nproc):
            rank = args.rank * nproc + local
            env = dict(os.environ, PYTHONPATH=path,
                       **_worker_env(rank, world, local, nproc, init, master, devices))
            log = None
            if args.log_dir:
                log = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            p = subprocess.Popen([sys.executable, "-u", args.script] + args.script_args,
                                 env=env, stdout=log, stderr=subprocess.STDOUT if log else None)
            procs.append((p, log))
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                i, code = failed[0]
                rank = args.rank * nproc + i
                sys.stderr.write(f"launch: rank {rank} exited with code {code}; stopping the "
                                 "other ranks\n")
                if args.log_dir:
                    sys.stderr.write(_tail(os.path.join(args.log_dir, f"workerlog.{rank}")))
                return 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(procs)
        for _, log in procs:
            if log is not None:
                log.close()


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
