"""The distributed environment (counterpart of
``paddle_tpu/distributed/env.py:19-130``).

One process a device, as Paddle runs: :func:`init_parallel_env` joins this
process to the default process group of ``torch.distributed``. What it
reads, in Paddle's variables (the launcher,
:mod:`paddle_tpu_torch.distributed.launch`, sets them):

- ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``: this process's rank and
  the world size (else torch's ``RANK`` / ``WORLD_SIZE``; without either, a
  world of one);
- ``PADDLE_LOCAL_RANK`` (else ``LOCAL_RANK``, else the rank): which card,
  ``cuda:(local_rank % cards)``, or the ``local_rank``-th of
  ``PADDLE_DEVICES`` (the launcher's ``--devices``);
- the rendezvous: ``PADDLE_DIST_INIT`` (the launcher's file store), else
  ``PADDLE_MASTER`` (``host:port``) or ``MASTER_ADDR`` + ``MASTER_PORT``
  (rank 0 hosts the TCP store there); a world of one needs none;
- the backend: ``backend=``, else ``PADDLE_DISTRI_BACKEND``, else NCCL
  when the port's device is the card and gloo when the caller has set the
  CPU (``paddle_tpu_torch.set_device("cpu")``);
- ``timeout=``: seconds any collective may wait (1800).

Nothing falls back: NCCL without a card raises, NCCL with more ranks on a
node (``PADDLE_LOCAL_SIZE``) than cards raises and names the card two
ranks would share, and a failed NCCL start is not retried on gloo. A
second call is a no-op, as in the reference.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "is_initialized",
           "ParallelEnv", "backend", "device"]

_state = {"initialized": False, "backend": None, "device": None, "local_rank": 0}


def _int_env(*names, default=None):
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return default


def _cards() -> list:
    """The cards this node's ranks take, in local-rank order."""
    listed = os.environ.get("PADDLE_DEVICES", "")
    if listed:
        return [int(d) for d in listed.split(",") if d != ""]
    return list(range(torch.cuda.device_count()))


def _pick_device(backend_name: str, local_rank: int) -> torch.device:
    from .. import device as _device

    if _device.get_device() == "cpu":
        if backend_name == "nccl":
            raise RuntimeError("init_parallel_env: NCCL needs the card, but the port's "
                               "device is the CPU (set_device('cpu')); use gloo")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("init_parallel_env: the port runs on the card by default and no "
                           "CUDA device is available; call paddle_tpu_torch.set_device('cpu') "
                           "for a CPU world over gloo")
    cards = _cards()
    if not cards:
        raise RuntimeError("init_parallel_env: PADDLE_DEVICES names no card")
    card = cards[local_rank % len(cards)]
    local_size = _int_env("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE")
    if backend_name == "nccl" and local_size is not None and local_size > len(cards):
        sharing = [r for r in range(local_size) if cards[r % len(cards)] == card]
        raise RuntimeError(
            f"init_parallel_env: {local_size} ranks on this node but {len(cards)} card(s): "
            f"NCCL refuses two ranks on one device, and local ranks {sharing} would share "
            f"cuda:{card}; run at most one rank a card, or name gloo "
            "(PADDLE_DISTRI_BACKEND=gloo)")
    torch.cuda.set_device(card)
    _device.set_device(f"gpu:{card}")
    return torch.device("cuda", card)


def init_parallel_env(backend: str | None = None, timeout: float | None = None):
    """Join the default process group (see the module docstring); returns
    :class:`ParallelEnv`."""
    if _state["initialized"]:
        return ParallelEnv()
    rank = _int_env("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _int_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local_rank = _int_env("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=rank)
    from .. import device as _device

    name = (backend or os.environ.get("PADDLE_DISTRI_BACKEND")
            or ("gloo" if _device.get_device() == "cpu" else "nccl")).lower()
    if name not in ("nccl", "gloo"):
        raise ValueError(f"init_parallel_env: backend {name!r} is not 'nccl' or 'gloo'")
    dev = _pick_device(name, local_rank)
    kwargs = dict(backend=name, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=1800 if timeout is None else timeout))
    init = os.environ.get("PADDLE_DIST_INIT")
    master = os.environ.get("PADDLE_MASTER")
    if not master and os.environ.get("MASTER_ADDR"):
        master = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '8476')}"
    if init:
        kwargs["init_method"] = init
    elif master:
        kwargs["init_method"] = f"tcp://{master}"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise RuntimeError(
            f"init_parallel_env: a world of {world} needs a rendezvous: run under "
            "python -m paddle_tpu_torch.distributed.launch, or set PADDLE_MASTER=host:port")
    dist.init_process_group(**kwargs)
    _state.update(initialized=True, backend=name, device=dev, local_rank=local_rank)
    return ParallelEnv()


def is_initialized() -> bool:
    return _state["initialized"]


def backend() -> str | None:
    """The default group's backend ("nccl" or "gloo"), None before
    :func:`init_parallel_env`."""
    return _state["backend"]


def device() -> torch.device:
    """This rank's device: its card, or the CPU in a gloo world on the
    CPU; before :func:`init_parallel_env`, the port's default device."""
    if _state["device"] is not None:
        return _state["device"]
    from .. import device as _device

    return _device.default_device()


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (-1 outside it), else in the world
    (``PADDLE_TRAINER_ID`` before :func:`init_parallel_env`)."""
    if group is not None:
        return group.rank
    if _state["initialized"]:
        return dist.get_rank()
    return _int_env("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if _state["initialized"]:
        return dist.get_world_size()
    return _int_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: this process's place in the
    world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        if _state["initialized"]:
            return _state["local_rank"]
        return _int_env("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=get_rank())

    @property
    def device_id(self):
        dev = device()
        return 0 if dev.type == "cpu" else dev.index
