"""Worker processes of the port's ``DataLoader`` (counterpart of
``paddle_tpu/io/worker.py``), carried by torch's own worker machinery.

Ordering contract, the reference's: batch i is loaded and collated by
worker ``i % num_workers`` and the parent takes the batches in order, so
the batch order equals the single-process loader's. Workers are forked,
as in the reference, and never touch CUDA: they index the dataset and run
the collate function on the host, their batches reach the parent through
shared memory, and the parent's prefetch thread copies them to the card.
A worker's exception is raised in the consumer. Each epoch seeds the
workers' numpy generators (torch seeds each worker from one base seed)
from one draw of numpy's global generator, so random transforms in the
workers repeat when the caller seeds ``np.random``.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import torch
from torch.utils.data import DataLoader as _TorchLoader
from torch.utils.data import get_worker_info as _torch_worker_info

__all__ = ["get_worker_info", "worker_batches"]


def get_worker_info():
    """In a worker process, its ``id``, ``num_workers``, ``seed`` and
    ``dataset``; None in the parent."""
    return _torch_worker_info()


class _Workers:
    """One epoch's host batches from the workers; ``close`` ends them."""

    def __init__(self, it):
        self._it = it

    def __iter__(self):
        return self._it

    def close(self):
        self._it._shutdown_workers()


def worker_batches(loader) -> _Workers:
    """Start ``loader.num_workers`` workers over this epoch's batches of
    ``loader.batch_sampler`` (forked now, in the caller's thread)."""
    base = torch.Generator()
    base.manual_seed(int(np.random.randint(0, 2**62, dtype=np.int64)))
    batches = list(loader.batch_sampler)
    torch_loader = _TorchLoader(
        loader.dataset, batch_sampler=batches, collate_fn=loader.collate_fn,
        num_workers=loader.num_workers, multiprocessing_context=multiprocessing.get_context("fork"),
        worker_init_fn=loader.worker_init_fn, prefetch_factor=max(2, loader.prefetch_factor),
        timeout=loader.timeout, generator=base)
    return _Workers(iter(torch_loader))
