"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers, the collate function and the ``DataLoader``.

The host pipeline stays numpy, as in the reference: a dataset returns
numpy arrays, and :func:`default_collate_fn` stacks them into CPU tensors
with the reference's dtypes. ``DataLoader(..., device="cuda")`` (the
default) yields batches on the card: a prefetch thread collates into
pinned host memory and copies each batch to the device on a side stream,
``max(2, prefetch_factor)`` batches ahead of the consumer, which waits on
the copy's event before it uses a batch. ``num_workers > 0`` loads and
collates in worker processes (``io/worker.py``) that never touch CUDA.
The consumer's wait for each batch is a ``dataload.fetch`` span; a wait
past a millisecond is booked as goodput ``stall`` (site ``dataload``).

The shuffling samplers draw from the ``generator`` they are given: a
``torch.Generator``, a numpy ``Generator`` or ``RandomState``, or None
for an unseeded numpy generator (the reference's only choice, whose order
cannot be reproduced).
"""

from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch
from torch.utils.data import Dataset

from ..device import resolve_device
from ..profiler import goodput as _goodput
from ..profiler import spans as _spans

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset", "ChainDataset",
           "Subset", "random_split", "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "DataLoader", "get_worker_info"]


class IterableDataset(Dataset):
    """A dataset read by iteration only."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Item ``i`` is ``tuple(t[i] for t in tensors)``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Item ``i`` joins item ``i`` of each dataset into one tuple; the
    length is the shortest."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    """The datasets' items one dataset after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _permutation(n: int, generator) -> np.ndarray:
    """A permutation of ``range(n)`` drawn from ``generator`` (see the
    module's docstring)."""
    if isinstance(generator, torch.Generator):
        return torch.randperm(n, generator=generator).numpy()
    rng = np.random.default_rng() if generator is None else generator
    return rng.permutation(n)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions of ``len(dataset)``, the
    last taking the rest) over one permutation drawn from ``generator``.
    The reference permutes with ``RandomState(its global seed)``; pass
    ``np.random.RandomState(seed)`` for its split at that seed."""
    if all(isinstance(length, float) for length in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * f)) for f in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    perm = _permutation(sum(lengths), generator)
    out, off = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[off:off + length].tolist()))
        off += length
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation of the data source (its first ``num_samples``), or
    ``num_samples`` indices drawn with replacement, from ``generator``."""

    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            if isinstance(self.generator, torch.Generator):
                idx = torch.randint(0, n, (self.num_samples,), generator=self.generator)
                return iter(idx.tolist())
            rng = np.random.default_rng() if self.generator is None else self.generator
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(_permutation(n, self.generator)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True, generator=None):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        if isinstance(self.generator, torch.Generator):
            return iter(torch.multinomial(torch.from_numpy(self.weights), self.num_samples,
                                          self.replacement, generator=self.generator).tolist())
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng() if self.generator is None else self.generator
        return iter(rng.choice(len(self.weights), self.num_samples, replace=self.replacement,
                               p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler`` (else a random or
    sequential sampler over ``dataset``); the last, shorter list is
    dropped with ``drop_last``."""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False, generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """The batches of rank ``rank`` of ``num_replicas``: indices padded to
    a multiple of the replicas by repeating the first, then every
    ``num_replicas``-th from ``rank``; shuffled with
    ``RandomState(epoch)`` (:meth:`set_epoch`). ``num_replicas`` and
    ``rank`` default to the world's size and this process's rank
    (``distributed.env``: ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``
    before the process group starts)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import env as _env

            num_replicas = _env.get_world_size() if num_replicas is None else num_replicas
            rank = _env.get_rank() if rank is None else rank
        self.nranks = max(num_replicas, 1)
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        batch = []
        for idx in indices[self.local_rank:self.total_size:self.nranks].tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# the reference's tensors hold no 64-bit types: its collate narrows them
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32, np.dtype(np.complex128): np.complex64}
_NARROW_TORCH = {torch.int64: torch.int32, torch.float64: torch.float32,
                 torch.complex128: torch.complex64}


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.astype(_NARROW.get(a.dtype, a.dtype),
                                                          copy=False)))


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors, recursively over tuples,
    lists and dicts, with the reference's dtypes: 64-bit integers and
    floats become 32-bit (MNIST's int64 labels collate to int32, Python
    floats to float32). Anything else stays a list."""
    sample = batch[0]
    if torch.is_tensor(sample):
        out = torch.stack([s.detach().cpu() for s in batch])
        return out.to(_NARROW_TORCH.get(out.dtype, out.dtype))
    if isinstance(sample, np.ndarray):
        return _host_tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.generic)):
        return _host_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _map_tensors(fn, obj):
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    return obj


def _tensors(obj) -> list:
    out = []
    _map_tensors(out.append, obj)
    return out


def _produce(raw, out: queue.Queue, stop: threading.Event, device, stream):
    """The prefetch thread: each host batch from ``raw`` goes to ``out`` as
    ``("data", batch, event)``, on the device when ``stream`` is given
    (pinned, copied on ``stream``, ``event`` recorded after the copy);
    then ``("end", None, None)``, or ``("error", exception, None)``."""
    def put(item):
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        if stream is not None:
            torch.cuda.set_device(device)
        for batch in raw:
            event = None
            if stream is not None:
                with torch.cuda.stream(stream):
                    batch = _map_tensors(
                        lambda t: t.pin_memory().to(device, non_blocking=True), batch)
                    event = torch.cuda.Event()
                    event.record(stream)
            if not put(("data", batch, event)):
                return
        put(("end", None, None))
    except Exception as e:  # handed to the consumer, which raises it
        put(("error", e, None))
    finally:
        close = getattr(raw, "close", None)
        if close is not None:
            close()


class _PrefetchIterator:
    """Batches of ``raw`` produced by a thread ``depth`` ahead of the
    consumer (≙ the reference's threaded loader with its device
    double-buffer). On the card the consumer's stream waits on each
    batch's copy event, and the batch's tensors are recorded as used by
    that stream, so the caching allocator keeps their memory until the
    consumer's work on them is done."""

    def __init__(self, raw, device: torch.device, depth: int):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._thread = threading.Thread(target=_produce, args=(raw, self._q, self._stop,
                                                                device, stream), daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._thread is None:
            raise StopIteration
        # the consumer's wait is the dataload.fetch span; a wait past 1 ms
        # is a stall (sub-ms pops are a warm buffer), booked as lost goodput
        with _spans.span("dataload.fetch") as sp:
            kind, val, event = self._q.get()
            waited_us = sp.elapsed_us()
        if waited_us > 1000:
            _goodput.note_loss("stall", waited_us, site="dataload")
        if kind == "end":
            self.close()
            raise StopIteration
        if kind == "error":
            self.close()
            raise val
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(val):
                t.record_stream(consumer)
        return val

    def close(self):
        """Stop the prefetch thread (and with it any worker processes)."""
        if getattr(self, "_thread", None) is None:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()
        self._thread = None

    def __del__(self):
        self.close()


class DataLoader:
    """``paddle.io.DataLoader``: batches of ``dataset`` by ``batch_sampler``
    (else a :class:`BatchSampler` of ``batch_size``, ``shuffle``,
    ``drop_last`` and ``generator``), collated by ``collate_fn`` and
    yielded on ``device`` (the card unless the caller asks for the CPU),
    prefetched by a thread. ``num_workers > 0`` loads a map-style
    dataset in that many worker processes (``io/worker.py``). The
    reference's ``places``, ``feed_list``, ``return_list``,
    ``use_buffer_reader``, ``use_shared_memory``, ``persistent_workers``
    and ``shm_capacity`` are taken and ignored; ``timeout`` bounds the wait
    for a worker's batch."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, shm_capacity=0, *, device="cuda", generator=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.drop_last = drop_last
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                                              drop_last=drop_last, generator=generator)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def _raw_iter(self):
        """Host batches in this process."""
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable_mode:
            from .worker import worker_batches

            # the workers are forked here, in the consumer's thread, before
            # this iterator's prefetch thread exists
            raw = worker_batches(self)
        else:
            raw = self._raw_iter()
        return _PrefetchIterator(raw, self.device, max(2, self.prefetch_factor))

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        raise TypeError("length of an IterableDataset DataLoader is undefined")


def get_worker_info():
    """In a worker process, its ``id``, ``num_workers`` and ``dataset``;
    None elsewhere."""
    from .worker import get_worker_info as _get

    return _get()
