"""Block-paged KV cache: one fixed page pool shared by every lane
(counterpart of ``paddle_tpu/inference/serving/kv_cache.py``, single
device).

All sequences share a pool of ``[L, num_blocks, block_size, Hk, hd]``
pages for K and one for V, on the device. Each lane owns an ordered list
of physical block ids, its row of the int32 block table ``[lanes, MB]``:
logical position ``p`` lives in page ``block_table[lane, p // bs]`` at
offset ``p % bs``. This module owns the host side: the free list, the
per-lane block lists and the numpy block table, lengths and active mask,
and the static device buffers those are copied into every step (a CUDA
graph of a serving program holds their addresses).

Physical block 0 is reserved as the trash block: inactive lanes still run
the fixed-shape scatter, and pointing them at block 0 makes their writes
harmless. It also backs unassigned table entries. A request is admitted
only when every block its prompt plus ``max_new_tokens`` can touch is
free, so decode never runs out of blocks mid-flight. Freed blocks return
LIFO, so lane tables fragment after a few evictions.

Refcounts and copy-on-write (the prefix cache's allocator): every block
carries a count of the LANES whose table holds it. A block held by more
than one lane is shared and read-only: the engine forks any shared block
a lane would write into (a device copy, then :meth:`swap_block`) before
the lane activates. The prefix cache holds blocks through three host
hooks: ``retain_hook(shard, block) -> bool`` keeps a block whose count
just reached 0 out of the free list (the cache keeps its content for
later hits), ``evictable_hook(shard) -> int`` counts the blocks the cache
would hand back under pressure (part of :meth:`can_admit`'s capacity),
and ``reclaim_hook(shard, n)`` evicts up to ``n`` of them when
:meth:`take_block` finds the free list empty. With no hook installed the
allocator behaves as without the cache (every count is 0 or 1).

The ``shard`` arguments keep the reference's signatures for a lane pool
split across devices; this port serves one shard (``num_shards`` is 1,
:meth:`shard_of` gives 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device

__all__ = ["PagedKVCache", "Staged"]


class PagedKVCache:
    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 num_blocks: int, block_size: int, num_lanes: int,
                 max_blocks_per_lane: int, dtype=torch.float32, device):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        if block_size < 1 or max_blocks_per_lane < 1 or num_lanes < 1:
            raise ValueError("block_size, max_blocks_per_lane and num_lanes "
                             "must be >= 1")
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_lanes = int(num_lanes)
        self.num_shards = 1
        self.max_blocks_per_lane = int(max_blocks_per_lane)
        self.dtype = dtype
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        dev = resolve_device(device)
        self.pages_k = torch.zeros(shape, dtype=dtype, device=dev)
        self.pages_v = torch.zeros(shape, dtype=dtype, device=dev)
        self.block_table = np.zeros((num_lanes, max_blocks_per_lane), np.int32)
        self.lengths = np.zeros((num_lanes,), np.int32)
        self.active = np.zeros((num_lanes,), np.bool_)
        # one LIFO free list a shard; block 0 is never handed out
        self._free = [list(range(num_blocks - 1, 0, -1))]
        self._lane_blocks: list = [[] for _ in range(num_lanes)]
        #: lanes holding each (shard, block); > 1 = shared and read-only
        self._ref = np.zeros((1, self.num_blocks), np.int32)
        # the prefix cache's hooks (module docstring); None = no cache
        self.retain_hook = None
        self.evictable_hook = None
        self.reclaim_hook = None
        # the slot state's static device buffers, refreshed by device_tables()
        self._staged = Staged(dev, block_table=self.block_table, lengths=self.lengths,
                              active=self.active)

    def shard_of(self, lane: int) -> int:
        return 0

    @property
    def free_blocks(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def blocks_in_use(self) -> int:
        """Blocks off the free lists (the trash block of each shard aside)."""
        return self.num_shards * (self.num_blocks - 1) - self.free_blocks

    @property
    def lane_capacity(self) -> int:
        """Max tokens a single lane can ever hold."""
        return self.max_blocks_per_lane * self.block_size

    def blocks_needed(self, total_tokens: int) -> int:
        return max(1, -(-int(total_tokens) // self.block_size))

    def _avail(self, shard: int) -> int:
        """Blocks obtainable in ``shard`` now: the free list and what the
        prefix cache would hand back under pressure."""
        n = len(self._free[shard])
        if self.evictable_hook is not None:
            n += int(self.evictable_hook(shard))
        return n

    def can_admit(self, total_tokens: int, shard: int | None = None,
                  shared: int = 0) -> bool:
        """True when a request needing ``total_tokens`` slots can be fully
        reserved now (in ``shard``, or in any shard). ``shared`` table
        slots a prefix-cache hit covers with resident blocks cost no fresh
        block, so a hit admits where a cold request of its length cannot."""
        n = self.blocks_needed(total_tokens)
        if n > self.max_blocks_per_lane:
            return False
        need = max(n - int(shared), 0)
        shards = range(self.num_shards) if shard is None else (shard,)
        return any(need <= self._avail(s) for s in shards)

    def refcount(self, shard: int, block: int) -> int:
        return int(self._ref[shard, block])

    @property
    def shared_blocks(self) -> int:
        """Blocks held by more than one lane."""
        return int((self._ref > 1).sum())

    def take_block(self, shard: int) -> int:
        """Pop one fresh block (count 1), reclaiming a cached block whose
        count is 0 when the free list is empty."""
        if not self._free[shard] and self.reclaim_hook is not None:
            self.reclaim_hook(shard, 1)
        if not self._free[shard]:
            raise RuntimeError(f"shard {shard} block pool exhausted")
        b = self._free[shard].pop()
        self._ref[shard, b] = 1
        return b

    def _release_block(self, shard: int, block: int) -> None:
        self._ref[shard, block] -= 1
        if self._ref[shard, block] <= 0:
            self._ref[shard, block] = 0
            if not (self.retain_hook is not None and self.retain_hook(shard, block)):
                self._free[shard].append(block)

    def allocate_lane(self, lane: int, total_tokens: int, prefix=(),
                      prefix_owned=()) -> None:
        """Reserve every block ``total_tokens`` can touch for ``lane``.
        ``prefix`` fills the first table slots with resident blocks (a
        prefix-cache hit): an entry whose ``prefix_owned`` flag is False is
        shared (its count goes up), a True one was already popped by the
        caller (a restored or forked block, count 1). Only the rest is
        drawn fresh."""
        if self._lane_blocks[lane]:
            raise RuntimeError(f"lane {lane} already holds blocks")
        s = self.shard_of(lane)
        n = self.blocks_needed(total_tokens)
        prefix = [int(b) for b in prefix]
        owned = list(prefix_owned) if prefix_owned else [False] * len(prefix)
        if len(prefix) > n:
            raise RuntimeError(f"prefix of {len(prefix)} blocks exceeds the "
                               f"{n}-block reservation for lane {lane}")
        if n - len(prefix) > self._avail(s) or n > self.max_blocks_per_lane:
            raise RuntimeError(
                f"cannot reserve {n} blocks ({sum(not o for o in owned)} shared) for "
                f"lane {lane} (free={len(self._free[s])}, per-lane cap="
                f"{self.max_blocks_per_lane})")
        for b, o in zip(prefix, owned):
            if not o:
                self._ref[s, b] += 1
        blocks = prefix + [self.take_block(s) for _ in range(n - len(prefix))]
        self._lane_blocks[lane] = blocks
        self.block_table[lane] = 0
        self.block_table[lane, :n] = blocks
        self.lengths[lane] = 0
        self.active[lane] = False

    def swap_block(self, lane: int, slot: int, new_block: int) -> int:
        """The copy-on-write table edit: ``lane``'s table slot ``slot``
        takes ``new_block`` (popped by :meth:`take_block`; the device copy
        is the engine's) and the old block loses this lane's count.
        Returns the old block."""
        old = self._lane_blocks[lane][slot]
        self._lane_blocks[lane][slot] = int(new_block)
        self.block_table[lane, slot] = int(new_block)
        self._release_block(self.shard_of(lane), old)
        return old

    def free_lane(self, lane: int) -> None:
        """Drop the lane's count on each of its blocks (retire, evict,
        cancel); a block whose count reaches 0 returns to the pool unless
        the prefix cache keeps it."""
        s = self.shard_of(lane)
        for b in self._lane_blocks[lane]:
            self._release_block(s, b)
        self._lane_blocks[lane] = []
        self.block_table[lane] = 0
        self.lengths[lane] = 0
        self.active[lane] = False

    def lane_blocks(self, lane: int) -> list:
        return list(self._lane_blocks[lane])

    def audit(self, cached_blocks=None) -> None:
        """Check the counts and custody (raises AssertionError): each
        block's count equals the lanes holding it, no free block is held,
        and every block neither free nor held is in the prefix cache's
        custody (``cached_blocks(shard) -> iterable``, where given)."""
        counts = np.zeros_like(self._ref)
        for lane, blocks in enumerate(self._lane_blocks):
            for b in blocks:
                counts[self.shard_of(lane), b] += 1
        if not (counts == self._ref).all():
            bad = np.argwhere(counts != self._ref)
            raise AssertionError(f"refcount drift at (shard, block) {bad}")
        for s in range(self.num_shards):
            free = set(self._free[s])
            if len(free) != len(self._free[s]):
                raise AssertionError(f"shard {s} free list holds dupes")
            held = {b for b in range(self.num_blocks) if counts[s, b]}
            if free & held:
                raise AssertionError(f"shard {s} blocks both free and held: {free & held}")
            cached = set(cached_blocks(s)) if cached_blocks else set()
            stranded = set(range(1, self.num_blocks)) - free - held - cached
            if stranded:
                raise AssertionError(f"shard {s} stranded blocks {sorted(stranded)}")

    def device_tables(self):
        """(block_table, lengths, active) on the pool's device, int32,
        int32 and bool: the slot-state inputs of the serving programs.
        The same static buffers every call, refreshed from the host arrays
        in stream order (through pinned snapshots on the card, so later
        host edits never reach a step in flight)."""
        self._staged.push()
        return self.tables

    @property
    def tables(self):
        """The static device buffers of :meth:`device_tables`, as its last
        call left them (no copy): what a serving program reads."""
        d = self._staged.dev
        return d["block_table"], d["lengths"], d["active"]


_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.bool_): torch.bool, np.dtype(np.float32): torch.float32}


class Staged:
    """Host numpy arrays and their static device buffers, allocated once:
    the inputs a CUDA graph of a serving program reads by address.
    :meth:`push` copies host arrays into their buffers, in stream order; on
    the card each goes through a pinned snapshot, and a push first waits
    for the copies of the push before, so it never writes a snapshot that
    a queued copy still reads. ``host[name]`` may be edited freely between
    pushes."""

    def __init__(self, device, **arrays):
        self.host = arrays
        self.dev = {n: torch.zeros(a.shape, dtype=_TORCH[a.dtype], device=device)
                    for n, a in arrays.items()}
        pin = device.type == "cuda"
        self._snap = {n: torch.empty(a.shape, dtype=_TORCH[a.dtype], pin_memory=pin)
                      for n, a in arrays.items()} if pin else None
        self._copied = torch.cuda.Event() if pin else None

    def push(self, *names):
        """Copy the named arrays (all by default) to their buffers."""
        if self._copied is not None:
            self._copied.synchronize()
        for n in names or tuple(self.host):
            if self._snap is None:
                self.dev[n].copy_(torch.from_numpy(self.host[n]))
            else:
                self._snap[n].numpy()[...] = self.host[n]
                self.dev[n].copy_(self._snap[n], non_blocking=True)
        if self._copied is not None:
            self._copied.record()
