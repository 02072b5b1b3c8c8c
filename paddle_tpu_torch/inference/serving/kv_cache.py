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
        self.max_blocks_per_lane = int(max_blocks_per_lane)
        self.dtype = dtype
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        dev = resolve_device(device)
        self.pages_k = torch.zeros(shape, dtype=dtype, device=dev)
        self.pages_v = torch.zeros(shape, dtype=dtype, device=dev)
        self.block_table = np.zeros((num_lanes, max_blocks_per_lane), np.int32)
        self.lengths = np.zeros((num_lanes,), np.int32)
        self.active = np.zeros((num_lanes,), np.bool_)
        # LIFO free list; block 0 is never handed out
        self._free = list(range(num_blocks - 1, 0, -1))
        self._lane_blocks: list = [[] for _ in range(num_lanes)]
        # the slot state's static device buffers, refreshed by device_tables()
        self._staged = Staged(dev, block_table=self.block_table, lengths=self.lengths,
                              active=self.active)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def lane_capacity(self) -> int:
        """Max tokens a single lane can ever hold."""
        return self.max_blocks_per_lane * self.block_size

    def blocks_needed(self, total_tokens: int) -> int:
        return max(1, -(-int(total_tokens) // self.block_size))

    def can_admit(self, total_tokens: int) -> bool:
        """True when a request needing ``total_tokens`` slots can be fully
        reserved now."""
        n = self.blocks_needed(total_tokens)
        return n <= self.max_blocks_per_lane and n <= len(self._free)

    def allocate_lane(self, lane: int, total_tokens: int) -> None:
        """Reserve every block ``total_tokens`` can touch for ``lane``."""
        if self._lane_blocks[lane]:
            raise RuntimeError(f"lane {lane} already holds blocks")
        n = self.blocks_needed(total_tokens)
        if n > len(self._free) or n > self.max_blocks_per_lane:
            raise RuntimeError(
                f"cannot reserve {n} blocks for lane {lane} "
                f"(free={len(self._free)}, per-lane cap="
                f"{self.max_blocks_per_lane})")
        blocks = [self._free.pop() for _ in range(n)]
        self._lane_blocks[lane] = blocks
        self.block_table[lane] = 0
        self.block_table[lane, :n] = blocks
        self.lengths[lane] = 0
        self.active[lane] = False

    def free_lane(self, lane: int) -> None:
        """Return the lane's blocks to the pool (retire/evict/cancel)."""
        self._free.extend(self._lane_blocks[lane])
        self._lane_blocks[lane] = []
        self.block_table[lane] = 0
        self.lengths[lane] = 0
        self.active[lane] = False

    def lane_blocks(self, lane: int) -> list:
        return list(self._lane_blocks[lane])

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
