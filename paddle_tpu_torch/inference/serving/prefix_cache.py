"""Global prefix cache: content-hash dedup over the paged KV pool
(counterpart of ``paddle_tpu/inference/serving/prefix_cache.py``).

Requests that open with the same tokens (a shared system prompt, a
few-shot header) prefill them once: later requests splice the cached KV
blocks into their block table and prefill only the uncached tail. The
block tables are host state, so a hit is host bookkeeping and table
edits; the serving programs and their CUDA graphs do not change.

Keying. A prompt of length ``P`` maps to ``P // block_size`` chain keys:
key ``i`` is ``blake2b(key_{i-1} + tokens[i*bs:(i+1)*bs])`` over the
tokens' int32 bytes (8-byte digest, empty parent at the root), the
reference's bytes exactly. Two prompts share an entry exactly when their
first ``(i+1)*bs`` tokens agree. Entries keep their raw chunk and check
it on a match, so a digest collision is a miss, never wrong tokens.

What may be cached. Only prefill-written content: at retirement a lane
donates its first ``(P - 1) // bs`` blocks (position ``P - 1`` onward is
written by decode). A hit's length is rounded down until the uncached
tail starts on the cold run's prefill-chunk grid (or no tail remains),
so a hit's tail chunks have the cold run's boundaries and greedy tokens
are bit-identical cold, hot and after an evict-restore.

Copy-on-write fork. When the matched chain covers the block holding
position ``P - 1`` (a block-aligned full-prompt hit), the first decode
write would land in a shared, read-only block. The fork is eager, at
admission: a fresh block is popped inside the admission's reservation,
the engine copies the shared block into it on the device, and the lane's
table points at the private copy.

Eviction: LRU, then the host tier, then drop. Blocks held only by the
cache (lane count 0) stay on the device and count as admission capacity
(``evictable_hook``); under pool pressure ``reclaim_hook`` evicts them
leaf-first (an idle entry's descendants are idle too: a lane holding a
child holds every ancestor) in LRU order. With a host budget an evicted
block's content goes to host memory (bitwise exact) and a later hit
restores it into a fresh block; past the budget, or with no host tier,
the entry and its unreachable subtree are dropped.

Custody with :class:`~.kv_cache.PagedKVCache`: the allocator counts lane
holders only; the cache holds blocks through the three hooks it installs.
:meth:`PrefixCache.match` has no side effects (the scheduler's admission
probe calls it); :meth:`PrefixCache.take` pins the matched entries,
restores host-resident links, forks, and hands ``allocate_lane`` the
prefix rows and their ownership flags.

The reference's telemetry counters (``serve.prefix_inserts``,
``serve.prefix_restores``, ``serve.prefix_evictions{tier}`` and the
``serve.prefix_restore_us`` histogram) move in the registry; each cache
also keeps its own counts, in :meth:`PrefixCache.stats`.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import numpy as np

from ...profiler import telemetry as _telemetry

__all__ = ["PrefixCache", "PrefixPlan"]


def _chain_key(parent: bytes, chunk) -> bytes:
    h = hashlib.blake2b(parent, digest_size=8)
    h.update(np.asarray(chunk, np.int32).tobytes())
    return h.digest()


@dataclass
class _Entry:
    """One cached block: a (chain position, content) pair."""
    key: bytes
    parent: bytes | None          # the parent's chain key (None at the root)
    chunk: tuple                  # raw tokens, checked on a match
    shard: int
    block: int | None = None      # device block; None = on the host
    host: tuple | None = None     # (k, v) payload while offloaded
    children: set = field(default_factory=set)
    seq: int = 0                  # LRU stamp


@dataclass
class PrefixPlan:
    """A match, taken again at admission. ``credit`` is the table rows the
    hit covers without the free pool (device-resident matches, less a
    fork target, which needs a fresh block); ``idle`` is how many of those
    the cache counts as evictable, subtracted at admission so no block is
    counted twice."""
    entries: list
    tokens: int                   # prompt positions covered (n * bs)
    fork: bool                    # the last matched block needs a COW fork
    credit: int
    idle: int
    shard: int


class PrefixCache:
    """Content-hash prefix cache over one :class:`PagedKVCache` pool.

    The engine installs three device callbacks: ``copy(shard, src, dst)``
    (the fork), ``offload(shard, block) -> payload`` and
    ``restore(shard, payload, block)`` (the host tier; with ``offload``
    unset evictions drop)."""

    def __init__(self, kv, prefill_chunk: int, host_blocks: int = 0):
        self._kv = kv
        self._bs = int(kv.block_size)
        self._chunk = int(prefill_chunk)
        self.host_blocks = int(host_blocks)
        S = kv.num_shards
        self._entries = [dict() for _ in range(S)]   # key -> _Entry
        self._by_block = [dict() for _ in range(S)]  # block -> key
        self._idle = [set() for _ in range(S)]       # keys of idle device entries
        self._seq = 0
        self._host_used = 0
        self.copy = None
        self.offload = None
        self.restore = None
        kv.retain_hook = self.retain
        kv.evictable_hook = self.evictable
        kv.reclaim_hook = self.reclaim
        self._counts = dict(inserts=0, forks=0, restores=0, evictions_host=0,
                            evictions_drop=0)
        self._restore_s = 0.0
        self._c_inserts = _telemetry.counter("serve.prefix_inserts")
        self._c_restores = _telemetry.counter("serve.prefix_restores")
        self._c_evict_host = _telemetry.counter("serve.prefix_evictions", tier="host")
        self._c_evict_drop = _telemetry.counter("serve.prefix_evictions", tier="drop")
        self._h_restore_us = _telemetry.histogram("serve.prefix_restore_us")

    def _stamp(self) -> int:
        self._seq += 1
        return self._seq

    def stats(self) -> dict:
        return {
            "entries": sum(len(e) for e in self._entries),
            "device_blocks": sum(len(b) for b in self._by_block),
            "idle_blocks": sum(len(i) for i in self._idle),
            "host_blocks": self._host_used,
            **self._counts,
            "restore_ms": round(1e3 * self._restore_s, 3),
        }

    def cached_blocks(self, shard: int):
        """Device blocks in the cache's custody (the audit's hook)."""
        return set(self._by_block[shard])

    # -- PagedKVCache hooks ----------------------------------------------

    def retain(self, shard: int, block: int) -> bool:
        """A lane dropped ``block`` to count 0: keep it?"""
        key = self._by_block[shard].get(block)
        if key is None:
            return False
        e = self._entries[shard].get(key)
        if e is None or e.block != block:
            self._by_block[shard].pop(block, None)
            return False
        self._idle[shard].add(key)
        e.seq = self._stamp()
        return True

    def evictable(self, shard: int) -> int:
        return len(self._idle[shard])

    def reclaim(self, shard: int, n: int) -> None:
        """Evict up to ``n`` idle cached blocks back to the free list,
        leaf-first (no device-resident child) in LRU order."""
        for _ in range(int(n)):
            victim = None
            ent = self._entries[shard]
            for key in self._idle[shard]:
                e = ent[key]
                if any(c in ent and ent[c].block is not None for c in e.children):
                    continue
                if victim is None or e.seq < victim.seq:
                    victim = e
            if victim is None:
                return
            self._evict_one(shard, victim)

    # -- matching --------------------------------------------------------

    def match(self, prompt, total_tokens: int, shard: int):
        """The longest usable cached chain for ``prompt`` in ``shard``, as
        a :class:`PrefixPlan`, or None on a miss; no side effects."""
        P = len(prompt)
        if P < 2:
            return None
        limit = min(P // self._bs, self._kv.blocks_needed(total_tokens))
        ent = self._entries[shard]
        chain, key = [], b""
        for i in range(limit):
            chunk = tuple(prompt[i * self._bs:(i + 1) * self._bs])
            k = _chain_key(key, chunk)
            e = ent.get(k)
            if e is None or e.chunk != chunk:
                break
            chain.append(e)
            key = k
        n = len(chain)
        # round down until the uncached tail starts on the cold run's
        # prefill-chunk grid (or no tail prefill remains)
        while n and (n * self._bs) % self._chunk != 0 and n * self._bs < P - 1:
            n -= 1
        if not n:
            return None
        chain = chain[:n]
        fork = n > (P - 1) // self._bs
        dev = sum(1 for e in chain if e.block is not None)
        fork_dev = 1 if fork and chain[-1].block is not None else 0
        idle = sum(1 for e in chain if e.key in self._idle[shard])
        return PrefixPlan(entries=chain, tokens=n * self._bs, fork=fork,
                          credit=dev - fork_dev, idle=idle, shard=shard)

    def admissible(self, plan: PrefixPlan, total_tokens: int) -> bool:
        """Can a lane holding ``plan`` be fully reserved now? The matched
        idle blocks are pinned by :meth:`take`, so they leave the credit
        before the pool is asked."""
        return self._kv.can_admit(total_tokens, shard=plan.shard,
                                  shared=plan.credit - plan.idle)

    # -- the hit path ----------------------------------------------------

    def take(self, plan: PrefixPlan):
        """Make a matched chain one lane's: pin the entries, restore the
        host-resident ones, fork the COW target. Returns ``(prefix_blocks,
        owned_flags)`` for ``allocate_lane``: owned rows were popped here
        (count 1), shared rows get their count raised by the allocator."""
        kv, s = self._kv, plan.shard
        # pin first: a take_block below may reclaim, and must not evict a
        # block this plan is about to splice in
        for e in plan.entries:
            self._idle[s].discard(e.key)
            e.seq = self._stamp()
        prefix, owned = [], []
        last = len(plan.entries) - 1
        for i, e in enumerate(plan.entries):
            fork_this = plan.fork and i == last
            if e.block is not None:
                if fork_this:
                    nb = kv.take_block(s)
                    self.copy(s, e.block, nb)
                    self._counts["forks"] += 1
                    # the lane holds the private copy, not the entry's block
                    self._idle[s].add(e.key)
                    prefix.append(nb)
                    owned.append(True)
                else:
                    prefix.append(e.block)
                    owned.append(False)
            else:
                nb = kv.take_block(s)
                t0 = time.perf_counter()
                self.restore(s, e.host, nb)
                dt = time.perf_counter() - t0
                self._restore_s += dt
                self._h_restore_us.observe(dt * 1e6)
                self._counts["restores"] += 1
                self._c_restores.value += 1
                if fork_this:
                    self._counts["forks"] += 1
                else:
                    # the entry returns to the device tier; a fork target
                    # stays on the host (the private copy will diverge)
                    e.block = nb
                    e.host = None
                    self._host_used -= 1
                    self._by_block[s][nb] = e.key
                prefix.append(nb)
                owned.append(True)
        return prefix, owned

    # -- insert (retirement) ---------------------------------------------

    def insert(self, prompt, shard: int, blocks) -> None:
        """Donate a retiring lane's prefill-written blocks. Called before
        ``free_lane``: the blocks still carry the lane's count, so the
        cache retains them as the count drops."""
        P = len(prompt)
        ent = self._entries[shard]
        n_ins = min(max(P - 1, 0) // self._bs, len(blocks))
        key, parent = b"", None
        for i in range(n_ins):
            chunk = tuple(prompt[i * self._bs:(i + 1) * self._bs])
            k = _chain_key(key, chunk)
            e = ent.get(k)
            b = int(blocks[i])
            if e is None:
                e = _Entry(key=k, parent=key or None, chunk=chunk, shard=shard,
                           block=b, seq=self._stamp())
                ent[k] = e
                self._by_block[shard][b] = k
                if parent is not None:
                    parent.children.add(k)
                self._counts["inserts"] += 1
                self._c_inserts.value += 1
            elif e.chunk != chunk:
                break  # a digest collision: the incumbent stays
            elif e.block is None and b not in self._by_block[shard]:
                # the entry was on the host, and this lane just prefilled
                # the same bytes on the device: adopt its block
                e.block = b
                e.host = None
                self._host_used -= 1
                self._by_block[shard][b] = k
                e.seq = self._stamp()
            key, parent = k, e

    # -- eviction --------------------------------------------------------

    def _evict_one(self, shard: int, e: _Entry) -> None:
        """One idle device entry down the ladder: to the host tier when it
        fits, else dropped (with its unreachable subtree). Its block
        returns to the pool either way."""
        self._idle[shard].discard(e.key)
        b = e.block
        self._by_block[shard].pop(b, None)
        e.block = None
        if self.offload is not None and self.host_blocks > 0:
            if self._host_used >= self.host_blocks:
                self._evict_host_lru()
            if self._host_used < self.host_blocks:
                e.host = self.offload(shard, b)
                self._host_used += 1
                self._kv._free[shard].append(b)
                self._counts["evictions_host"] += 1
                self._c_evict_host.value += 1
                return
        self._drop(shard, e.key)
        self._kv._free[shard].append(b)
        self._counts["evictions_drop"] += 1
        self._c_evict_drop.value += 1

    def _evict_host_lru(self) -> None:
        """Free one host slot: the LRU host entry, childless preferred
        (dropping a mid-chain entry drops its unreachable subtree)."""
        best = best_any = None
        for s in range(self._kv.num_shards):
            ent = self._entries[s]
            for e in ent.values():
                if e.host is None:
                    continue
                if best_any is None or e.seq < best_any.seq:
                    best_any = e
                if not any(c in ent for c in e.children):
                    if best is None or e.seq < best.seq:
                        best = e
        victim = best or best_any
        if victim is not None:
            self._drop(victim.shard, victim.key)

    def _drop(self, shard: int, key: bytes) -> None:
        """Forget an entry and its subtree. Device blocks held only by the
        cache go back to the pool; blocks a lane still holds are only
        unmapped (the lane's last ``free_lane`` frees them)."""
        e = self._entries[shard].pop(key, None)
        if e is None:
            return
        for c in list(e.children):
            self._drop(shard, c)
        if e.parent is not None:
            p = self._entries[shard].get(e.parent)
            if p is not None:
                p.children.discard(key)
        self._idle[shard].discard(key)
        if e.block is not None:
            self._by_block[shard].pop(e.block, None)
            if self._kv.refcount(shard, e.block) == 0:
                self._kv._free[shard].append(e.block)
            e.block = None
        if e.host is not None:
            e.host = None
            self._host_used -= 1

    def invalidate(self, plan: PrefixPlan) -> None:
        """Drop a matched chain wholesale (lanes already holding its
        blocks keep them)."""
        if plan.entries:
            self._drop(plan.shard, plan.entries[0].key)
