"""Continuous-batching serving engine over a block-paged KV cache
(counterpart of ``paddle_tpu/inference/serving/engine.py``, the flat
single-device engine).

Requests of different lengths share one fixed lane pool; the scheduler
admits and retires requests BETWEEN decode steps by rewriting host-side
slot state (block tables, lengths, active mask, next-token ids). Each
:meth:`ServingEngine.step`:

- admits waiting requests onto free lanes (full block reservation);
- prefills prompt chunks of ``prefill_chunk`` tokens, at most
  ``max_prefill_chunks_per_step`` of them, into the lanes' pages (cache
  fill only: the prompt's last token enters through the decode batch,
  which also yields the first generated token);
- runs one decode step for every lane through
  :func:`models.llama.decode_step` over a :class:`PagedKVView` (the
  paged-attention kernel on the card) and picks each running lane's next
  token on the device: greedy argmax, or with ``ServeConfig(sampling=True)``
  the per-lane sampling head of :mod:`.sampling`, each lane's threefry key
  lane state that the step advances. With ``nan_guard=True`` the step also
  gives each lane's logit finiteness, and a lane whose logits are not
  finite is evicted as FAILED ("nonfinite logits").

Decode and prefill are the reference's two compiled programs. Every input
of either is a static device buffer (:class:`~.kv_cache.Staged`: slot
state, tokens, sampling parameters, the chunk's ids and position), so on
the card each program is one CUDA graph, captured once per engine after one
eager warm-up call (the call that builds the kernels, allocates their
scratch and sets their attributes) and replayed every step; the KV pages
are updated in place inside the graphs. :class:`_Program` counts the
captures per program, the counterpart of the reference's ``_CountedJit``;
a capture that fails raises. A step copies its inputs in, replays, and
reads the next tokens (and the guard) back in one device-to-host copy. On
the CPU, and on the card with ``ServingEngine(..., eager=True)`` (the plain
version of the two programs, for tests and ``chip_smoke.py``), the same
program functions run eagerly on the same buffers.

With ``weight_dtype="int8"`` every projection of decode, prefill and
verify goes through the int8 weight-only kernel.

With ``ServeConfig(prefix_cache=True)`` admission matches each prompt
against :class:`~.prefix_cache.PrefixCache` and splices cached blocks into
the lane's table (a hit prefills only its tail); retirement donates the
lane's prefill-written blocks. The copy-on-write fork, the host tier's
offload and its restore are indexed copies on the engine's stream between
the programs (counted in ``stats()["kv_calls"]``); the programs and their
graphs do not change. With ``ServeConfig(draft=DraftConfig(...))`` the
decode program gives way to :mod:`.speculative`'s draft decode and verify,
each one CUDA graph beside prefill.

Sharding comes with a later slice of the port: ``lane_shards`` and
``weight_shards`` raise unless 1. Telemetry, spans, chaos sites and
autopilot knobs of the reference are left out; :meth:`ServingEngine.stats`
reports the host-side counts and the captures.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ... import random as R
from ...models.llama import (
    decode_matmul, decode_rms, decode_step, decode_weights, map_weights,
    quantize_decode_weights, resolve_device, rope_rotate, rope_tables,
)
from .kv_cache import PagedKVCache, Staged
from .paged_attention import PagedKVView, gather_lane_window, prefill_attend
from .prefix_cache import PrefixCache
from .request import (
    CANCELLED, DONE, FAILED, PREFILLING, RUNNING, WAITING, Request,
    SamplingParams,
)
from .sampling import sample_tokens
from .scheduler import Scheduler
from .speculative import DraftConfig, build_draft_fn, build_verify_fn

__all__ = ["ServeConfig", "ServingEngine"]

#: fields served by later slices of the port: (default, what brings them)
_LATER = {
    "lane_shards": (1, "the sharding slice (serving/sharding.py)"),
    "weight_shards": (1, "the sharding slice (serving/sharding.py)"),
}


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class ServeConfig:
    """Static serving shapes; every field keeps the reference's default."""

    num_lanes: int = 4
    block_size: int = 16
    #: pages in the pool INCLUDING the reserved trash block 0; None =
    #: enough for every lane at max_seq_len at once
    num_blocks: int | None = None
    #: per-lane token cap (prompt + generated); rounds up to whole blocks
    max_seq_len: int = 256
    prefill_chunk: int = 16
    #: prefill chunks run between two decode steps
    max_prefill_chunks_per_step: int = 1
    eos_token_id: int | None = None
    lane_shards: int = 1
    weight_shards: int = 1
    #: build the per-lane sampling head into the decode program
    #: (temperature, top-k, top-p, do_sample and a threefry key per lane)
    sampling: bool = False
    #: give the decode program a [lanes] logit-finiteness output; a lane
    #: whose logits are not finite is evicted, the others keep their streams
    nan_guard: bool = False
    #: "int8" quantizes every 2-D projection per output channel once at
    #: engine build and runs them through the int8 weight-only kernel
    weight_dtype: str = "bf16"
    #: speculative decoding: a :class:`.speculative.DraftConfig` (a small
    #: draft model and its lookahead k) replaces the decode program with
    #: draft decode and verify; greedy tokens stay the non-speculative
    #: engine's, sampled ones replay bit for bit
    draft: object | None = None
    #: the global prefix cache (:mod:`.prefix_cache`): block-aligned prompt
    #: prefixes deduplicated over the paged pool with copy-on-write block
    #: counts; greedy tokens stay those of a cache-cold run
    prefix_cache: bool = False
    #: host-memory budget, in KV blocks, of the prefix cache's cold tier:
    #: evicted blocks go to host memory (bitwise) and come back on a later
    #: hit. None reads ``PADDLE_KV_HOST_BLOCKS`` (default 0: the tier is
    #: off and evictions drop). Ignored unless ``prefix_cache``.
    host_kv_blocks: int | None = None

    def __post_init__(self):
        if self.host_kv_blocks is not None and self.host_kv_blocks < 0:
            raise ValueError("ServeConfig.host_kv_blocks must be >= 0")
        if self.weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"ServeConfig.weight_dtype must be one of ('bf16', 'int8'), "
                f"got {self.weight_dtype!r}")
        if self.nan_guard and self.draft is not None:
            raise ValueError(
                "ServeConfig(nan_guard=True, draft=...) is unsupported: the nan "
                "guard instruments the single decode program, which a "
                "speculative engine does not run")
        if self.draft is not None and not isinstance(self.draft, DraftConfig):
            raise ValueError("ServeConfig.draft must be a speculative.DraftConfig "
                             f"(got {type(self.draft).__name__})")
        for name, (default, later) in _LATER.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"ServeConfig.{name}={value!r} comes with {later} of the "
                    f"PyTorch port; this slice serves {name}={default!r}")


def _weak(method):
    """``method`` called through a weak reference to its object."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


class _Program:
    """One serving program (counterpart of the reference's ``_CountedJit``):
    ``fn`` reads and writes only static buffers. With ``graphed`` the
    first call runs ``fn`` eagerly (the warm-up: it builds the kernels,
    allocates their scratch and sets their attributes, and its results are
    the call's), then captures it as one CUDA graph, counted in
    ``captures``; every later call replays the graph. Without ``graphed``
    every call runs ``fn`` eagerly. ``calls`` counts the calls. A kernel
    wrapper counts its launches where it calls the launch: in the warm-up
    and while the capture records; a replay runs the recorded kernels and
    counts nothing (a device trace sees them)."""

    def __init__(self, name: str, fn, graphed: bool):
        self.name = name
        # a weak reference: an engine holds its programs, and a program that
        # held the engine would keep its pages and graph pools alive past
        # the engine's last reference (until a garbage collection)
        self._fn = weakref.WeakMethod(fn)
        self._graphed = graphed
        self._graph = None
        self.captures = 0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self._graph is not None:
            self._graph.replay()
            return
        fn = self._fn()
        fn()
        if not self._graphed:
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        self._graph = graph
        self.captures += 1


class ServingEngine:
    """Continuous-batching server for a :class:`LlamaForCausalLM`.

    :meth:`submit` queues a request, :meth:`step` runs one scheduler
    iteration (admit, prefill, one decode step), :meth:`run` drives until
    every request is terminal, :meth:`cancel` evicts a request at any
    point, :meth:`drain` stops admitting and finishes what is in flight.
    The engine runs on ``device`` (the card unless the caller asks for
    the CPU); the model's weights are moved there if needed. On the card
    its programs (decode and prefill; draft decode, verify and prefill
    for a speculative engine) run as CUDA graphs; ``eager=True`` runs them
    eagerly instead, as the CPU always does.
    """

    def __init__(self, model, config: ServeConfig | None = None, *,
                 device="cuda", eager: bool = False, **overrides):
        if config is not None and overrides:
            raise ValueError("pass either a ServeConfig or field overrides")
        self.config = config or ServeConfig(**overrides)
        cfg = self.config
        if cfg.num_lanes < 1 or cfg.prefill_chunk < 1:
            raise ValueError("num_lanes and prefill_chunk must be >= 1")
        self.device = resolve_device(device)
        self.model = model
        self._mcfg = model.config
        dev = self.device
        w = map_weights(decode_weights(model), lambda t: t.to(dev))
        if cfg.weight_dtype == "int8":
            w = quantize_decode_weights(w)
        self._w = w
        mb = -(-cfg.max_seq_len // cfg.block_size)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = cfg.num_lanes * mb + 1
        m = self._mcfg
        self._kv = PagedKVCache(
            m.num_hidden_layers, m.num_key_value_heads,
            m.hidden_size // m.num_attention_heads,
            num_blocks=num_blocks, block_size=cfg.block_size,
            num_lanes=cfg.num_lanes, max_blocks_per_lane=mb,
            dtype=w["embed"].dtype, device=self.device)
        self._sched = Scheduler(cfg.num_lanes)
        L = cfg.num_lanes
        self._spec = cfg.draft is not None
        if self._spec and cfg.draft.model.config.vocab_size != m.vocab_size:
            raise ValueError(
                f"ServeConfig.draft.model vocab_size ({cfg.draft.model.config.vocab_size}) "
                f"must match the target's ({m.vocab_size}): the verify compares token "
                "distributions index for index")
        # a speculative engine always carries the per-lane sampling state:
        # its acceptance needs every lane's strategy and seed key
        self._has_sampling = cfg.sampling or self._spec
        # the programs' own static inputs; the next-token ids are the host
        # mirror the scheduler edits
        lane_in = {"tok": np.zeros((L,), np.int64)}
        if self._has_sampling:
            lane_in.update(
                temp=np.ones((L,), np.float32), topk=np.zeros((L,), np.int32),
                topp=np.ones((L,), np.float32), do=np.zeros((L,), np.bool_),
                seed_keys=np.zeros((L, 2), np.int64))
        if cfg.sampling and not self._spec:
            lane_in["reseed"] = np.zeros((L,), np.bool_)
            # each lane's threefry key: lane state the decode program advances
            self._keys = torch.zeros((L, 2), dtype=torch.int64, device=self.device)
        self._in = Staged(self.device, **lane_in)
        self._lane_tok = self._in.host["tok"]
        self._samp_dirty = False
        C = cfg.prefill_chunk
        self._pf = Staged(self.device, ids=np.zeros((1, C), np.int64),
                          args=np.zeros((3,), np.int64))     # start, n_valid, lane
        # the decode program's outputs, read back in one copy: next tokens
        # and (nan guard) each lane's logit finiteness
        self._out = torch.zeros((2, L), dtype=torch.int64, device=self.device)
        pin = self.device.type == "cuda"
        self._out_host = torch.zeros((2, L), dtype=torch.int64, pin_memory=pin)
        self._read = torch.cuda.Event() if pin else None
        graphed = self.device.type == "cuda" and not eager
        if self._spec:
            # three programs, draft decode, verify and prefill; the plain
            # decode program is never built
            self._init_spec(cfg.draft, graphed)
            self._decode_prog = None
        else:
            self._decode_prog = _Program("decode", self._decode_fn, graphed)
        self._prefill_prog = _Program("prefill", self._prefill_fn, graphed)
        self._eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        self._requests: list = []
        self._next_id = 0
        self._steps = 0
        self._prefill_chunks = 0
        self._tokens = 0
        # the prefix cache: its fork, offload and restore are indexed
        # copies on the engine's stream, outside the two programs' graphs
        self._prefix = None
        self._kv_calls = {"kv_copy": 0, "kv_offload": 0, "kv_restore": 0}
        if cfg.prefix_cache:
            hb = cfg.host_kv_blocks
            if hb is None:
                hb = max(_env_int("PADDLE_KV_HOST_BLOCKS", 0), 0)
            self._host_kv_blocks = int(hb)
            self._prefix = PrefixCache(self._kv, cfg.prefill_chunk,
                                       host_blocks=self._host_kv_blocks)
            # weakly, as the programs: no cycle keeps the pool alive
            self._prefix.copy = _weak(self._fork_copy)
            if self._host_kv_blocks > 0:
                self._prefix.offload = _weak(self._offload_block)
                self._prefix.restore = _weak(self._restore_block)
            self._prefix_hits = self._prefix_misses = 0

    def _init_spec(self, draft: DraftConfig, graphed: bool):
        cfg, dev, L = self.config, self.device, self.config.num_lanes
        dcfg = draft.model.config
        self._draft_cfg = dcfg
        # the draft's weights stay unquantized, as in the reference
        self._draft_w = map_weights(decode_weights(draft.model), lambda t: t.to(dev))
        K = self._spec_k = draft.k
        dhd = dcfg.hidden_size // dcfg.num_attention_heads
        self._draft_max_len = cfg.max_seq_len + K
        shape = (L, self._draft_max_len, dcfg.num_key_value_heads, dhd)
        ddt = self._draft_w["embed"].dtype
        self._draft_kv = [(torch.zeros(shape, dtype=ddt, device=dev),
                           torch.zeros(shape, dtype=ddt, device=dev))
                          for _ in range(dcfg.num_hidden_layers)]
        # round state on the device: the lookahead's tokens and q, which
        # the host never reads
        self._toks = torch.zeros((L, K + 1), dtype=torch.int64, device=dev)
        self._qbuf = torch.zeros((L, K, self._mcfg.vocab_size), dtype=torch.float32,
                                 device=dev)
        #: each lane's draft-cache depth: committed positions the dense
        #: draft cache holds
        self._draft_len = np.zeros((L,), np.int32)
        # the draft program's static inputs (catch-up and every column
        # share one graph) and the verify's live lookahead, k
        self._dr = Staged(dev, tok_push=np.zeros((L,), np.int64), pos=np.zeros((L,), np.int64),
                          advance=np.zeros((L,), np.bool_),
                          round_start=np.zeros((L,), np.int64), j=np.zeros((1,), np.int64),
                          n_draft=np.full((1,), K, np.int64))
        # the verify's outputs, read back in one copy: k+1 tokens and the
        # emitted count a lane
        self._spec_out = torch.zeros((L, K + 2), dtype=torch.int64, device=dev)
        pin = dev.type == "cuda"
        self._spec_out_host = torch.zeros((L, K + 2), dtype=torch.int64, pin_memory=pin)
        self._draft_step = build_draft_fn(dcfg, K, self._draft_max_len)
        self._verify_step = build_verify_fn(self._mcfg, K, cfg.block_size,
                                            self._kv.max_blocks_per_lane)
        self._draft_prog = _Program("draft_decode", self._draft_fn, graphed)
        self._verify_prog = _Program("verify", self._verify_fn, graphed)
        self._spec_counts = {"rounds": 0, "proposed": 0, "accepted": 0}

    @property
    def _programs(self) -> list:
        if self._spec:
            return [self._draft_prog, self._verify_prog, self._prefill_prog]
        return [self._decode_prog, self._prefill_prog]

    # -- the programs ------------------------------------------------------

    def _decode_fn(self):
        """The decode program (reference ``_make_decode_fn``): one token for
        every lane against the paged pool, the next token picked on the
        device, written to the static outputs."""
        cfg, d = self.config, self._in.dev
        bt, ln, ac = self._kv.tables
        kv = PagedKVView(self._kv.pages_k, self._kv.pages_v, bt, ln, ac, cfg.block_size)
        logits = decode_step(self._mcfg, self._w, d["tok"], kv, ln)
        if cfg.sampling:
            keys = torch.where(d["reseed"][:, None], d["seed_keys"], self._keys)
            nxt, keys2 = sample_tokens(logits, keys, d["temp"], d["topk"], d["topp"],
                                       d["do"])
            # a lane's key advances once per active step: once per emitted
            # token, so it is a function of (seed, token index) alone
            self._keys.copy_(torch.where(ac[:, None], keys2, keys))
            d["reseed"].zero_()
        else:
            nxt = torch.argmax(logits, dim=-1)
        self._out[0].copy_(nxt)
        if cfg.nan_guard:
            self._out[1].copy_(torch.isfinite(logits.float()).all(dim=-1))

    def _draft_fn(self):
        """The draft-decode program (reference ``_make_draft_fn``): one
        draft step at the static column ``j`` for every lane."""
        d, r = self._in.dev, self._dr.dev
        self._draft_step(self._draft_w, r["tok_push"], self._toks, self._qbuf, self._draft_kv,
                         r["pos"], r["advance"], d["seed_keys"], r["round_start"], r["j"],
                         d["temp"], d["topk"], d["topp"], d["do"])

    def _verify_fn(self):
        """The verify program (reference ``_make_verify_fn``): all k+1
        round positions of every lane in one target step over the paged
        pool, acceptance on the device, tokens and counts to the static
        output."""
        d = self._in.dev
        bt, ln, ac = self._kv.tables
        out, n = self._verify_step(self._w, self._toks, self._kv.pages_k, self._kv.pages_v,
                                   bt, ln, ac, d["seed_keys"], self._qbuf,
                                   self._dr.dev["n_draft"], d["temp"], d["topk"],
                                   d["topp"], d["do"])
        self._spec_out[:, :-1].copy_(out)
        self._spec_out[:, -1].copy_(n)

    def _prefill_fn(self):
        """The prefill program (reference ``_make_prefill_fn``): one chunk of
        ``prefill_chunk`` tokens of one lane (``ids``, from absolute
        position ``start``, ``n_valid`` of them real), its K/V rows written
        into the lane's pages; padded rows write to trash block 0."""
        mcfg, w, dev = self._mcfg, self._w, self.device
        C = self.config.prefill_chunk
        bs = self.config.block_size
        H = mcfg.num_attention_heads
        Hk = mcfg.num_key_value_heads
        hd = mcfg.hidden_size // H
        eps = mcfg.rms_norm_eps
        ids, args = self._pf.dev["ids"], self._pf.dev["args"]
        posns = args[0] + torch.arange(C, device=dev)
        valid = torch.arange(C, device=dev) < args[1]
        bt_row = self._kv.tables[0].index_select(0, args[2:3])
        blk = torch.clamp(posns // bs, max=bt_row.shape[1] - 1)
        off = posns % bs
        phys = torch.where(valid, bt_row[0].long()[blk], torch.zeros_like(blk))
        pages_k, pages_v = self._kv.pages_k, self._kv.pages_v
        h = w["embed"][ids]
        sin, cos = rope_tables(posns, mcfg.rope_theta, hd)
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
        for li, lw in enumerate(w["layers"]):
            x = decode_rms(h, lw["input_ln"], eps)
            q = decode_matmul(x, lw["q"]).reshape(1, C, H, hd)
            k = decode_matmul(x, lw["k"]).reshape(1, C, Hk, hd)
            v = decode_matmul(x, lw["v"]).reshape(1, C, Hk, hd)
            q, k = rope_rotate(q, sin, cos), rope_rotate(k, sin, cos)
            # in place into the pool (the reference returns donated arrays)
            pages_k[li, phys, off] = k[0]
            pages_v[li, phys, off] = v[0]
            kc = gather_lane_window(pages_k[li], bt_row)
            vc = gather_lane_window(pages_v[li], bt_row)
            out = prefill_attend(q, kc, vc, posns)
            h = h + decode_matmul(out.reshape(1, C, H * hd), lw["o"])
            x = decode_rms(h, lw["post_ln"], eps)
            h = h + decode_matmul(
                torch.nn.functional.silu(decode_matmul(x, lw["gate"]))
                * decode_matmul(x, lw["up"]), lw["down"])

    # -- the prefix cache's device side -----------------------------------

    @torch.no_grad()
    def _fork_copy(self, shard: int, src: int, dst: int):
        """The COW fork (``PrefixCache.copy``): block ``src`` copied into
        ``dst`` in every layer's K and V pages, in stream order."""
        for pages in (self._kv.pages_k, self._kv.pages_v):
            pages[:, dst].copy_(pages[:, src])
        self._kv_calls["kv_copy"] += 1

    @torch.no_grad()
    def _offload_block(self, shard: int, block: int):
        """``PrefixCache.offload``: block ``block`` of every layer's K and V
        pages copied to host memory (pinned on the card), waited for
        before the block returns to the free list; bitwise exact."""
        pin = self.device.type == "cuda"
        pay = []
        for pages in (self._kv.pages_k, self._kv.pages_v):
            host = torch.empty(pages[:, block].shape, dtype=pages.dtype, pin_memory=pin)
            host.copy_(pages[:, block], non_blocking=pin)
            pay.append(host)
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        self._kv_calls["kv_offload"] += 1
        return tuple(pay)

    @torch.no_grad()
    def _restore_block(self, shard: int, payload, block: int):
        """``PrefixCache.restore``: an offloaded payload written back into
        block ``block``, in stream order."""
        pin = self.device.type == "cuda"
        for pages, host in zip((self._kv.pages_k, self._kv.pages_v), payload):
            pages[:, block].copy_(host, non_blocking=pin)
        self._kv_calls["kv_restore"] += 1

    # -- public API --------------------------------------------------------

    def _validate(self, prompt, max_new_tokens: int, sampling) -> None:
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sampling is not None and not sampling.greedy and not self._has_sampling:
            raise ValueError(
                "non-greedy SamplingParams need an engine built with "
                "ServeConfig(sampling=True): the sampling head is part of the "
                "decode program")
        total = len(prompt) + max_new_tokens
        if total > self._kv.lane_capacity:
            raise ValueError(
                f"request needs {total} cache slots but a lane caps at "
                f"{self._kv.lane_capacity} (max_seq_len rounded to blocks)")
        if self._kv.blocks_needed(total) > self._kv.num_blocks - 1:
            raise ValueError(
                f"request needs {self._kv.blocks_needed(total)} blocks but "
                f"the pool only has {self._kv.num_blocks - 1}")

    def submit(self, prompt, max_new_tokens: int | None = None, *,
               priority: int = 1, deadline_us: float | None = None,
               slo_class: str | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Queue one generation job; returns its Request handle. Lower
        ``priority`` admits first; ``deadline_us`` is a completion
        deadline relative to now (earliest first within a priority)."""
        prompt = [int(t) for t in prompt]
        if max_new_tokens is None:
            max_new_tokens = self.config.max_seq_len - len(prompt)
        max_new_tokens = int(max_new_tokens)
        self._validate(prompt, max_new_tokens, sampling)
        now = time.perf_counter()
        deadline = None if deadline_us is None else now + float(deadline_us) / 1e6
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      submitted_step=self._steps, priority=int(priority),
                      deadline=deadline, slo_class=slo_class,
                      sampling=sampling, submit_time=now)
        self._next_id += 1
        self._requests.append(req)
        self._sched.submit(req)
        return req

    def enqueue(self, req: Request) -> Request:
        """Queue a caller-built :class:`Request` as it is (id, priority,
        absolute deadline and submit time kept); later :meth:`submit`
        ids stay unique."""
        self._validate(req.prompt, req.max_new_tokens, req.sampling)
        req.submitted_step = self._steps
        self._next_id = max(self._next_id, req.id + 1)
        self._requests.append(req)
        self._sched.submit(req)
        return req

    def cancel(self, req: Request) -> Request:
        """Evict ``req`` wherever it is in its lifecycle."""
        if not req.finished:
            if req.status == WAITING:
                self._sched.drop_waiting(req)
                req.status = CANCELLED
                req.finished_step = self._steps
                req.finish_time = time.perf_counter()
            else:
                self._evict(req.lane, CANCELLED, None)
        return req

    def step(self) -> int:
        """One scheduler iteration: admit, prefill, then at most one decode
        step. Returns the number of tokens emitted."""
        self._admit()
        self._prefill()
        emitted = self._decode_spec() if self._spec else self._decode()
        self._steps += 1
        return emitted

    def run(self, max_steps: int | None = None) -> list:
        """Drive :meth:`step` until every submitted request is terminal."""
        limit = max_steps if max_steps is not None else 1_000_000
        n = 0
        while self._sched.pending():
            self.step()
            n += 1
            if n >= limit:
                raise RuntimeError(
                    f"serving engine still pending after {n} steps")
        return list(self._requests)

    def drain(self, deadline_s: float | None = None) -> list:
        """Stop admitting: every still-waiting request is taken out of the
        queue and returned with its status untouched; then finish the
        in-flight requests within ``deadline_s`` seconds (None =
        unbounded). Requests still on a lane past the deadline are
        evicted as FAILED and returned too."""
        stranded = list(self._sched.waiting)
        for req in stranded:
            self._sched.drop_waiting(req)
        t_end = None if deadline_s is None else time.perf_counter() + float(deadline_s)
        while self._sched.pending():
            if t_end is not None and time.perf_counter() > t_end:
                for lane in self._sched.occupied_lanes():
                    stranded.append(self._sched.lanes[lane])
                    self._evict(lane, FAILED, "drain deadline exceeded")
                break
            self.step()
        return stranded

    def pending(self) -> bool:
        return self._sched.pending()

    @property
    def steps(self) -> int:
        return self._steps

    def stats(self) -> dict:
        out = {
            "steps": self._steps,
            "waiting": len(self._sched.waiting),
            "occupied_lanes": len(self._sched.occupied_lanes()),
            "free_blocks": self._kv.free_blocks,
            "requests": len(self._requests),
            "prefill_chunks": self._prefill_chunks,
            "tokens": self._tokens,
            "weight_dtype": self.config.weight_dtype,
            "device": str(self.device),
            "captures": {p.name: p.captures for p in self._programs},
            "program_calls": {p.name: p.calls for p in self._programs},
        }
        if self._spec:
            sc = self._spec_counts
            out["spec"] = dict(sc, k=self._spec_k, accept_rate=(
                sc["accepted"] / sc["proposed"] if sc["proposed"] else 0.0))
        if self._prefix is not None:
            looked = self._prefix_hits + self._prefix_misses
            out["prefix_cache"] = dict(
                self._prefix.stats(), shared_blocks=self._kv.shared_blocks,
                host_budget=self._host_kv_blocks, hits=self._prefix_hits,
                misses=self._prefix_misses,
                hit_frac=self._prefix_hits / looked if looked else 0.0)
            out["kv_calls"] = dict(self._kv_calls)
        return out

    # -- scheduler phases --------------------------------------------------

    def _admit(self):
        pc = self._prefix

        def can(req, lane):
            # full reservation; with the prefix cache a matched chain's
            # resident blocks cost no fresh block, so a hit admits where a
            # cold request of its length could not
            total = len(req.prompt) + req.max_new_tokens
            s = self._kv.shard_of(lane)
            if pc is not None:
                plan = pc.match(req.prompt, total, s)
                if plan is not None:
                    return pc.admissible(plan, total)
            return self._kv.can_admit(total, shard=s)

        for req, lane in self._sched.pick_admissions(can):
            total = len(req.prompt) + req.max_new_tokens
            s = self._kv.shard_of(lane)
            # match again: the probe judged the whole batch before any
            # allocation, so its verdicts can be stale within the batch
            plan = pc.match(req.prompt, total, s) if pc is not None else None
            ok = (pc.admissible(plan, total) if plan is not None
                  else self._kv.can_admit(total, shard=s))
            if not ok:
                # an earlier admission of this batch took the blocks the
                # probe counted on: requeue untouched
                self._sched.release(lane)
                self._sched.submit(req)
                continue
            if plan is not None:
                prefix_blocks, owned = pc.take(plan)
                self._kv.allocate_lane(lane, total, prefix=prefix_blocks,
                                       prefix_owned=owned)
                req.prefill_pos = min(plan.tokens, len(req.prompt) - 1)
                self._prefix_hits += 1
            else:
                self._kv.allocate_lane(lane, total)
                req.prefill_pos = 0
                if pc is not None:
                    self._prefix_misses += 1
            req.status = PREFILLING
            req.admit_time = time.perf_counter()
            if self._has_sampling:
                self._seed_lane(lane, req)
            if req.prefill_pos >= len(req.prompt) - 1:
                self._activate(lane, req)

    def _seed_lane(self, lane: int, req: Request):
        """Write the lane's sampling strategy and ``PRNGKey(seed)`` into the
        decode program's inputs; the key takes effect at the lane's next
        decode step and then advances once per emitted token."""
        sp = req.sampling
        greedy = sp is None or sp.greedy
        h = self._in.host
        h["do"][lane] = not greedy
        h["temp"][lane] = 1.0 if greedy else max(sp.temperature, 1e-6)
        h["topk"][lane] = 0 if greedy else int(sp.top_k)
        h["topp"][lane] = 1.0 if greedy else float(sp.top_p)
        h["seed_keys"][lane] = R.prng_key(0 if sp is None else sp.seed).numpy()
        if "reseed" in h:
            h["reseed"][lane] = True
        self._samp_dirty = True

    def _activate(self, lane: int, req: Request):
        """Prompt prefilled: the lane joins the decode batch with the LAST
        prompt token as its next input, written at position
        len(prompt)-1 by its first decode step."""
        req.status = RUNNING
        self._kv.lengths[lane] = len(req.prompt) - 1
        self._lane_tok[lane] = req.prompt[-1]
        if self._spec:
            # the dense draft cache is rebuilt from position 0 by the
            # catch-up replay; a former occupant's bytes lie past every
            # query's mask
            self._draft_len[lane] = 0

    def _prefill(self):
        budget = int(self.config.max_prefill_chunks_per_step)
        for lane in self._sched.prefilling_lanes():
            if budget <= 0:
                break
            req = self._sched.lanes[lane]
            target = len(req.prompt) - 1
            while budget > 0 and req.prefill_pos < target:
                start = req.prefill_pos
                n = min(self.config.prefill_chunk, target - start)
                self._prefill_chunk(lane, req.prompt[start:start + n], start)
                req.prefill_pos = start + n
                self._prefill_chunks += 1
                budget -= 1
            if req.prefill_pos >= target:
                self._activate(lane, req)

    @torch.no_grad()
    def _prefill_chunk(self, lane: int, tokens: list, start: int):
        """Run ``tokens`` (at most one chunk) of ``lane``'s prompt, starting
        at absolute position ``start``, through the prefill program."""
        ids, args = self._pf.host["ids"], self._pf.host["args"]
        ids[...] = 0
        ids[0, :len(tokens)] = tokens
        args[...] = (start, len(tokens), lane)
        self._kv.device_tables()
        self._pf.push()
        self._prefill_prog()

    @torch.no_grad()
    def _decode(self) -> int:
        running = self._sched.running_lanes()
        if not running:
            return 0
        self._kv.active[...] = False
        self._kv.active[running] = True
        self._kv.device_tables()
        if self._samp_dirty:
            self._in.push()
            self._in.host["reseed"][...] = False
            self._samp_dirty = False
        else:
            self._in.push("tok")
        self._decode_prog()
        # one device-to-host copy of the outputs, then wait for it
        self._out_host.copy_(self._out, non_blocking=self._read is not None)
        if self._read is not None:
            self._read.record()
            self._read.synchronize()
        nxt, fin = self._out_host.numpy()
        now = time.perf_counter()
        emitted = 0
        for lane in running:
            req = self._sched.lanes[lane]
            if self.config.nan_guard and not fin[lane]:
                # non-finite logits are lane-local: evict only this lane,
                # without its garbage token; the others keep their streams
                self._evict(lane, FAILED, "nonfinite logits")
                continue
            self._kv.lengths[lane] += 1
            t = int(nxt[lane])
            req.generated.append(t)
            self._lane_tok[lane] = t
            emitted += 1
            if len(req.generated) == 1:
                req.first_token_time = now
            if t == self._eos or len(req.generated) >= req.max_new_tokens:
                self._retire(lane, req)
        self._tokens += emitted
        return emitted

    def _dispatch_draft(self, tok_push, adv, pos, j: int, round_start):
        """One draft-decode call: the same graph for catch-up and every
        lookahead column (``j`` is a static input buffer)."""
        h = self._dr.host
        h["tok_push"][...] = tok_push
        h["advance"][...] = adv
        h["pos"][...] = pos
        h["round_start"][...] = round_start
        h["j"][0] = j
        self._dr.push()
        self._draft_prog()

    @torch.no_grad()
    def _decode_spec(self) -> int:
        """One speculative round (reference ``_decode_spec``): catch-up
        replays until each lane's draft cache holds its committed length,
        k draft calls ahead, one verify of all k+1 positions, then the host
        harvest. ``lengths`` advances by the accepted count only: that is
        the rollback. The live lookahead is ``DraftConfig.k``, the
        reference's value when its ``serve.spec_k`` autopilot knob is unset
        (the port has no autopilot)."""
        running = self._sched.running_lanes()
        if not running:
            return 0
        kv = self._kv
        kv.active[...] = False
        kv.active[running] = True
        if self._samp_dirty:
            self._in.push()
            self._samp_dirty = False
        K = nd = self._spec_k
        L = self.config.num_lanes
        # catch-up: committed tokens stream through the draft program until
        # each lane's dense cache reaches its round-start length (a fresh
        # admission replays its prompt; after a round that accepted
        # everything the deficit is the bonus token alone)
        while True:
            adv = np.zeros((L,), np.bool_)
            tok_push = np.zeros((L,), np.int64)
            pos = np.zeros((L,), np.int64)
            for lane in running:
                dl = int(self._draft_len[lane])
                if dl < int(kv.lengths[lane]):
                    req = self._sched.lanes[lane]
                    tok_push[lane] = (req.prompt + req.generated)[dl]
                    pos[lane] = dl
                    adv[lane] = True
            if not adv.any():
                break
            self._dispatch_draft(tok_push, adv, pos, 0, kv.lengths)
            self._draft_len[adv] += 1
        # k steps ahead: step j reads step j-1's proposal on the device
        L0 = kv.lengths.astype(np.int64)
        for j in range(nd):
            self._dispatch_draft(self._lane_tok, kv.active, L0 + j, j, L0)
        kv.device_tables()
        self._verify_prog()
        self._spec_out_host.copy_(self._spec_out, non_blocking=self._read is not None)
        if self._read is not None:
            self._read.record()
            self._read.synchronize()
        res = self._spec_out_host.numpy()
        now = time.perf_counter()
        emitted = accepted = 0
        for lane in running:
            req = self._sched.lanes[lane]
            m = int(res[lane, K + 1])
            accepted += m - 1
            took, last, retired = 0, 0, False
            for t in res[lane, :m]:
                t = int(t)
                req.generated.append(t)
                took += 1
                last = t
                if len(req.generated) == 1:
                    req.first_token_time = now
                if t == self._eos or len(req.generated) >= req.max_new_tokens:
                    retired = True
                    break
            emitted += took
            if retired:
                self._retire(lane, req)
            else:
                kv.lengths[lane] += took
                self._draft_len[lane] = int(L0[lane]) + min(nd, took)
                self._lane_tok[lane] = last
        sc = self._spec_counts
        sc["rounds"] += 1
        sc["proposed"] += nd * len(running)
        sc["accepted"] += max(accepted, 0)
        self._tokens += emitted
        return emitted

    def _retire(self, lane: int, req: Request):
        req.status = DONE
        req.finished_step = self._steps
        req.finish_time = time.perf_counter()
        if self._prefix is not None:
            # donate the lane's prefill-written blocks before their counts
            # drop: the cache retains them as they reach 0
            self._prefix.insert(req.prompt, self._kv.shard_of(lane),
                                self._kv.lane_blocks(lane))
        self._kv.free_lane(lane)
        self._sched.release(lane)

    def _evict(self, lane: int, status: str, error: str | None):
        req = self._sched.lanes[lane]
        self._kv.free_lane(lane)
        self._sched.release(lane)
        if req is not None:
            req.status = status
            if error:
                req.error = error
            req.finished_step = self._steps
            req.finish_time = time.perf_counter()
