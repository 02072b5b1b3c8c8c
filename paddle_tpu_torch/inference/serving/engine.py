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

Observability, as the reference's (``profiler``): the ``serve.*``
counters, gauges and histograms (admitted, completed, steps, prefill
chunks, prefix hits and misses, speculative rounds; occupancy, waiting,
KV blocks in use, accept rate; TTFT, inter-token time split into the
decode's dispatch, sampling push and sync, deadline slack), the spans
``serve.admit``, ``serve.prefill_chunk``, ``serve.decode.dispatch``,
``serve.decode.sync``, ``serve.spec.draft`` and ``serve.spec.verify``,
one goodput ``step`` a scheduler step and an ``eviction`` loss a lane's
thrown-away work. ``serve.compiles{program}`` counts the CUDA-graph
captures, where the reference counts compiles. Attribution counts each
program's FLOPs and bytes in its first, eager call (never inside a
capture) and divides each call's device time (a CUDA event pair around the
call or the replay, read after the step's sync) into
``jit.program_mfu{program}`` / ``jit.program_roofline_frac{program}``,
and the decode's into ``serve.decode_roofline_tok_s`` /
``serve.decode_roofline_frac``. A counter or span inside a captured
function would run once, at the capture: every one sits in the host code
around the programs.

Sharding comes with a later slice of the port: ``lane_shards`` and
``weight_shards`` raise unless 1. Chaos sites and autopilot knobs of the
reference are left out; :meth:`ServingEngine.stats` reports the
host-side counts and the captures. Its counts of prefill chunks, prefix
hits and misses and speculative rounds are the engine's own: the
registry's ``serve.*`` counters are process-wide, shared by every engine
of the process and zeroed by ``telemetry.reset()``. One :class:`_Tally`
an event bumps both, so the two cannot drift.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ... import random as R
from ...profiler import attribution as _attrib
from ...profiler import goodput as _goodput
from ...profiler import spans as _spans
from ...profiler import telemetry as _telemetry
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


class _Tally:
    """An engine's own count of one event and the registry's counter of it
    (process-wide), bumped together: :meth:`ServingEngine.stats` reads
    :attr:`n`."""

    __slots__ = ("n", "_counter")

    def __init__(self, name: str):
        self.n = 0
        self._counter = _telemetry.counter(name)

    def bump(self, k: int = 1) -> None:
        self.n += k
        self._counter.bump(k)

    @property
    def total(self) -> int:
        """The process's count (the registry's), as the reference reads it."""
        return self._counter.value


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
    counts nothing (a device trace sees them).

    Each call is timed on the device (a :class:`~paddle_tpu_torch.profiler.
    attribution.DeviceTimer`, appended to ``pending`` for the engine to
    attribute once the device has passed it); the first call, eager, runs
    under the attribution's counting pass when ``costs`` wants it; a
    capture bumps ``serve.compiles{program}``."""

    def __init__(self, name: str, fn, graphed: bool, costs=None, device=None, pending=None):
        self.name = name
        # a weak reference: an engine holds its programs, and a program that
        # held the engine would keep its pages and graph pools alive past
        # the engine's last reference (until a garbage collection)
        self._fn = weakref.WeakMethod(fn)
        self._graphed = graphed
        self._graph = None
        self._costs = costs
        self._device = device if device is not None else torch.device("cpu")
        self._pending = pending if pending is not None else []
        self._c_compiles = _telemetry.counter("serve.compiles", program=name)
        self.captures = 0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        timer = _attrib.DeviceTimer(self._device)
        timer.start()
        if self._graph is not None:
            self._graph.replay()
            timer.stop()
            self._pending.append((self.name, timer))
            return
        fn = self._fn()
        if self._costs is not None and self._costs.wants(self.name):
            with _attrib.counting() as counter:
                fn()
            self._costs.record(self.name, counter, self._device)
        else:
            fn()
        timer.stop()
        self._pending.append((self.name, timer))
        if not self._graphed:
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        self._graph = graph
        self.captures += 1
        self._c_compiles.bump()


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
        # attribution: each program's counted cost, and the device timers
        # of calls not yet attributed
        self._prog_costs = _attrib.ProgramCosts()
        self._prog_pending: list = []
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
            self._decode_prog = self._program("decode", self._decode_fn, graphed)
        self._prefill_prog = self._program("prefill", self._prefill_fn, graphed)
        self._eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        self._requests: list = []
        self._next_id = 0
        self._steps = 0
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
        # metric handles held once: the hot path pays attribute bumps only
        self._c_admitted = _telemetry.counter("serve.admitted")
        self._c_completed = _telemetry.counter("serve.completed")
        self._n_prefill_chunks = _Tally("serve.prefill_chunks")
        self._c_steps = _telemetry.counter("serve.steps")
        self._g_occupancy = _telemetry.gauge("serve.batch_occupancy")
        self._g_waiting = _telemetry.gauge("serve.waiting")
        self._g_blocks = _telemetry.gauge("serve.kv_blocks_in_use")
        # inter_token_us is host-sync inclusive; decode_dispatch_us,
        # sample_us (a sampling engine's state push) and decode_sync_us
        # split it exactly (the same clock reads)
        self._h_inter_token = _telemetry.histogram("serve.inter_token_us")
        self._h_dispatch = _telemetry.histogram("serve.decode_dispatch_us")
        self._h_sync = _telemetry.histogram("serve.decode_sync_us")
        self._h_sample = _telemetry.histogram("serve.sample_us")
        self._h_slack = _telemetry.histogram("serve.deadline_slack_us")
        self._h_ttft = _telemetry.histogram("serve.ttft_us")
        if self._prefix is not None:
            self._n_prefix_hits = _Tally("serve.prefix_hits")
            self._n_prefix_misses = _Tally("serve.prefix_misses")
            self._g_prefix_hit_frac = _telemetry.gauge("serve.prefix_hit_frac")
            self._g_blocks_shared = _telemetry.gauge("serve.kv_blocks_shared")
        if self._spec:
            # draft + verify partition a round's wall exactly
            self._h_spec_draft = _telemetry.histogram("serve.spec_draft_us")
            self._h_spec_verify = _telemetry.histogram("serve.spec_verify_us")
            self._n_spec = {k: _Tally(f"serve.spec_{k}")
                            for k in ("rounds", "proposed", "accepted")}
            self._g_spec_accept = _telemetry.gauge("serve.spec_accept_rate")
        # an SLO-miss burst (PADDLE_SLO_BURST misses within
        # PADDLE_SLO_BURST_WINDOW steps; 0 = off) dumps the flight ring
        self._slo_burst_n = _env_int("PADDLE_SLO_BURST", 4)
        self._slo_burst_window = max(_env_int("PADDLE_SLO_BURST_WINDOW", 8), 1)
        self._slo_miss_steps: list = []
        # PADDLE_KV_AUDIT=N re-proves the allocator's invariants on the live
        # pool every N steps; a violation is a flight record and a count,
        # not a crash
        self._audit_every = max(_env_int("PADDLE_KV_AUDIT", 0), 0)
        self._c_audit_failures = _telemetry.counter("serve.audit_failures")

    def _audit_tick(self) -> None:
        """Audit the paged allocator (and the prefix cache's custody); a
        violation bumps ``serve.audit_failures`` and is a flight record."""
        try:
            self._kv.audit(self._prefix.cached_blocks if self._prefix is not None else None)
        except AssertionError as e:
            from ...profiler import flight_recorder as _flight

            self._c_audit_failures.bump()
            _flight.recorder().record("kv_audit", op="serve.audit",
                                      extra={"step": self._steps, "error": str(e)})

    def _program(self, name: str, fn, graphed: bool) -> "_Program":
        return _Program(name, fn, graphed, costs=self._prog_costs, device=self.device,
                        pending=self._prog_pending)

    def _note_programs(self, decode_tokens: int = 0) -> None:
        """Attribute every timed program call the device has passed: the
        MFU and roofline gauges, and for the decode (or the verify, which
        emits a speculative round's tokens) the tokens/s pair."""
        pending, self._prog_pending[:] = list(self._prog_pending), []
        for name, timer in pending:
            if not timer.ready():
                self._prog_pending.append((name, timer))
                continue
            wall_us = timer.elapsed_us()
            self._prog_costs.note_dispatch(name, wall_us)
            if decode_tokens and name in ("decode", "verify"):
                self._prog_costs.note_decode_tokens(name, wall_us, decode_tokens)

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
        self._draft_prog = self._program("draft_decode", self._draft_fn, graphed)
        self._verify_prog = self._program("verify", self._verify_fn, graphed)

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
        trace_id = f"{os.getpid():x}-{id(self) & 0xffffff:x}-{self._next_id}"
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      submitted_step=self._steps, priority=int(priority),
                      deadline=deadline, slo_class=slo_class,
                      sampling=sampling, trace_id=trace_id, submit_time=now)
        self._next_id += 1
        self._requests.append(req)
        self._sched.submit(req)
        self._g_waiting.set(len(self._sched.waiting))
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
        self._g_waiting.set(len(self._sched.waiting))
        return req

    def cancel(self, req: Request) -> Request:
        """Evict ``req`` wherever it is in its lifecycle."""
        if not req.finished:
            if req.status == WAITING:
                self._sched.drop_waiting(req)
                req.status = CANCELLED
                req.finished_step = self._steps
                req.finish_time = time.perf_counter()
                _telemetry.counter("serve.evicted", reason="cancel").bump()
                self._trace_retire(req)
            else:
                self._evict(req.lane, CANCELLED, None, reason="cancel")
        self._g_waiting.set(len(self._sched.waiting))
        return req

    def step(self) -> int:
        """One scheduler iteration: admit, prefill, then at most one decode
        step. Returns the number of tokens emitted."""
        t0 = time.perf_counter()
        self._admit()
        self._prefill()
        emitted = self._decode_spec() if self._spec else self._decode()
        self._steps += 1
        self._c_steps.bump()
        if self._audit_every and self._steps % self._audit_every == 0:
            self._audit_tick()
        # one scheduler iteration is one serve step; eviction losses noted
        # during it subtract from productive
        _goodput.step((time.perf_counter() - t0) * 1e6, kind="serve", scope=id(self))
        if self._prog_pending:
            self._note_programs()
        self._g_occupancy.set(len(self._sched.running_lanes()))
        self._g_blocks.set(self._kv.blocks_in_use)
        self._g_waiting.set(len(self._sched.waiting))
        if self._prefix is not None:
            hits, misses = self._n_prefix_hits.total, self._n_prefix_misses.total
            if hits + misses:
                self._g_prefix_hit_frac.set(hits / (hits + misses))
            self._g_blocks_shared.set(self._kv.shared_blocks)
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
                    self._evict(lane, FAILED, "drain deadline exceeded", reason="drain")
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
            "prefill_chunks": self._n_prefill_chunks.n,
            "tokens": self._tokens,
            "weight_dtype": self.config.weight_dtype,
            "device": str(self.device),
            "captures": {p.name: p.captures for p in self._programs},
            "program_calls": {p.name: p.calls for p in self._programs},
        }
        if self._spec:
            sc = {k: t.n for k, t in self._n_spec.items()}
            out["spec"] = dict(sc, k=self._spec_k, accept_rate=(
                sc["accepted"] / sc["proposed"] if sc["proposed"] else 0.0))
        if self._prefix is not None:
            hits, misses = self._n_prefix_hits.n, self._n_prefix_misses.n
            out["prefix_cache"] = dict(
                self._prefix.stats(), shared_blocks=self._kv.shared_blocks,
                host_budget=self._host_kv_blocks, hits=hits, misses=misses,
                hit_frac=hits / (hits + misses) if hits + misses else 0.0)
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
            with _spans.span("serve.admit", step=self._steps, req=req.id, lane=lane,
                             trace=req.trace_id) as sp:
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
                    self._n_prefix_hits.bump()
                    sp.set(prefix_tokens=plan.tokens)
                else:
                    self._kv.allocate_lane(lane, total)
                    req.prefill_pos = 0
                    if pc is not None:
                        self._n_prefix_misses.bump()
                req.status = PREFILLING
                req.admit_time = time.perf_counter()
                if self._has_sampling:
                    self._seed_lane(lane, req)
                self._c_admitted.bump()
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
                with _spans.span("serve.prefill_chunk", step=self._steps, req=req.id,
                                 lane=lane, start=start, tokens=n, trace=req.trace_id):
                    self._prefill_chunk(lane, req.prompt[start:start + n], start)
                req.prefill_pos = start + n
                self._n_prefill_chunks.bump()
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
        self._g_occupancy.set(len(running))
        if not running:
            return 0
        self._kv.active[...] = False
        self._kv.active[running] = True
        # the dispatch (host work that launches the step) and the sync (the
        # wait for the device) are separate spans and histograms; a sampling
        # engine's state push is booked as serve.sample_us, outside both
        t0 = time.perf_counter()
        samp = 0.0
        with _spans.span("serve.decode.dispatch", step=self._steps, lanes=len(running)):
            self._kv.device_tables()
            if self._samp_dirty:
                s0 = time.perf_counter()
                self._in.push()
                self._in.host["reseed"][...] = False
                self._samp_dirty = False
                samp = time.perf_counter() - s0
            else:
                self._in.push("tok")
            self._decode_prog()
            # one device-to-host copy of the outputs
            self._out_host.copy_(self._out, non_blocking=self._read is not None)
            if self._read is not None:
                self._read.record()
        t1 = time.perf_counter()
        with _spans.span("serve.decode.sync", step=self._steps, lanes=len(running)):
            if self._read is not None:
                self._read.synchronize()
            nxt, fin = self._out_host.numpy()
        t2 = time.perf_counter()
        self._h_dispatch.observe((t1 - t0 - samp) * 1e6)
        self._h_sync.observe((t2 - t1) * 1e6)
        if self.config.sampling:
            self._h_sample.observe(samp * 1e6)
        self._h_inter_token.observe((t2 - t0) * 1e6)
        now = time.perf_counter()
        emitted = 0
        for lane in running:
            req = self._sched.lanes[lane]
            if self.config.nan_guard and not fin[lane]:
                # non-finite logits are lane-local: evict only this lane,
                # without its garbage token; the others keep their streams
                from ...profiler import flight_recorder as _flight

                _flight.recorder().record("numerics", op="serve.decode",
                                          extra={"lane": lane, "req": req.id,
                                                 "step": self._steps})
                self._evict(lane, FAILED, "nonfinite logits", reason="nonfinite")
                continue
            self._kv.lengths[lane] += 1
            t = int(nxt[lane])
            req.generated.append(t)
            self._lane_tok[lane] = t
            emitted += 1
            if len(req.generated) == 1:
                req.first_token_time = now
                if req.submit_time is not None:
                    self._h_ttft.observe((now - req.submit_time) * 1e6)
            if t == self._eos or len(req.generated) >= req.max_new_tokens:
                self._retire(lane, req)
        self._tokens += emitted
        self._note_programs(emitted)
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
    def _draft_ahead(self, running):
        """A round's draft phase: the catch-up replay, then k draft calls
        ahead; returns the lanes' round-start lengths."""
        kv = self._kv
        if self._samp_dirty:
            self._in.push()
            self._samp_dirty = False
        nd = self._spec_k
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
        return L0

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
        self._g_occupancy.set(len(running))
        if not running:
            return 0
        kv = self._kv
        kv.active[...] = False
        kv.active[running] = True
        K = nd = self._spec_k
        t0 = time.perf_counter()
        with _spans.span("serve.spec.draft", step=self._steps, lanes=len(running),
                         k=self._spec_k):
            L0 = self._draft_ahead(running)
        t1 = time.perf_counter()
        with _spans.span("serve.spec.verify", step=self._steps, lanes=len(running), k=nd):
            kv.device_tables()
            self._verify_prog()
            self._spec_out_host.copy_(self._spec_out, non_blocking=self._read is not None)
            if self._read is not None:
                self._read.record()
                self._read.synchronize()
            res = self._spec_out_host.numpy()
        t2 = time.perf_counter()
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
                    if req.submit_time is not None:
                        self._h_ttft.observe((now - req.submit_time) * 1e6)
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
        sc = self._n_spec
        sc["rounds"].bump()
        sc["proposed"].bump(nd * len(running))
        sc["accepted"].bump(max(accepted, 0))
        self._tokens += emitted
        self._h_spec_draft.observe((t1 - t0) * 1e6)
        self._h_spec_verify.observe((t2 - t1) * 1e6)
        self._h_inter_token.observe((t2 - t0) * 1e6)
        if sc["proposed"].n:
            self._g_spec_accept.set(sc["accepted"].n / sc["proposed"].n)
        self._note_programs(emitted)
        return emitted

    def _note_slo(self, req: Request):
        """Book the request's deadline outcome at its DONE / FAILED
        terminal: a miss bumps ``serve.slo_miss{class}``, the remaining
        slack (0-clamped) lands in ``serve.deadline_slack_us``, and a burst
        of misses dumps the flight ring."""
        if req.deadline is None:
            return
        slack_us = (req.deadline - time.perf_counter()) * 1e6
        if slack_us < 0:
            _telemetry.counter("serve.slo_miss", **{"class": req.slo_label}).bump()
            self._slo_miss_steps.append(self._steps)
            self._slo_miss_steps = [s for s in self._slo_miss_steps
                                    if self._steps - s < self._slo_burst_window]
            if self._slo_burst_n > 0 and len(self._slo_miss_steps) >= self._slo_burst_n:
                self._slo_miss_steps.clear()
                _telemetry.counter("serve.slo_burst_dumps").bump()
                from ...profiler import flight_recorder as _flight

                _flight.recorder().dump(reason=f"slo_miss_burst:{req.slo_label}")
        self._h_slack.observe(max(slack_us, 0.0))

    def _trace_retire(self, req: Request):
        """The terminal ``serve.retire`` event: the request's queue,
        prefill and decode times and its TTFT, cut from its stamps."""
        if req.submit_time is None:
            return
        now = req.finish_time if req.finish_time is not None else time.perf_counter()
        adm = req.admit_time if req.admit_time is not None else now
        ft = req.first_token_time if req.first_token_time is not None else now
        _spans.event(
            "serve.retire", step=self._steps, req=req.id, trace=req.trace_id,
            status=req.status, tokens=len(req.generated),
            queue_us=round((adm - req.submit_time) * 1e6, 1),
            prefill_us=round(max(ft - adm, 0.0) * 1e6, 1),
            decode_us=round(max(now - ft, 0.0) * 1e6, 1),
            ttft_us=round(max(ft - req.submit_time, 0.0) * 1e6, 1))

    def _retire(self, lane: int, req: Request):
        req.status = DONE
        req.finished_step = self._steps
        req.finish_time = time.perf_counter()
        self._note_slo(req)
        if self._prefix is not None:
            # donate the lane's prefill-written blocks before their counts
            # drop: the cache retains them as they reach 0
            self._prefix.insert(req.prompt, self._kv.shard_of(lane),
                                self._kv.lane_blocks(lane))
        self._kv.free_lane(lane)
        self._sched.release(lane)
        self._c_completed.bump()
        self._trace_retire(req)

    def _evict(self, lane: int, status: str, error: str | None, reason: str):
        req = self._sched.lanes[lane]
        self._kv.free_lane(lane)
        self._sched.release(lane)
        if req is not None:
            req.status = status
            if error:
                req.error = error
            req.finished_step = self._steps
            req.finish_time = time.perf_counter()
            if status == FAILED:
                # a failed deadline-bearing request is an SLO outcome; a
                # caller's cancel is not
                self._note_slo(req)
            # the lane's time since admission is thrown-away work
            if req.admit_time is not None:
                busy_us = (time.perf_counter() - req.admit_time) * 1e6
                _goodput.note_loss("eviction", busy_us, site=f"serve.{reason}")
                _spans.event("serve.evict", step=self._steps, req=req.id, lane=lane,
                             fault=f"serve.{reason}", busy_us=round(busy_us, 1))
            self._trace_retire(req)
        _telemetry.counter("serve.evicted", reason=reason).bump()
