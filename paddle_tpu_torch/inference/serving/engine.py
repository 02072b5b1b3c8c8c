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

With ``weight_dtype="int8"`` every projection of decode and prefill goes
through the int8 weight-only kernel. Sharding, speculative decoding and
the prefix cache come with later slices of the port: their
``ServeConfig`` fields raise unless left at the default. Telemetry, spans,
chaos sites and autopilot knobs of the reference are left out;
:meth:`ServingEngine.stats` reports the host-side counts and the captures.
"""

from __future__ import annotations

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
from .request import (
    CANCELLED, DONE, FAILED, PREFILLING, RUNNING, WAITING, Request,
    SamplingParams,
)
from .sampling import sample_tokens
from .scheduler import Scheduler

__all__ = ["ServeConfig", "ServingEngine"]

#: fields served by later slices of the port: (default, what brings them)
_LATER = {
    "lane_shards": (1, "the sharding slice (serving/sharding.py)"),
    "weight_shards": (1, "the sharding slice (serving/sharding.py)"),
    "draft": (None, "the speculative-decoding slice (serving/speculative.py)"),
    "prefix_cache": (False, "the prefix-cache slice (serving/prefix_cache.py)"),
    "host_kv_blocks": (None, "the prefix-cache slice (serving/prefix_cache.py)"),
}


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
    draft: object | None = None
    prefix_cache: bool = False
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
        for name, (default, later) in _LATER.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"ServeConfig.{name}={value!r} comes with {later} of the "
                    f"PyTorch port; this slice serves {name}={default!r}")


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
    its two programs run as CUDA graphs; ``eager=True`` runs them eagerly
    instead, as the CPU always does.
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
        # the programs' own static inputs; the next-token ids are the host
        # mirror the scheduler edits
        lane_in = {"tok": np.zeros((L,), np.int64)}
        if cfg.sampling:
            lane_in.update(
                temp=np.ones((L,), np.float32), topk=np.zeros((L,), np.int32),
                topp=np.ones((L,), np.float32), do=np.zeros((L,), np.bool_),
                seed_keys=np.zeros((L, 2), np.int64), reseed=np.zeros((L,), np.bool_))
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
        self._decode_prog = _Program("decode", self._decode_fn, graphed)
        self._prefill_prog = _Program("prefill", self._prefill_fn, graphed)
        self._eos = -1 if cfg.eos_token_id is None else int(cfg.eos_token_id)
        self._requests: list = []
        self._next_id = 0
        self._steps = 0
        self._prefill_chunks = 0
        self._tokens = 0

    # -- the two programs --------------------------------------------------

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

    # -- public API --------------------------------------------------------

    def _validate(self, prompt, max_new_tokens: int, sampling) -> None:
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sampling is not None and not sampling.greedy and not self.config.sampling:
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
        emitted = self._decode()
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
        return {
            "steps": self._steps,
            "waiting": len(self._sched.waiting),
            "occupied_lanes": len(self._sched.occupied_lanes()),
            "free_blocks": self._kv.free_blocks,
            "requests": len(self._requests),
            "prefill_chunks": self._prefill_chunks,
            "tokens": self._tokens,
            "weight_dtype": self.config.weight_dtype,
            "device": str(self.device),
            "captures": {p.name: p.captures
                         for p in (self._decode_prog, self._prefill_prog)},
            "program_calls": {p.name: p.calls
                              for p in (self._decode_prog, self._prefill_prog)},
        }

    # -- scheduler phases --------------------------------------------------

    def _admit(self):
        def can(req, lane):
            return self._kv.can_admit(len(req.prompt) + req.max_new_tokens)

        for req, lane in self._sched.pick_admissions(can):
            total = len(req.prompt) + req.max_new_tokens
            if not self._kv.can_admit(total):
                # an earlier admission of this batch took the blocks the
                # probe counted on: requeue untouched
                self._sched.release(lane)
                self._sched.submit(req)
                continue
            self._kv.allocate_lane(lane, total)
            req.prefill_pos = 0
            req.status = PREFILLING
            req.admit_time = time.perf_counter()
            if self.config.sampling:
                self._seed_lane(lane, req)
            if len(req.prompt) == 1:
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
        h["reseed"][lane] = True
        self._samp_dirty = True

    def _activate(self, lane: int, req: Request):
        """Prompt prefilled: the lane joins the decode batch with the LAST
        prompt token as its next input, written at position
        len(prompt)-1 by its first decode step."""
        req.status = RUNNING
        self._kv.lengths[lane] = len(req.prompt) - 1
        self._lane_tok[lane] = req.prompt[-1]

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

    def _retire(self, lane: int, req: Request):
        req.status = DONE
        req.finished_step = self._steps
        req.finish_time = time.perf_counter()
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
