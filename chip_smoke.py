#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of numbers:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` (one nvcc per source,
   started together);
2. kernels: each kernel against its plain PyTorch version at serving
   shapes in bf16, with the stated tolerance, and timed (CUDA events,
   after warm-up, cycling through enough buffers to defeat the 50 MB L2)
   beside its bound, the plain version and one PyTorch library call;
3. bf16 engine: Llama-3-8B at full width, random weights from a seed,
   ``ServingEngine`` serving 10 requests on 8 lanes; every request must
   finish, the paged-attention kernel must have been launched, and one
   teacher-forced decode step through the kernel must agree with the
   same step through the plain attention;
4. int8 engine: the same trace with ``weight_dtype="int8"``; both kernels
   must have been launched; greedy agreement with phase 3 is printed.

Then the card's name and power limit again, one JSON line with every
kernel's numbers, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. ``--seed`` changes the
weights, the kernel inputs and the request trace.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20

# kernel vs plain, both on the same bf16 inputs:
# - paged attention: the plain version rounds the probabilities to bf16
#   before the weighted sum and the kernel keeps them in f32; outputs are
#   convex combinations of N(0, 1) rows, so 2^-8-relative rounding of
#   probabilities and the output gives well under 2e-2 absolute.
ATTN_ATOL = 2e-2
# - int8 GEMM: identical exact products, f32 sums in another order, then
#   one bf16 rounding: two bf16 steps (2^-7 relative) plus 1e-3 of the
#   output's largest magnitude for the summation order.
GEMM_RTOL = 2.0 ** -7
GEMM_ATOL_FRAC = 1e-3
# - teacher-forced decode step (phase 3): both paths round every layer's
#   activations to bf16 and differ only in the attention's rounding, which
#   32 layers carry to the logits. The kernel path must agree with the
#   plain path within 5% of the largest logit magnitude, or within twice
#   the distance, measured in the same run, between the plain path and
#   the same path with its attention computed in f32 (the bf16 rounding
#   band of the plain version itself).
LOGITS_TOL_FRAC = 0.05
LOGITS_NOISE_FACTOR = 2.0

# the serving trace: more requests than the 8 lanes, prompts of 16-600
# tokens (chunked prefill of 16), 32 new tokens each
REQUESTS = 10
NEW_TOKENS = 32

# Llama-3-8B decode shapes: (name, K, N, launches per decode step)
GEMM_SHAPES = (("q", 4096, 4096, 32), ("k", 4096, 1024, 32), ("v", 4096, 1024, 32),
               ("o", 4096, 4096, 32), ("gate", 4096, 14336, 32), ("up", 4096, 14336, 32),
               ("down", 14336, 4096, 32), ("lm_head", 4096, 128256, 1))


def say(phase: str, **nums):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def eager_ms(fn, n_bufs: int, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call issued eagerly from Python, host overhead
    included when the host issues slower than the card runs."""
    import torch

    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n_bufs: int, iters: int = 20, replays: int = 3) -> float:
    """Milliseconds of device time per call: ``iters`` calls (cycling
    through ``n_bufs`` input buffers) captured once in a CUDA graph and
    replayed, so the host's issue rate drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_bufs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_bufs)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_inputs(gen, lengths, layers=4, H=32, Hk=8, hd=128, bs=16, MB=64):
    """Pools of ``layers`` layers (cycled when timing, so that the working
    set exceeds L2), a fragmented block table and ragged lengths. Lane i
    sees slots 0..lengths[i]; a length-0 lane with an all-zero row stands
    for an inactive lane on trash block 0. Every slot no lane may see
    (the tail of a last page, table entries past the length, the rest of
    block 0) holds 100.0, so a kernel that read one would miss by far."""
    import torch

    lanes = len(lengths)
    need = [-(-(n + 1) // bs) for n in lengths]
    stale_pages = 4
    nb = 1 + sum(need) + stale_pages
    dev = "cuda"
    pk = torch.randn((layers, nb, bs, Hk, hd), generator=gen, device=dev).bfloat16()
    pv = torch.randn((layers, nb, bs, Hk, hd), generator=gen, device=dev).bfloat16()
    perm = torch.randperm(nb - 1 - stale_pages, generator=gen, device=dev) + 1 + stale_pages
    table = torch.zeros((lanes, MB), dtype=torch.int32, device=dev)
    pos = 0
    for b, n in enumerate(lengths):
        if n == 0 and b == 0:
            continue  # inactive lane: the whole row stays on trash block 0
        blocks = perm[pos:pos + need[b]]
        pos += need[b]
        table[b, :need[b]] = blocks.int()
        table[b, need[b]:] = 1 + (torch.arange(MB - need[b], device=dev) % stale_pages)
        last, tail = blocks[-1], (n + 1) % bs
        if tail:
            pk[:, last, tail:] = 100.0
            pv[:, last, tail:] = 100.0
    pk[:, 1:1 + stale_pages] = 100.0
    pv[:, 1:1 + stale_pages] = 100.0
    pk[:, 0, 1:] = 100.0
    pv[:, 0, 1:] = 100.0
    q = torch.randn((layers, lanes, H, hd), generator=gen, device=dev).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, table, ln


def check_attention(gen):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    results = {}
    for label, lengths in (("ragged", [0, 1, 17, 250, 511, 700, 1000, 1023]),
                           ("full", [1023] * 8)):
        q, pk, pv, table, ln = attention_inputs(gen, lengths)
        layers, lanes, H, hd = q.shape
        _, nb, bs, Hk, _ = pk.shape

        def kern(i):
            return pa.paged_decode_attention(q[i], pk[i], pv[i], table, ln)

        def plain(i):
            return pa.paged_decode_attention_ref(q[i], pk[i], pv[i], table, ln)

        err = max((kern(i).float() - plain(i).float()).abs().max().item()
                  for i in range(layers))
        torch.cuda.synchronize()
        if not err <= ATTN_ATOL:
            raise AssertionError(f"paged attention ({label}) differs from its "
                                 f"plain version by {err} > {ATTN_ATOL}")
        # yardstick: one SDPA call over the gathered window (gather not timed)
        S = table.shape[1] * bs
        kw = [pk[i][table.long()].reshape(lanes, S, Hk, hd).transpose(1, 2)
              for i in range(layers)]
        vw = [pv[i][table.long()].reshape(lanes, S, Hk, hd).transpose(1, 2)
              for i in range(layers)]
        mask = (torch.arange(S, device="cuda")[None, :] <= ln[:, None])[:, None, None, :]

        gqa = tuple(int(v) for v in torch.__version__.split(".")[:2]) >= (2, 5)
        if not gqa:  # older torch: expand the KV heads outside the timing
            kw = [k.repeat_interleave(H // Hk, dim=1) for k in kw]
            vw = [v.repeat_interleave(H // Hk, dim=1) for v in vw]
        extra = {"enable_gqa": True} if gqa else {}

        def library(i):
            return F.scaled_dot_product_attention(q[i][:, :, None, :], kw[i], vw[i],
                                                  attn_mask=mask, **extra)

        lib_err = max((library(i)[:, :, 0].float() - plain(i).float()).abs().max().item()
                      for i in range(layers))
        n_vis = [min(n + 1, table.shape[1] * bs) for n in lengths]
        nbytes = (lanes * H * hd * 2 * 2 + sum(n_vis) * Hk * hd * 2 * 2
                  + sum(-(-n // bs) for n in n_vis) * 4 + lanes * 4)
        flops = sum(n_vis) * H * hd * 4
        b_ms, b_by = bound_ms(nbytes, flops)
        ms = device_ms(kern, layers)
        plain_ms = device_ms(plain, layers)
        lib_ms = device_ms(library, layers)
        say("kernels", kernel="paged_attention", case=label, lengths=lengths,
            max_abs_err=err, tol=ATTN_ATOL, ms=round(ms, 5), bound_ms=round(b_ms, 5),
            bound_by=b_by, plain_ms=round(plain_ms, 5), library_ms=round(lib_ms, 5),
            eager_ms=round(eager_ms(kern, layers), 5), library_max_abs_err=lib_err,
            bytes=nbytes, GBps=round(nbytes / ms / 1e6, 1))
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return results["ragged"]


def check_int8(gen):
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bytes": 0.0, "flops": 0.0}
    max_err = 0.0
    for name, K, N, per_step in GEMM_SHAPES:
        n_bufs = max(1, min(8, math.ceil(3 * L2_BYTES / (K * N))))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(n_bufs)]
        ss = [torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(n_bufs)]
        for M in (1, 8, 16):
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()

            def kern(i):
                return qm.int8_matmul(x, ws[i], ss[i])

            def plain(i):
                return qm.int8_matmul_ref(x, ws[i], ss[i])

            def library(i):
                return torch.matmul(x, ws[i].to(torch.bfloat16)) * ss[i]

            out, ref = kern(0).float(), plain(0).float()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = GEMM_RTOL * ref.abs() + GEMM_ATOL_FRAC * ref.abs().max()
            if not bool(((out - ref).abs() <= tol).all()):
                raise AssertionError(f"int8 GEMM {name} M={M} differs from its plain "
                                     f"version: max abs err {err}")
            rel = err / max(ref.abs().max().item(), 1e-30)
            max_err = max(max_err, err)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            flops = 2 * M * K * N
            b_ms, b_by = bound_ms(nbytes, flops)
            ms = device_ms(kern, n_bufs)
            plain_ms = device_ms(plain, n_bufs, iters=5)
            lib_ms = device_ms(library, n_bufs, iters=5)
            say("kernels", kernel="int8_matmul", shape=name, M=M, K=K, N=N,
                max_abs_err=err, rel_err=rel, ms=round(ms, 5), bound_ms=round(b_ms, 5),
                bound_by=b_by, plain_ms=round(plain_ms, 5), library_ms=round(lib_ms, 5),
                eager_ms=round(eager_ms(kern, n_bufs), 5), GBps=round(nbytes / ms / 1e6, 1))
            if M == 8:  # the decode step at 8 lanes
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                                 ("library_ms", lib_ms), ("bytes", nbytes),
                                 ("flops", flops)):
                    total[key] += per_step * val
        del ws, ss
        torch.cuda.empty_cache()
    total["max_abs_err"] = max_err
    total["bound_by"] = bound_ms(total["bytes"], total["flops"])[1]
    say("kernels", kernel="int8_matmul", case="decode_step_M8_225_launches",
        ms=round(total["ms"], 5), bound_ms=round(total["bound_ms"], 5),
        plain_ms=round(total["plain_ms"], 5), library_ms=round(total["library_ms"], 5))
    return total


# ---------------------------------------------------------------------------
# phases 3-4: the serving engine
# ---------------------------------------------------------------------------


def trace(n_requests: int, seed: int, vocab: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, int(rng.randint(16, 601))).tolist()
            for _ in range(n_requests)]


def serve(engine, prompts, max_new: int, phase: str):
    """Submit every prompt at once and step until drained; returns the
    requests and the per-step wall times (each step ends synchronised)."""
    import torch

    reqs = [engine.submit(p, max_new) for p in prompts]
    steps = []
    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    while engine.pending():
        s0 = time.perf_counter()
        engine.step()
        sync()
        steps.append(time.perf_counter() - s0)
    wall = time.perf_counter() - t0
    bad = [r for r in reqs if r.status != "done" or len(r.generated) != max_new]
    if bad:
        raise AssertionError(f"{phase}: requests did not finish with {max_new} tokens: {bad}")
    ttft = sorted(r.first_token_time - r.submit_time for r in reqs)
    tokens = sum(len(r.generated) for r in reqs)
    say(phase, requests=len(reqs), tokens=tokens, wall_s=round(wall, 3),
        tok_s=round(tokens / wall, 2), steps=len(steps),
        step_ms_mean=round(1e3 * sum(steps) / len(steps), 3),
        step_ms_max=round(1e3 * max(steps), 3),
        ttft_ms_p50=round(1e3 * ttft[len(ttft) // 2], 2), ttft_ms_max=round(1e3 * ttft[-1], 2),
        prompt_tokens=sum(len(p) for p in prompts))
    return reqs


def profile_decode(engine, vocab: int, seed: int, phase: str):
    """Device busy share of decode-only steps: 8 one-token requests (no
    prefill), 3 warm-up steps, then 5 steps under torch.profiler. Busy time
    is the sum of the kernels' device intervals (one stream, so they do not
    overlap); the rest of the wall time the card waits for the host."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(seed + 1)
    reqs = [engine.submit([int(rng.randint(1, vocab))], 16)
            for _ in range(engine.config.num_lanes)]
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in reqs:
        engine.cancel(r)
    per_kernel: dict = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            launches += 1
    busy = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    say(phase, profiled_decode_steps=steps, step_ms=round(1e3 * wall / steps, 3),
        device_busy_ms_per_step=round(1e3 * busy / steps, 3),
        device_busy_share=round(busy / wall, 4) if busy else "not measured",
        device_ops_per_step=launches / steps)
    for name, us in top:
        print(f"  {phase} top kernel: {us / 1e3 / steps:.4f} ms/step {name[:90]}", flush=True)


def teacher_forced_check(engine, prompts):
    """Bring 8 fresh requests onto the lanes, then run ONE decode step of
    the engine's state twice, on copies of the page pool: through the
    kernel (PagedKVView) and through the plain attention. The logits must
    agree within LOGITS_TOL_FRAC of their largest magnitude."""
    import torch

    from paddle_tpu_torch.inference.serving import PagedKVView
    from paddle_tpu_torch.models.llama import decode_step
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention_ref

    class PlainView(PagedKVView):
        def attend(self, li, q):
            return paged_decode_attention_ref(q, self.pages_k[li], self.pages_v[li],
                                              self.block_table, self.lengths)

    class F32View(PagedKVView):
        def attend(self, li, q):
            return paged_decode_attention_ref(
                q.float(), self.pages_k[li].float(), self.pages_v[li].float(),
                self.block_table, self.lengths).to(q.dtype)

    reqs = [engine.submit(p[:64], 64) for p in prompts[:engine.config.num_lanes]]
    while not all(r.status == "running" for r in reqs):
        engine.step()
    kv = engine._kv
    kv.active[...] = False
    kv.active[[r.lane for r in reqs]] = True
    bt, ln, ac = kv.device_tables()
    tok = torch.tensor(engine._lane_tok, device=engine.device)
    bs = engine.config.block_size
    with torch.no_grad():
        logits = {}
        for name, view in (("kernel", PagedKVView), ("plain", PlainView),
                           ("f32", F32View)):
            pk, pv = kv.pages_k.clone(), kv.pages_v.clone()
            logits[name] = decode_step(engine.model.config, engine._w, tok,
                                       view(pk, pv, bt, ln, ac, bs), ln).float()
            del pk, pv
    for r in reqs:
        engine.cancel(r)
    def dist(a, b):
        return (logits[a] - logits[b]).abs().max().item()

    diff, noise = dist("kernel", "plain"), dist("plain", "f32")
    scale = logits["plain"].abs().max().item()
    tol = max(LOGITS_TOL_FRAC * scale, LOGITS_NOISE_FACTOR * noise)
    top1 = (logits["kernel"].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
    say("bf16-engine", teacher_forced_max_abs_diff=diff, logits_max_abs=scale,
        plain_vs_f32_attention=noise, kernel_vs_f32_attention=dist("kernel", "f32"),
        tol=tol, top1_agree=top1)
    if not diff <= tol:
        raise AssertionError(f"teacher-forced logits differ by {diff} > {tol}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no paddle_tpu_torch checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.quant_matmul import int8_matmul

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("setup", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(kind), count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build()
    say("setup", build_s=round(time.perf_counter() - t0, 2), built=sorted(logs))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    attn = check_attention(gen)
    gemm = check_int8(gen)

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    torch.cuda.synchronize()
    say("bf16-engine", model_init_s=round(time.perf_counter() - t0, 2),
        layers=cfg.num_hidden_layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size)
    serve_cfg = dict(num_lanes=8, block_size=16, max_seq_len=1024, prefill_chunk=16)
    prompts = trace(REQUESTS, args.seed, cfg.vocab_size)
    engine = ServingEngine(model, ServeConfig(**serve_cfg))
    paged_decode_attention.launches = 0
    int8_matmul.launches = 0
    bf16_reqs = serve(engine, prompts, NEW_TOKENS, "bf16-engine")
    attn_launches = paged_decode_attention.launches
    say("bf16-engine", paged_attention_launches=attn_launches,
        int8_matmul_launches=int8_matmul.launches)
    if attn_launches <= 0:
        raise AssertionError("the bf16 engine never launched the paged-attention kernel")
    teacher_forced_check(engine, prompts)
    profile_decode(engine, cfg.vocab_size, args.seed, "bf16-engine")
    del engine
    torch.cuda.empty_cache()

    engine = ServingEngine(model, ServeConfig(weight_dtype="int8", **serve_cfg))
    say("int8-engine", layers=model.config.num_hidden_layers,
        weight_bytes=sum(t.numel() * t.element_size() for lw in engine._w["layers"]
                         for leaf in lw.values()
                         for t in (leaf.values() if isinstance(leaf, dict) else (leaf,))))
    paged_decode_attention.launches = 0
    int8_matmul.launches = 0
    int8_reqs = serve(engine, prompts, NEW_TOKENS, "int8-engine")
    attn_launches_int8 = paged_decode_attention.launches
    gemm_launches = int8_matmul.launches
    agree = [a == b for r1, r2 in zip(bf16_reqs, int8_reqs)
             for a, b in zip(r1.generated, r2.generated)]
    say("int8-engine", paged_attention_launches=attn_launches_int8,
        int8_matmul_launches=gemm_launches,
        greedy_top1_agreement_vs_bf16=round(sum(agree) / len(agree), 4))
    if attn_launches_int8 <= 0 or gemm_launches <= 0:
        raise AssertionError("the int8 engine did not launch both kernels")
    profile_decode(engine, cfg.vocab_size, args.seed, "int8-engine")
    del engine, model
    torch.cuda.empty_cache()

    kernels = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:68",
         "launches": attn_launches, "max_abs_err": attn["max_abs_err"],
         "ms": attn["ms"], "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
         "at": "8 lanes, H32 Hk8 hd128 bs16 MB64, ragged lengths, bf16; launches "
               "from the bf16 engine run"},
        {"name": "int8_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:116",
         "launches": gemm_launches, "max_abs_err": gemm["max_abs_err"],
         "ms": gemm["ms"], "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
         "at": "sum over one Llama-3-8B decode step at M=8 (7 projections x 32 "
               "layers + lm_head); launches from the int8 engine run"},
    ]
    say("done", total_s=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
