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
   must have been launched; greedy agreement with phase 3 is printed;
5. training kernels, before any model is built: flash attention forward
   (out, lse) and backward (dQ, dK, dV, through torch autograd) against
   their plain versions in bf16 at S = 2048 (GQA 4, head_dim 128, causal),
   S = 1000 (ragged tail), head_dim 64 with 16/8 heads, one non-causal
   case and the training shape S = 8192, each 64-row tile held to its own
   norm, each small case run twice for bit-identical gradients; RMSNorm
   forward and backward dx at [8192, 4096] and a ragged N. Each is timed
   at the training shape (S = 8192, [8192, 4096]) beside its bound, its
   plain version and a PyTorch library yardstick the port never calls
   (``F.scaled_dot_product_attention``, ``F.rms_norm``);
6. one training step, kernels against plain: Llama-3-8B widths at 2
   layers, S = 2048, bf16, the same weights on both paths; the loss and
   every parameter's gradient agree within stated tolerances, then one
   ``TrainStep`` (AdamW) on each, whose losses and moments (m, v) agree;
7. training: Llama-3-8B widths at 4 layers, batch 1 x seq 8192 seeded
   tokens, bf16, ``AdamW(3e-4, weight_decay=0.1)`` with global-norm
   clipping in ``TrainStep``: one warm-up and three timed steps, finite
   losses, exact launch counts (flash forward and backward once per layer
   per step, RMSNorm forward and backward 2 L + 1 times), step time,
   tokens/s, model FLOPs share of bf16 peak, peak memory, and one profiled
   step's device-busy share;
8. fine-tuning kernels: the int8 GEMM's tensor-core forward (M > 64) and
   its dX against their plain versions in bf16 at the seven Llama-3-8B
   projection shapes with M = 8192 tokens and a ragged M = 1000, and
   SwiGLU forward and backward at [8192, 14336] and ragged sizes; each
   timed beside its bound, its plain version and a PyTorch yardstick;
9. one int8 fine-tuning step, kernels against plain: phase 6 with every
   projection swapped for a frozen int8 ``QuantizedLinear`` (the same int8
   weights and scales on both paths), the int8 forward and dX launched
   exactly 7 L times;
10. int8 fine-tuning: phase 7's run with the projections int8-frozen
   (embedding, norms and head trained): finite losses, exact launch counts
   (int8 forward and dX 7 L per step, flash and RMSNorm as in phase 7),
   step time, tokens/s, model FLOPs share, peak memory, trainable
   parameters, int8 weight bytes and one profiled step's device-busy share.

Then the card's name and power limit again, one JSON line with every
kernel's numbers (launches from the main path of its own phase: the
serving runs for the serving kernels, the three timed training steps for
the training kernels, the three timed fine-tuning steps for the int8
tensor-core kernels, and phase 8 for SwiGLU, which no model path calls),
and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. ``--seed`` changes the
weights, the kernel inputs and the request trace.
"""

from __future__ import annotations

import argparse
import contextlib
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

# - flash attention, kernel vs plain on the same bf16 inputs. out, dQ, dK
#   and dV are held tile by tile (``flash_attention.tile_errors``): over
#   each 64 rows of one (batch, head), ||got - want|| <= FLASH_TILE_RTOL
#   (||want|| + FLASH_TILE_FLOOR sqrt(n)) for the tile's n elements. The
#   limit scales with each tile's own norm, so that an error confined to
#   the late K tiles, the diagonal or the ragged tail, whose values are far
#   below the tensor's largest, fails as surely as one in the first tiles;
#   the floor (an RMS of 1e-5) only matters where a tile is f32 rounding
#   noise (dQ of a single row). The forward rounds the probabilities to
#   bf16 on both sides (the kernel against its running row maximum, the
#   plain version against the row's maximum, 2^-9 rms relative each) and
#   the output once: about 3e-3 of a tile's norm. The backward is given the
#   kernel forward's lse and delta on both sides, so it is held alone: P
#   and dS round at the same places from f32 values that differ by
#   summation order, then the results round once: about 1e-3. lse is f32
#   on both sides: 1e-3 absolute.
FLASH_TILE_RTOL, FLASH_TILE_FLOOR, FLASH_LSE_ATOL = 1e-2, 1e-5, 1e-3
FLASH_TILE = 64
# - RMSNorm: the same f32 arithmetic summed in another order, one rounding
#   to bf16: one bf16 step (2^-7 relative) plus 1e-3 of the largest output.
NORM_RTOL, NORM_ATOL_FRAC = 2.0 ** -7, 1e-3
# - one training step at 2 layers, kernels vs plain: bf16 activations
#   everywhere, the attention's probabilities rounded against different
#   maxima, carried through 2 layers and a 128256-way softmax: the loss
#   within 1e-2 relative, every parameter's gradient within 5e-2 of that
#   tensor's largest magnitude. After one TrainStep (AdamW), the moments
#   carry the clipped gradients at full scale: m = (1 - b1) g within the
#   gradient's limit of its tensor's largest |m|, v = (1 - b2) g^2 within
#   2 f + f^2 of its largest |v| (f the gradient's limit).
STEP_LOSS_RTOL, STEP_GRAD_FRAC = 1e-2, 5e-2
# - SwiGLU: the same f32 formula (the sigmoid from two exp routines, a few
#   f32 ulps apart), one rounding to bf16: one bf16 step (2^-7 relative)
#   plus 1e-3 of the largest output.
SWIGLU_RTOL, SWIGLU_ATOL_FRAC = 2.0 ** -7, 1e-3
# - the int8 tensor-core forward and dX: GEMM_RTOL and GEMM_ATOL_FRAC above.
#   Both sides take the same exact products (dX: the same bf16-rounded
#   dO * bf16(s)) and differ only in summation order; the plain versions'
#   f32 products stay full f32 (TF32 off, checked).

# the serving trace: more requests than the 8 lanes, prompts of 16-600
# tokens (chunked prefill of 16), 32 new tokens each
REQUESTS = 10
NEW_TOKENS = 32

# training: (label, B, S, H, Hk, head_dim, causal) of the kernel checks;
# the training shape of the timing, the 2-layer check and the 4-layer run
FLASH_CASES = (("s2048", 1, 2048, 32, 8, 128, True),
               ("s1000_ragged", 1, 1000, 32, 8, 128, True),
               ("s2048_hd64_h16_hk8", 1, 2048, 16, 8, 64, True),
               ("s2048_noncausal", 1, 2048, 32, 8, 128, False))
NORM_CASES = ((8192, 4096), (1000, 4096), (37, 4096))
TRAIN_SEQ = 8192
TRAIN_LAYERS = 4
TRAIN_STEPS = 3
CHECK_SEQ = 2048
CHECK_LAYERS = 2
LR = 3e-4

# int8 fine-tuning: the kernel checks' token counts (the training shape and a
# ragged one), and SwiGLU's cases [N, H]
INT8_TRAIN_M = (TRAIN_SEQ, 1000)
SWIGLU_CASES = ((TRAIN_SEQ, 14336), (1000, 14336), (37, 1001))

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


# device kernels of a training step by kind: (kind, name substrings)
KERNEL_KINDS = (("flash attention (port)", ("flash_fwd_kernel", "flash_bwd_")),
                ("rms norm (port)", ("rms_fwd_kernel", "rms_bwd_dx_kernel")),
                ("int8 forward (port)", ("int8_fwd_mma_kernel", "int8_gemm_kernel")),
                ("int8 dX (port)", ("int8_dx_mma_kernel",)),
                ("swiglu (port)", ("swiglu_fwd_kernel", "swiglu_bwd_kernel")),
                ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                ("softmax / cross entropy", ("softmax", "nll_loss", "log_softmax")),
                ("reductions", ("reduce_kernel",)),
                ("copies and casts", ("copy",)),
                ("elementwise", ("elementwise",)),
                ("index / scatter / gather", ("index", "scatter", "gather")))


def by_kind(per_kernel: dict) -> dict:
    """Device milliseconds per KERNEL_KINDS entry (names matched without
    case; "other" for the rest)."""
    out: dict = {}
    for name, us in per_kernel.items():
        low = name.lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(sub.lower() in low for sub in subs)),
                    "other")
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return {k: round(v, 3) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def kernel_times(prof) -> tuple[dict, int]:
    """({kernel name: device microseconds}, device operations) of a
    torch.profiler run."""
    import torch

    per_kernel: dict = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            launches += 1
    return per_kernel, launches


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
    per_kernel, launches = kernel_times(prof)
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


# ---------------------------------------------------------------------------
# phase 5: training kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_inputs(gen, B, S, H, Hk, hd):
    import torch

    def draw(heads):
        return torch.randn((B, S, heads, hd), generator=gen, device="cuda").bfloat16()

    return draw(H), draw(Hk), draw(Hk), draw(H)


def flash_counts(causal: bool, B, S, H, Hk, hd):
    """(bytes, forward FLOPs, backward FLOPs) of one call: every input read
    once and every output written once; 4 FLOPs per (query, key, dim) pair
    the mask keeps in the forward (two products), 10 in the backward (five
    products)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    qo, kv, stats = B * S * H * hd * 2, B * S * Hk * hd * 2, B * H * S * 4
    fwd_bytes = 2 * qo + 2 * kv + stats                   # q k v in; o lse out
    bwd_bytes = 3 * qo + 4 * kv + 2 * stats               # q k v dO lse delta in; dq dk dv out
    return fwd_bytes, bwd_bytes, 4 * pairs * B * H * hd, 10 * pairs * B * H * hd


def hold_flash(label, fwd, ref_fwd, grads, ref_grads) -> dict:
    """Hold the kernels' (out, lse) and (dq, dk, dv) against the plain
    versions'; raise past the limits. Returns the errors."""
    from paddle_tpu_torch.ops.flash_attention import tile_errors

    def tile_err(got, want):
        return tile_errors(got, want, FLASH_TILE, FLASH_TILE_FLOOR)

    (out, lse), (ref_out, ref_lse) = fwd, ref_fwd
    out_tile, out_err = tile_err(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    if not (out_tile <= FLASH_TILE_RTOL and lse_err <= FLASH_LSE_ATOL):
        raise AssertionError(f"flash forward ({label}) differs from its plain version: out "
                             f"{out_tile} of a tile's norm (tol {FLASH_TILE_RTOL}), lse "
                             f"{lse_err} (tol {FLASH_LSE_ATOL})")
    errs = [tile_err(g, w) for g, w in zip(grads, ref_grads)]
    if not all(t <= FLASH_TILE_RTOL for t, _ in errs):
        raise AssertionError(f"flash backward ({label}) differs from its plain version: "
                             f"dq/dk/dv {[t for t, _ in errs]} of a tile's norm "
                             f"(tol {FLASH_TILE_RTOL})")
    return {"out_err": out_err, "out_tile_err": out_tile, "lse_err": lse_err,
            "dq_dk_dv_err": [e for _, e in errs], "dq_dk_dv_tile_err": [t for t, _ in errs],
            "fwd_err": out_err, "bwd_err": max(e for _, e in errs)}


def check_flash(gen):
    """Every case: forward and backward through torch autograd twice
    (bit-identical), against the plain versions, the backward on the
    kernel forward's lse and delta; then the timing and the same checks at
    the training shape. Returns the forward's and the backward's numbers."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    for label, B, S, H, Hk, hd, causal in FLASH_CASES:
        q, k, v, do = flash_inputs(gen, B, S, H, Hk, hd)
        runs = []
        for _ in range(2):
            qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            out = fa.flash_attention(qs, ks, vs, causal)
            out.backward(do)
            runs.append((out.detach(), qs.grad, ks.grad, vs.grad))
        out_k, lse_k = fa.flash_attention_fwd(q, k, v, causal)
        ref_fwd = fa.flash_attention_fwd_ref(q, k, v, causal)
        # delta as the autograd op computes it from the kernel's output
        delta_k = (do.float() * out_k.float()).sum(-1).transpose(1, 2).contiguous()
        ref_grads = fa.flash_attention_bwd_ref(q, k, v, do, lse_k, delta_k, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"flash attention ({label}) is not deterministic")
        if not torch.equal(out_k, runs[0][0]):
            raise AssertionError(f"flash attention ({label}): the autograd op's output "
                                 "differs from the forward kernel's")
        errs = hold_flash(label, (out_k, lse_k), ref_fwd, runs[0][1:], ref_grads)
        nums = dict(case=label, B=B, S=S, H=H, Hk=Hk, hd=hd, causal=causal,
                    **{k_: v_ for k_, v_ in errs.items() if k_ not in ("fwd_err", "bwd_err")},
                    bit_identical_grads=True)
        if label == "s2048":
            fwd_b, bwd_b, fwd_f, bwd_f = flash_counts(causal, B, S, H, Hk, hd)
            nums.update(
                ms_fwd=round(device_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 1, 10), 5),
                plain_ms_fwd=round(eager_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v, causal),
                                            1, 5, 1), 5),
                ms_bwd=round(device_ms(lambda i: fa.flash_attention_bwd(
                    q, k, v, do, lse_k, delta_k, causal), 1, 10), 5),
                plain_ms_bwd=round(eager_ms(lambda i: fa.flash_attention_bwd_ref(
                    q, k, v, do, lse_k, delta_k, causal), 1, 5, 1), 5),
                bound_ms_fwd=round(bound_ms(fwd_b, fwd_f)[0], 5),
                bound_ms_bwd=round(bound_ms(bwd_b, bwd_f)[0], 5))
        say("train-kernels", kernel="flash_attention", **nums)
        del q, k, v, do, runs, ref_grads, ref_fwd
        torch.cuda.empty_cache()
    return time_flash(gen)


def time_flash(gen):
    """The kernels at the training shape (B 1, S 8192, H 32, Hk 8, hd 128,
    causal) on the card, the plain versions on the same inputs (one call
    per KV-head group, 4 query heads each, so that the S x S scores fit),
    the kernels held against them, and the library yardstick: SDPA
    forward, and its backward alone (``torch.autograd.grad`` of one
    forward kept alive)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, Hk, hd = 1, TRAIN_SEQ, 32, 8, 128
    rep = H // Hk
    q, k, v, do = flash_inputs(gen, B, S, H, Hk, hd)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, True)

    def plain_fwd(i):
        return [fa.flash_attention_fwd_ref(q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1],
                                           v[:, :, g:g + 1], True) for g in range(Hk)]

    def plain_bwd(i):
        hs = [slice(g * rep, (g + 1) * rep) for g in range(Hk)]
        return [fa.flash_attention_bwd_ref(q[:, :, hs[g]], k[:, :, g:g + 1], v[:, :, g:g + 1],
                                           do[:, :, hs[g]], lse[:, hs[g]], delta[:, hs[g]],
                                           True) for g in range(Hk)]

    outs, lses = zip(*plain_fwd(0))
    errs = hold_flash("training_shape", (out, lse), (torch.cat(outs, 2), torch.cat(lses, 1)),
                      grads, [torch.cat(t, 2) for t in zip(*plain_bwd(0))])
    del outs, lses, grads
    ms_fwd = device_ms(lambda i: fa.flash_attention_fwd(q, k, v, True), 1, 5)
    ms_bwd = device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta, True), 1, 5)
    plain_fwd_ms = eager_ms(plain_fwd, 1, 2, 1)
    plain_bwd_ms = eager_ms(plain_bwd, 1, 2, 1)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))

    def lib_fwd(i):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_fwd_ms = device_ms(lib_fwd, 1, 5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd_ms = eager_ms(lambda i: torch.autograd.grad(lib_out, (ql, kl, vl), dot,
                                                        retain_graph=True), 1, 5, 2)

    def lib_fwd_bwd(i):
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (ql, kl, vl), dot)

    lib_fwd_bwd_ms = eager_ms(lib_fwd_bwd, 1, 5, 2)
    fwd_b, bwd_b, fwd_f, bwd_f = flash_counts(True, B, S, H, Hk, hd)
    bf, byf = bound_ms(fwd_b, fwd_f)
    bb, byb = bound_ms(bwd_b, bwd_f)
    say("train-kernels", kernel="flash_attention", case="training_shape", B=B, S=S, H=H,
        Hk=Hk, hd=hd, causal=True,
        **{k_: v_ for k_, v_ in errs.items() if k_ not in ("fwd_err", "bwd_err")},
        ms_fwd=round(ms_fwd, 5), bound_ms_fwd=round(bf, 5),
        plain_ms_fwd=round(plain_fwd_ms, 5), library_ms_fwd=round(lib_fwd_ms, 5),
        ms_bwd=round(ms_bwd, 5), bound_ms_bwd=round(bb, 5), plain_ms_bwd=round(plain_bwd_ms, 5),
        library_ms_bwd=round(lib_bwd_ms, 5), library_ms_fwd_bwd=round(lib_fwd_bwd_ms, 5),
        TFLOPs_fwd=round(fwd_f / ms_fwd / 1e9, 1), TFLOPs_bwd=round(bwd_f / ms_bwd / 1e9, 1))
    del q, k, v, do, out, lse, delta, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    at = (f"B1 S{S} H{H} Hk{Hk} hd{hd} causal bf16, max_abs_err and tile_err at this "
          f"shape; plain version in {Hk} calls of one KV-head group each")
    return ({"max_abs_err": errs["fwd_err"], "tile_err": errs["out_tile_err"], "ms": ms_fwd,
             "plain_ms": plain_fwd_ms, "bound_ms": bf, "bound_by": byf, "library_ms": lib_fwd_ms,
             "at": at + "; library: F.scaled_dot_product_attention(is_causal, enable_gqa)"},
            {"max_abs_err": errs["bwd_err"], "tile_err": max(errs["dq_dk_dv_tile_err"]),
             "ms": ms_bwd, "plain_ms": plain_bwd_ms, "bound_ms": bb, "bound_by": byb,
             "library_ms": lib_bwd_ms,
             "at": at + "; library: torch.autograd.grad through SDPA's forward (eager)"})


def check_rms_norm(gen):
    """Forward and backward dx against the plain versions at every case;
    the timing at [8192, 4096] (three buffers cycled to defeat L2)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_norm as fn

    eps = 1e-5
    err_fwd = err_bwd = 0.0
    res = {}
    for N, H in NORM_CASES:
        n_bufs = 3 if N * H * 2 > L2_BYTES // 4 else 1
        xs = [(torch.randn((N, H), generator=gen, device="cuda") * 3).bfloat16()
              for _ in range(n_bufs)]
        dos = [torch.randn((N, H), generator=gen, device="cuda").bfloat16()
               for _ in range(n_bufs)]
        w = (torch.rand((H,), generator=gen, device="cuda") + 0.5).bfloat16()
        out, inv = fn.rms_norm_fwd(xs[0], w, eps)
        ref_out, ref_inv = fn.rms_norm_fwd_ref(xs[0], w, eps)
        dx = fn.rms_norm_bwd_dx(xs[0], w, inv, dos[0])
        ref_dx = fn.rms_norm_bwd_dx_ref(xs[0], w, ref_inv, dos[0])
        torch.cuda.synchronize()
        errs = []
        for got, want, name in ((out, ref_out, "forward"), (dx, ref_dx, "backward dx")):
            diff = (got.float() - want.float()).abs()
            tol = NORM_RTOL * want.float().abs() + NORM_ATOL_FRAC * want.float().abs().max()
            if not bool((diff <= tol).all()):
                raise AssertionError(f"RMSNorm {name} [{N}, {H}] differs from its plain "
                                     f"version: max abs err {diff.max().item()}")
            errs.append(diff.max().item())
        if not torch.allclose(inv, ref_inv, rtol=1e-5, atol=0):
            raise AssertionError(f"RMSNorm inv [{N}, {H}] differs from its plain version")
        err_fwd, err_bwd = max(err_fwd, errs[0]), max(err_bwd, errs[1])
        nums = dict(N=N, H=H, fwd_err=errs[0], dx_err=errs[1])
        if (N, H) == NORM_CASES[0]:
            invs = [fn.rms_norm_fwd(x, w, eps)[1] for x in xs]
            row = N * H * 2
            fwd_bytes, bwd_bytes = 2 * row + H * 2 + N * 4, 3 * row + H * 2 + N * 4
            fwd_flops, bwd_flops = 4 * N * H, 8 * N * H
            lib_bwd = None
            if hasattr(torch.ops.aten, "_fused_rms_norm_backward"):
                rstds = [torch.ops.aten._fused_rms_norm(x, [H], w, eps)[1] for x in xs]

                def lib_bwd(i):
                    return torch.ops.aten._fused_rms_norm_backward(
                        dos[i], xs[i], [H], rstds[i], w, [True, False])

            res["fwd"] = {
                "max_abs_err": 0.0,
                "ms": device_ms(lambda i: fn.rms_norm_fwd(xs[i], w, eps), n_bufs),
                "plain_ms": device_ms(lambda i: fn.rms_norm_fwd_ref(xs[i], w, eps), n_bufs),
                "library_ms": device_ms(lambda i: F.rms_norm(xs[i], (H,), w, eps), n_bufs),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(fwd_bytes, fwd_flops))),
                "at": f"[{N}, {H}] bf16; library: torch.nn.functional.rms_norm"}
            res["bwd"] = {
                "max_abs_err": 0.0,
                "ms": device_ms(lambda i: fn.rms_norm_bwd_dx(xs[i], w, invs[i], dos[i]), n_bufs),
                "plain_ms": device_ms(lambda i: fn.rms_norm_bwd_dx_ref(xs[i], w, invs[i], dos[i]),
                                      n_bufs),
                "library_ms": None if lib_bwd is None else device_ms(lib_bwd, n_bufs),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(bwd_bytes, bwd_flops))),
                "at": f"[{N}, {H}] bf16; library: torch.ops.aten._fused_rms_norm_backward "
                      "(dx only)"}
            for key in ("fwd", "bwd"):
                nums.update({f"{k}_{key}": (round(v, 5) if isinstance(v, float) else v)
                             for k, v in res[key].items()
                             if k in ("ms", "plain_ms", "library_ms", "bound_ms")})
        say("train-kernels", kernel="rms_norm", **nums)
        del xs, dos
        torch.cuda.empty_cache()
    res["fwd"]["max_abs_err"], res["bwd"]["max_abs_err"] = err_fwd, err_bwd
    return res["fwd"], res["bwd"]


# ---------------------------------------------------------------------------
# phase 8: fine-tuning kernels against their plain versions
# ---------------------------------------------------------------------------


def hold_gemm(label, got, want) -> float:
    """The int8 GEMM limit of phase 2 elementwise; returns the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = GEMM_RTOL * want.abs() + GEMM_ATOL_FRAC * want.abs().max()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"{label} differs from its plain version: max abs err "
                             f"{diff.max().item()}")
    return diff.max().item()


def check_int8_train(gen):
    """The tensor-core forward and dX at the seven projection shapes of one
    Llama-3-8B layer, M = 8192 tokens and a ragged M, against the plain
    versions; timed at M = 8192 beside the bound, the plain version and the
    cuBLAS yardstick (``torch.matmul`` on the weights cast to bf16). Returns
    the sums over one layer's seven projections."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    tf32 = torch.backends.cuda.matmul.allow_tf32
    say("int8-kernels", allow_tf32=tf32)
    if tf32:
        raise AssertionError("TF32 matmuls are on: the plain versions would not be full f32")
    res = {key: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                 "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0} for key in ("fwd", "dx")}
    for name, K, N, _ in GEMM_SHAPES[:7]:
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        for M in INT8_TRAIN_M:
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            do = torch.randn((M, N), generator=gen, device="cuda").bfloat16()
            calls = {
                "fwd": (lambda i: qm.int8_matmul_large_m(x, w, s),
                        lambda i: qm.int8_matmul_ref(x, w, s),
                        lambda i: torch.matmul(x, w.to(torch.bfloat16)) * s,
                        M * K * 2 + K * N + N * 4 + M * N * 2),
                "dx": (lambda i: qm.int8_matmul_dx(do, w, s),
                       lambda i: qm.int8_matmul_dx_ref(do, w, s),
                       lambda i: torch.matmul(do * s.bfloat16(), w.to(torch.bfloat16).T),
                       M * N * 2 + K * N + N * 4 + M * K * 2)}
            nums = {}
            for key, (kern, plain, library, nbytes) in calls.items():
                err = hold_gemm(f"int8 {key} {name} M={M}", kern(0), plain(0))
                torch.cuda.synchronize()
                r = res[key]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                nums[f"{key}_err"] = err
                if M != TRAIN_SEQ:
                    continue
                flops = 2 * M * K * N
                b_ms, _ = bound_ms(nbytes, flops)
                ms = device_ms(kern, 1, 10)
                plain_ms = device_ms(plain, 1, 2, 1)
                lib_ms = device_ms(library, 1, 5)
                for k_, v_ in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                               ("library_ms", lib_ms), ("bytes", nbytes), ("flops", flops)):
                    r[k_] += v_
                nums.update({f"{key}_ms": round(ms, 5), f"{key}_bound_ms": round(b_ms, 5),
                             f"{key}_plain_ms": round(plain_ms, 5),
                             f"{key}_library_ms": round(lib_ms, 5),
                             f"{key}_TFLOPs": round(flops / ms / 1e9, 1)})
            say("int8-kernels", shape=name, M=M, K=K, N=N, **nums)
            del x, do
        del w, s
        torch.cuda.empty_cache()
    for key, wrapper in (("fwd", "int8_matmul_large_m"), ("dx", "int8_matmul_dx")):
        r = res[key]
        r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("flops"))[1]
        r["at"] = (f"sum over the seven projections of one Llama-3-8B layer at M={TRAIN_SEQ} "
                   "tokens, bf16 (max_abs_err also over M=1000); library: torch.matmul on "
                   "the weights cast to bf16" + (" and dO * bf16(s)" if key == "dx" else ""))
        say("int8-kernels", kernel=wrapper, case="one_layer_M8192",
            **{k_: (round(v_, 5) if isinstance(v_, float) else v_) for k_, v_ in r.items()
               if k_ != "at"})
    return res["fwd"], res["dx"]


def check_swiglu(gen):
    """SwiGLU forward and backward against the plain versions at every case,
    timed at [8192, 14336]. No single PyTorch call computes either: the
    yardstick is ``F.silu(a) * b`` (two calls) and its autograd backward.
    Returns the numbers and the launches of this phase."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_norm as fn

    fn.swiglu_fwd.launches = fn.swiglu_bwd.launches = 0
    res = {}
    err_fwd = err_bwd = 0.0
    for N, H in SWIGLU_CASES:
        a = (torch.randn((N, H), generator=gen, device="cuda") * 3).bfloat16()
        b = torch.randn((N, H), generator=gen, device="cuda").bfloat16()
        do = torch.randn((N, H), generator=gen, device="cuda").bfloat16()
        pairs = ((fn.swiglu_fwd(a, b), fn.swiglu_fwd_ref(a, b), "forward"),
                 *zip(fn.swiglu_bwd(a, b, do), fn.swiglu_bwd_ref(a, b, do), ("da", "db")))
        torch.cuda.synchronize()
        errs = []
        for got, want, what in pairs:
            diff = (got.float() - want.float()).abs()
            tol = SWIGLU_RTOL * want.float().abs() + SWIGLU_ATOL_FRAC * want.float().abs().max()
            if not bool((diff <= tol).all()):
                raise AssertionError(f"SwiGLU {what} [{N}, {H}] differs from its plain "
                                     f"version: max abs err {diff.max().item()}")
            errs.append(diff.max().item())
        err_fwd, err_bwd = max(err_fwd, errs[0]), max(err_bwd, *errs[1:])
        nums = dict(N=N, H=H, fwd_err=errs[0], da_err=errs[1], db_err=errs[2])
        if (N, H) == SWIGLU_CASES[0]:
            al = a.detach().requires_grad_(True)
            bl = b.detach().requires_grad_(True)
            lib_out = F.silu(al) * bl
            n = N * H
            res["fwd"] = {
                "ms": device_ms(lambda i: fn.swiglu_fwd(a, b), 1),
                "plain_ms": device_ms(lambda i: fn.swiglu_fwd_ref(a, b), 1, 5),
                "library_ms": device_ms(lambda i: F.silu(a) * b, 1),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(3 * n * 2, 6 * n))),
                "at": f"[{N}, {H}] bf16; library: F.silu(a) * b, two PyTorch calls; "
                      "launches from the kernel checks (no model path calls it)"}
            res["bwd"] = {
                "ms": device_ms(lambda i: fn.swiglu_bwd(a, b, do), 1),
                "plain_ms": device_ms(lambda i: fn.swiglu_bwd_ref(a, b, do), 1, 5),
                "library_ms": eager_ms(lambda i: torch.autograd.grad(
                    lib_out, (al, bl), do, retain_graph=True), 1, 10, 2),
                **dict(zip(("bound_ms", "bound_by"), bound_ms(5 * n * 2, 12 * n))),
                "at": f"[{N}, {H}] bf16; library: torch.autograd.grad through "
                      "F.silu(a) * b (eager, its two backward calls); launches from the "
                      "kernel checks (no model path calls it)"}
            for key in ("fwd", "bwd"):
                nums.update({f"{k}_{key}": (round(v, 5) if isinstance(v, float) else v)
                             for k, v in res[key].items()
                             if k in ("ms", "plain_ms", "library_ms", "bound_ms")})
            del al, bl, lib_out
        say("int8-kernels", kernel="swiglu", **nums)
        del a, b, do, pairs
        torch.cuda.empty_cache()
    res["fwd"]["max_abs_err"], res["bwd"]["max_abs_err"] = err_fwd, err_bwd
    return res["fwd"], res["bwd"], {"swiglu_fwd": fn.swiglu_fwd.launches,
                                    "swiglu_bwd": fn.swiglu_bwd.launches}


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

def training_wrappers() -> dict:
    """{name: the kernel wrapper} of the training and fine-tuning kernels
    (the int8 weight stream too, which a training step must not launch)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import quant_matmul as qm

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rms_norm_fwd": fn.rms_norm_fwd, "rms_norm_bwd_dx": fn.rms_norm_bwd_dx,
            "int8_matmul": qm.int8_matmul, "int8_matmul_large_m": qm.int8_matmul_large_m,
            "int8_matmul_dx": qm.int8_matmul_dx}


def expected_launches(layers: int, int8: bool = False) -> dict:
    """Per training step: flash forward and backward once per layer,
    RMSNorm forward and backward twice per layer and once for the final
    norm; with int8-frozen projections, the tensor-core forward and dX
    once per projection (7 per layer), and never the weight stream."""
    proj = 7 * layers if int8 else 0
    return {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "rms_norm_fwd": 2 * layers + 1, "rms_norm_bwd_dx": 2 * layers + 1,
            "int8_matmul": 0, "int8_matmul_large_m": proj, "int8_matmul_dx": proj}


def quantize_projections(model):
    """Swap every projection of a Llama for a frozen int8 ``QuantizedLinear``
    (the fine-tuning recipe: the embedding, the norms and the head stay
    trainable). Returns the number swapped."""
    from paddle_tpu_torch.nn.quant import QuantizedLinear

    n = 0
    for lyr in model.llama.layers:
        for block, names in ((lyr.self_attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                             (lyr.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                setattr(block, name, QuantizedLinear(getattr(block, name)))
                n += 1
    return n


@contextlib.contextmanager
def plain_kernels():
    """Route the training ops' autograd functions to the plain versions for
    the reference path of phases 6 and 9. The package has no such switch: a
    CUDA tensor always reaches the kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import quant_matmul as qm

    swaps = ((fa, "flash_attention_fwd", fa.flash_attention_fwd_ref),
             (fa, "flash_attention_bwd", fa.flash_attention_bwd_ref),
             (fn, "rms_norm_fwd", fn.rms_norm_fwd_ref),
             (fn, "rms_norm_bwd_dx", fn.rms_norm_bwd_dx_ref),
             (qm, "int8_matmul", qm.int8_matmul_ref),
             (qm, "int8_matmul_dx", qm.int8_matmul_dx_ref))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)


def token_batch(rng, seq: int, vocab: int):
    """(input_ids, labels) [1, seq] int64 on the card: seeded tokens and the
    next token of each."""
    import torch

    toks = torch.from_numpy(rng.randint(0, vocab, (1, seq + 1)).astype("int64")).cuda()
    return toks[:, :-1], toks[:, 1:]


def make_train_step(model):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, lambda x, y: model(x, labels=y)[0])


def check_train_step(seed: int, int8: bool = False):
    """Phase 6 (phase 9 with ``int8``: every projection int8-frozen): the
    same 2-layer model and batch through the kernels and through the plain
    versions."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    phase = "int8-step-check" if int8 else "train-step-check"
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS)
    kern = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    plain = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed + 1)
    if int8:
        quantize_projections(kern)
        quantize_projections(plain)
    plain.load_state_dict(kern.state_dict())
    ids, labels = token_batch(np.random.RandomState(seed + 2), CHECK_SEQ, cfg.vocab_size)
    wrappers = training_wrappers()
    results = {}
    for name, model in (("kernel", kern), ("plain", plain)):
        before = {k: w.launches for k, w in wrappers.items()}
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            loss, _ = model(ids, labels=labels)
            loss.backward()
        torch.cuda.synchronize()
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        want = (expected_launches(CHECK_LAYERS, int8) if name == "kernel"
                else dict.fromkeys(wrappers, 0))
        if launched != want:
            raise AssertionError(f"{name} path launched {launched}, expected {want}")
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        results[name] = (loss.item(), grads)
    (loss_k, grads_k), (loss_p, grads_p) = results["kernel"], results["plain"]
    worst = (0.0, "")
    for n, gp in grads_p.items():
        gk = grads_k[n]
        frac = ((gk.float() - gp.float()).abs().max() / gp.float().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (frac, n))
        if not (math.isfinite(frac) and frac <= STEP_GRAD_FRAC):
            raise AssertionError(f"gradient of {n}: kernel and plain paths differ by {frac} of "
                                 f"its largest magnitude (tol {STEP_GRAD_FRAC})")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not loss_rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"loss: kernel path {loss_k}, plain path {loss_p}")
    n_trainable = len(grads_p)
    del grads_k, grads_p, results
    steps, losses = {}, {}
    for name, model in (("kernel", kern), ("plain", plain)):
        steps[name] = make_train_step(model)
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            losses[name] = steps[name](ids, labels).item()
    torch.cuda.synchronize()
    if not abs(losses["kernel"] - losses["plain"]) <= STEP_LOSS_RTOL * abs(losses["plain"]):
        raise AssertionError(f"TrainStep losses differ: {losses}")
    # the state is in named_parameters() order on both
    tols = {"m": STEP_GRAD_FRAC, "v": 2 * STEP_GRAD_FRAC + STEP_GRAD_FRAC ** 2}
    moment_worst = dict.fromkeys(tols, 0.0)
    for (n, _), sk, sp in zip(kern.named_parameters(), steps["kernel"]._opt_state,
                              steps["plain"]._opt_state):
        for key, tol in tols.items():
            want = sp[key].float()
            frac = ((sk[key].float() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30)).item()
            moment_worst[key] = max(moment_worst[key], frac)
            if not (math.isfinite(frac) and frac <= tol):
                raise AssertionError(f"after one TrainStep, AdamW's {key} of {n} differs by "
                                     f"{frac} of its largest magnitude (tol {tol})")
    say(phase, layers=CHECK_LAYERS, seq=CHECK_SEQ, trainable=n_trainable, loss_kernel=loss_k,
        loss_plain=loss_p, loss_rel_diff=loss_rel, loss_tol=STEP_LOSS_RTOL,
        worst_grad_frac=worst[0], worst_grad=worst[1], grad_tol=STEP_GRAD_FRAC,
        trainstep_loss_kernel=losses["kernel"], trainstep_loss_plain=losses["plain"],
        worst_m_frac=moment_worst["m"], m_tol=tols["m"], worst_v_frac=moment_worst["v"],
        v_tol=tols["v"])
    del kern, plain, steps
    torch.cuda.empty_cache()


def train(seed: int, int8: bool = False) -> dict:
    """Phase 7 (phase 10 with ``int8``: every projection int8-frozen, the
    embedding, norms and head trained): the 4-layer run. Returns the launch
    counts of the three timed steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import QuantizedLinear

    phase = "finetune" if int8 else "train"
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    extra = {}
    if int8:
        quantize_projections(model)
        frozen = [m for m in model.modules() if isinstance(m, QuantizedLinear)]
        extra = dict(int8_projections=len(frozen),
                     int8_weight_bytes=sum(m.weight.numel() for m in frozen),
                     scale_bytes=sum(4 * m.weight_scale.numel() for m in frozen))
    torch.cuda.synchronize()
    n_params = model.num_params()
    n_embed = model.llama.embed_tokens.weight.numel()
    say(phase, layers=TRAIN_LAYERS, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        seq=TRAIN_SEQ, trainable_params=n_params, **extra,
        model_init_s=round(time.perf_counter() - t0, 2))
    step = make_train_step(model)
    rng = np.random.RandomState(seed + 3)
    wrappers = training_wrappers()
    per_step = expected_launches(TRAIN_LAYERS, int8)

    def run(n_steps):
        for w in wrappers.values():
            w.launches = 0
        losses, times = [], []
        for _ in range(n_steps):
            ids, labels = token_batch(rng, TRAIN_SEQ, cfg.vocab_size)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
        counts = {k: w.launches for k, w in wrappers.items()}
        want = {k: n_steps * v for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"{phase} launched {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase} losses are not finite: {losses}")
        return losses, times, counts

    warm_losses, warm_times, _ = run(1)
    losses, times, counts = run(TRAIN_STEPS)
    step_s = sum(times) / len(times)
    tokens = TRAIN_SEQ
    attn_flops = TRAIN_LAYERS * 3.5 * flash_counts(True, 1, TRAIN_SEQ, cfg.num_attention_heads,
                                                   cfg.num_key_value_heads, 128)[2]
    if int8:
        # frozen projections: forward and dX, no dW (4 FLOPs a weight and
        # token); the head trains (6); the embedding is a gather
        head = model.lm_head.weight.numel()
        model_flops = (4 * extra["int8_weight_bytes"] + 6 * head) * tokens + attn_flops
    else:
        model_flops = 6 * (n_params - n_embed) * tokens + attn_flops
    say(phase, warmup_step_ms=round(1e3 * warm_times[0], 3), warmup_loss=warm_losses[0],
        step_ms=[round(1e3 * t, 3) for t in times], step_ms_mean=round(1e3 * step_s, 3),
        losses=losses, tokens_per_s=round(tokens / step_s, 1),
        model_tflop_per_step=round(model_flops / 1e12, 3),
        bf16_peak_share=round(model_flops / step_s / BF16_FLOP_PER_S, 4),
        max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        launches=counts)
    ids, labels = token_batch(rng, TRAIN_SEQ, cfg.vocab_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    per_kernel, ops = kernel_times(prof)
    busy = sum(per_kernel.values()) / 1e6
    say(phase, profiled_step_ms=round(1e3 * wall, 3),
        device_busy_ms=round(1e3 * busy, 3),
        device_busy_share=round(busy / wall, 4) if busy else "not measured",
        device_ops=ops)
    say(phase, device_ms_by_kind=json.dumps(by_kind(per_kernel)))
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {phase} top kernel: {us / 1e3:.4f} ms/step {name[:90]}", flush=True)
    del step, model
    torch.cuda.empty_cache()
    return counts


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
    from paddle_tpu_torch.ops.quant_matmul import int8_matmul, int8_matmul_large_m

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
    int8_matmul.launches = int8_matmul_large_m.launches = 0
    int8_reqs = serve(engine, prompts, NEW_TOKENS, "int8-engine")
    attn_launches_int8 = paged_decode_attention.launches
    gemm_launches = int8_matmul.launches
    agree = [a == b for r1, r2 in zip(bf16_reqs, int8_reqs)
             for a, b in zip(r1.generated, r2.generated)]
    say("int8-engine", paged_attention_launches=attn_launches_int8,
        int8_matmul_launches=gemm_launches,
        int8_matmul_large_m_launches=int8_matmul_large_m.launches,
        greedy_top1_agreement_vs_bf16=round(sum(agree) / len(agree), 4))
    if attn_launches_int8 <= 0 or gemm_launches <= 0:
        raise AssertionError("the int8 engine did not launch both kernels")
    if int8_matmul_large_m.launches:
        raise AssertionError("the int8 engine launched the large-M GEMM: serving runs "
                             "M <= 64 on the weight stream")
    profile_decode(engine, cfg.vocab_size, args.seed, "int8-engine")
    del engine, model
    torch.cuda.empty_cache()

    flash_fwd, flash_bwd = check_flash(gen)
    norm_fwd, norm_bwd = check_rms_norm(gen)
    check_train_step(args.seed)
    train_launches = train(args.seed)
    int8_fwd, int8_dx = check_int8_train(gen)
    swiglu_fwd, swiglu_bwd, swiglu_launches = check_swiglu(gen)
    check_train_step(args.seed, int8=True)
    finetune_launches = train(args.seed, int8=True)

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
         "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:117",
         "launches": gemm_launches, "max_abs_err": gemm["max_abs_err"],
         "ms": gemm["ms"], "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
         "at": "sum over one Llama-3-8B decode step at M=8 (7 projections x 32 "
               "layers + lm_head); launches from the int8 engine run"},
    ]
    for name, source, replaces, nums in (
            ("flash_attention_fwd", "flash_attention.cu", "flash_kernel.py:173", flash_fwd),
            ("flash_attention_bwd", "flash_attention.cu", "flash_kernel.py:208", flash_bwd),
            ("rms_norm_fwd", "rms_norm.cu", "fused_norm.py:79", norm_fwd),
            ("rms_norm_bwd", "rms_norm.cu", "fused_norm.py:79", norm_bwd)):
        wrapper = name if name != "rms_norm_bwd" else "rms_norm_bwd_dx"
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}",
            "launches": train_launches[wrapper], **nums})
        kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed training steps "
                              f"({TRAIN_LAYERS} layers)")
    for name, source, replaces, nums, launches in (
            ("int8_matmul_large_m", "quant_matmul.cu", "quant_matmul.py:117", int8_fwd,
             finetune_launches["int8_matmul_large_m"]),
            ("int8_matmul_dx", "quant_matmul.cu", "quant_matmul.py:143", int8_dx,
             finetune_launches["int8_matmul_dx"]),
            ("swiglu_fwd", "swiglu.cu", "fused_norm.py:152", swiglu_fwd,
             swiglu_launches["swiglu_fwd"]),
            ("swiglu_bwd", "swiglu.cu", "fused_norm.py:152", swiglu_bwd,
             swiglu_launches["swiglu_bwd"])):
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": launches, **nums})
        if name.startswith("int8"):
            kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed int8 fine-tuning "
                                  f"steps ({TRAIN_LAYERS} layers)")
    say("done", total_s=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
