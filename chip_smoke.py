#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of numbers:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` (one nvcc per source,
   started together; the seconds to each library's end), each kernel
   instantiation's registers and spilled bytes (``-Xptxas -v``), and for
   each library the counts of the tensor-core,
   TMA and barrier instructions in its SASS (``cuobjdump -sass``, beside
   nvcc): HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA loads), SYNCS
   (mbarrier operations). The flash library must hold HGMMA and UTMALDG
   and no HMMA; in the quant_matmul library the weight stream's kernels
   (``int8_stream_kernel``) HMMA and UTMALDG and no HGMMA, the tensor-core
   kernels (``int8_tc_kernel``) HGMMA and UTMALDG and no HMMA; the
   paged-attention library UTMALDG and HMMA (TMA page ring, mma.sync
   consumers);
2. kernels: each kernel against its plain PyTorch version at serving
   shapes in bf16, with the stated tolerance, and timed (CUDA events,
   after warm-up, cycling through enough buffers to defeat the 50 MB L2)
   beside its bound, the plain version and one PyTorch library call; the
   int8 weight stream at M = 1, 8, 16 and 64 a shape, with the decode
   step's sum (225 calls) at each M, and a second yardstick, the bf16
   engine's own call (``torch.matmul`` on weights dequantized before the
   timing, twice the bytes), then with f32 activations at M = 8. Paged attention
   is timed at three length mixes (PAGED_TIMED: ragged, full, skewed) and
   held at more (PAGED_CASES: fp16, f32, head_dim 64/80/96/256, pages of
   8, 32 and 256 slots, a GQA group of 12 heads, one of 1, every lane
   inactive; head_dims 20, 100 and 6, whose rows TMA cannot map) with
   every hidden slot poisoned with NaN and +-Inf against
   the plain version on the same pools poisoned with 100.0; two calls bit
   for bit; one captured CUDA graph replayed after ``lengths`` and the
   block table change in place; one kernel a call in a profiler trace.
   Then the eleventh slice's kernels: the int8 kernels with fp16
   activations (the weight stream at every decode shape and M, its decode
   step at M = 8 timed beside cuBLAS on fp16 weights; the tensor-core
   kernel at M = 8192 over one layer's projections), RMSNorm's
   composed-form mode (``round_first``) at [8192, 4096], flash attention's
   wide route at head dims 320, 512 and 1024 (its output in chunks of at
   most 256 columns; beside SDPA with the backend it picks, and its
   launches through ``nn.functional.flash_attention``) and
   the wide paged kernel at head dims 320 and 512 and pages of 512 slots
   (held against the plain version in f32), and one decode step's 225
   weight-stream calls captured as one graph, its programmatic
   (dependent-launch) edges counted;
3. bf16 engine: Llama-3-8B at full width, random weights from a seed,
   ``ServingEngine`` serving 10 requests on 8 lanes through its two CUDA
   graphs; every request must finish, the engine must hold one decode and
   one prefill capture, the eager engine (the plain version of
   the two programs) must give every request the same greedy tokens, and
   one teacher-forced decode step through the kernel must agree with the
   same step through the plain attention; five decode steps give the step
   time, the host time of the decode graph's replay call and its device
   span, then five profiled ones the busy share, the device ms a step by
   kind of kernel (KERNEL_KINDS) and the paged-attention kernel once a
   layer a step; then a traced window of 8 requests (one of them through 3
   prefill chunks), where the device must have run the paged-attention
   kernel exactly once a layer in each decode call (graph replays run
   kernels that no wrapper counts, so launches are read from that trace).
   Then (3s) the sampling head: the
   trace with every other request sampled, served twice bit for bit, its
   greedy requests and a ``top_k=1`` run equal to the greedy engine's, a
   decode step's device ms by kind (the vocabulary sort among them); and
   (3g) the NaN guard: one lane's K pages poisoned with NaN, that request
   failed with "nonfinite logits", the others equal to a clean run;
4. int8 engine: the same trace with ``weight_dtype="int8"``; one capture
   each; greedy tokens equal to the eager int8 engine's; greedy agreement
   with phase 3 is printed; the profiled decode steps must run the weight
   stream as one kernel a call (225 a step) and no other kernel of it, and
   the traced window exactly one a projection in each program call. Then
   an fp16 model with int8 weights at 4 layers (the weight stream's fp16
   instantiation), graphed against eager, and its traced window;
5. training kernels, before any model is built: flash attention forward
   (out, lse) and backward (dQ, dK, dV, through torch autograd) against
   their plain versions in bf16 at S = 2048 (GQA 4, head_dim 128, causal),
   S = 1000 (ragged tail), head_dim 64 with 16/8 heads, one non-causal
   case and the training shape S = 8192, each 64-row tile held to its own
   norm, each small case run twice for bit-identical gradients; RMSNorm
   forward and backward dx at [8192, 4096] and a ragged N. Each is timed
   at the training shape (S = 8192, [8192, 4096]) beside its bound, its
   plain version and a PyTorch library yardstick the port never calls
   (``F.scaled_dot_product_attention``, ``F.rms_norm``); flash's line gives
   ``ms / library_ms`` and ``bound_ms / ms`` each way. Then flash beyond
   the square bf16 case (FLASH_GENERAL_CASES): sq 1024 / sk 8192 causal
   (bottom-right) and not, sq 2048 / sk 1000 causal (rows that see no key),
   f32 at S 2048 (the f32 route: two bf16 pieces an operand) and bf16 at
   head_dim 96, 80 and 256 (the padded route), each with its route, held
   tile by tile (f32 to a tighter limit, which a TF32 control of the plain
   version must exceed) and timed beside its bound and SDPA
   (``causal_lower_right`` for bottom-right) with the ratio; and the padded
   route's launches through ``nn.functional.flash_attention``; then the f32
   route at phase 14's own shape (S 8192, H 32, Hk 8, hd 128, causal) held
   tile by tile against the plain f32 version one KV-head group at a time,
   with its TF32 control, and timed beside its bound and SDPA in f32;
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
8. fine-tuning kernels: the int8 GEMM's tensor-core kernel (wgmma fed by
   TMA), forward (M > 64) and dX, against their plain versions in bf16 at
   the seven Llama-3-8B projection shapes with M = 8192 tokens and a ragged
   M = 1000, and in f32 (through the three-piece bf16 split) at M = 8192,
   with the split pre-pass alone and an f32 ``QuantizedLinear`` for its
   launches; SwiGLU forward and backward at [8192, 14336] and ragged
   sizes; each timed beside its bound, its plain version and a PyTorch
   yardstick;
9. one int8 fine-tuning step, kernels against plain: phase 6 with every
   projection swapped for a frozen int8 ``QuantizedLinear`` (the same int8
   weights and scales on both paths), the int8 forward and dX launched
   exactly 7 L times;
10. int8 fine-tuning: phase 7's run with the projections int8-frozen
   (embedding, norms and head trained): finite losses, exact launch counts
   (int8 forward and dX 7 L per step, flash and RMSNorm as in phase 7),
   step time, tokens/s, model FLOPs share, peak memory, trainable
   parameters, int8 weight bytes and one profiled step's device-busy share;
11. ring kernels, bf16: the lse merge against its plain version at the
   three merges of a causal ring forward at the training shape (3, 2 and 1
   ranks of [2048, 32, 128] f32, each writing one finished rank) and at two
   ragged ones (rows merged with lse_b = -1e30 must come back bit for bit),
   the causal merges timed beside their byte bound and the same merge
   composed of torch ops; ring attention through ``ring_attention``, whose
   gate sends every case to the ring schedule over the flash kernels and
   the merge (one process, P virtual ranks), forward and backward through
   torch autograd at B 1, S 8192, P 4, H 32, Hk 8, hd 128,
   causal, and at P 2, non-causal, hd 64 with 16/8 heads, S / P = 1000 and
   B 2, each held tile by tile against the same schedule through the
   plain versions and against the full-sequence flash kernel, the small
   cases twice for bit-identical gradients, every call launching the flash
   forward and backward P times and the merge P - 1 times; timed at the
   training shape beside the full flash kernel, the bound and SDPA; then
   the ring in f32 through ``ring_attention``'s gate (flash's f32 route and
   the merge with an f32 partial) at S 2048, P 4;
12. one ring step check: Llama-3-8B widths at 2 layers, S = 2048, under a
   ``ProcessMesh`` whose sep axis has 4 ranks, the same weights with
   ``context_parallel="ring"`` and without, both through the kernels: the
   loss and every gradient agree within limits of their own;
13. ring training: phase 7's run with ``context_parallel="ring"`` under
   that mesh: finite losses, exact launch counts (flash forward and
   backward 4 ranks x 4 layers per step, the merge 3 x 4, RMSNorm as in
   phase 7), step time and its ratio to phase 7's, tokens/s, model FLOPs
   share, peak memory and one profiled step's device-busy share;
14. f32 training, Llama at its default dtype: first the step check of
   phase 6 in f32 (2 layers, S 2048, TF32 off, asserted and printed: the
   loss and every gradient, then one TrainStep's moments, kernels against
   plain within F32_STEP_*; the plain path once more with its flash in
   TF32, a control whose gradients must exceed the limit), then
   Llama-3-8B widths at F32_LAYERS layers,
   batch 1 x 8192, phase 7's optimizer: one warm-up and three timed steps,
   finite losses, exact launch counts (flash forward and backward once per
   layer per step, all on the f32 route; RMSNorm 2 L + 1 each way), step
   time, tokens/s, peak memory, and one profiled step's busy share and
   device ms by kind.

Then the total seconds and each phase's, the card's name and power limit
again, one JSON line with every
kernel's numbers (launches from the main path of its own phase: the
traced windows of the graphed engines for the serving kernels, the three
timed training steps for the training kernels, the three timed
fine-tuning steps for the int8 tensor-core kernels, phase 8 for SwiGLU,
which no model path calls, and the three timed ring training steps for
the merge and for the ring, whose launches are those of the flash and
merge kernels its calls made; flash's
f32 route from the three timed steps of phase 14, with its numbers from
phase 5's check at that shape, its padded route from phase 5's calls
through ``nn.functional.flash_attention``; the fp16 weight stream from
the fp16 int8 engine, the fp16 tensor-core kernel and the wide kernels
from phase 2's calls, RMSNorm's ``round_first`` mode from the three timed
training steps), and last ``{"ok": true,
"device": {...}}``. Any failure
raises and exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. ``--seed`` changes the
weights, the kernel inputs and the request trace.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
# f32 work on the tensor cores takes three bf16 products a product: the int8
# GEMM's exact three-piece split of x (W is exact in bf16), and f32 flash's
# two bf16 pieces of each operand, h.h' + h.l' + l.h' (989 / 3; 3xTF32, the
# other f32 route within FLASH_F32_TILE_RTOL, peaks at 494.7 / 3)
INT8_F32_FLOP_PER_S = BF16_FLOP_PER_S / 3
ATTN_F32_FLOP_PER_S = BF16_FLOP_PER_S / 3
F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores (cuBLAS f32, TF32 off)
L2_BYTES = 50 * 2**20

# kernel vs plain, both on the same inputs:
# - paged attention: the plain version rounds the probabilities to q's
#   dtype before the weighted sum and the kernel keeps them in f32; outputs
#   are convex combinations of N(0, 1) rows (|out| < 5), so rounding the
#   probabilities and the output once gives, in bf16 (2^-8 relative), well
#   under 2e-2 absolute, in fp16 (2^-11) under 5e-3; in f32 both sides sum
#   the same f32 products in another order: 1e-5.
ATTN_ATOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-5}
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
#   A row that sees no key (causal, sk < sq) has lse -1e30 on both sides, to
#   f32 rounding: lse is held within FLASH_LSE_ATOL plus 1e-6 of its
#   magnitude.
FLASH_LSE_RTOL = 1e-6
#   f32 flash (and the f32 ring over it) takes every operand as two bf16
#   pieces (16 significant bits) and each product as three piece products:
#   about 2^-17 relative a product, 6e-6 (forward) to 1.4e-5 (backward) of a
#   tile's norm in its CPU emulation. A kernel that rounded its operands to
#   TF32 (10 mantissa bits) would read about 4e-4, one that rounded them to
#   bf16 about 3e-3, so f32 is held to FLASH_F32_TILE_RTOL of a tile's
#   norm. Phase 5 runs the plain f32 version with TF32 matmuls as such a
#   control and requires it to exceed the limit.
FLASH_F32_TILE_RTOL = 1e-4
# - RMSNorm: the same f32 arithmetic summed in another order, one rounding
#   to bf16: one bf16 step (2^-7 relative) plus 1e-3 of the largest output.
NORM_RTOL, NORM_ATOL_FRAC = 2.0 ** -7, 1e-3
#   Which rounding a forward took shows in its bits: another summation order
#   moves inv-rms by an f32 ulp or two, which flips a bf16 rounding on about
#   2^-15 of the elements, while the two roundings (the weight applied before
#   or after it) differ on about a quarter. So RMSNorm's round_first forward
#   may differ from its plain version's bits on at most ROUND_MISMATCH_MAX of
#   the elements, and the plain version of the fused rounding, held the same
#   way, must fail (a control).
ROUND_MISMATCH_MAX = 1e-3
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
# - the int8 kernels with f32 activations: both sides sum the same exact
#   products (the weight stream: x * w; the tensor-core kernel: the three
#   bf16 pieces of the split times w) in f32 in another order and round
#   nothing after: 1e-5 relative plus 1e-5 of the largest output (an f32 sum
#   over K <= 14336 carries ~sqrt(K) ulps of its largest partial sum). The
#   tensor cores add each 16-deep partial product into the f32 accumulator
#   truncated, not rounded to nearest (on the H100 the q projection's dX,
#   reduction 4096, came 0.0063 from the plain version, about 2e-5 of its
#   largest output): up to one ulp of the running sum per step, all of one
#   sign, so the tensor-core kernel is held to GEMM_F32_TC_ULPS ulp (2^-23)
#   of the largest output per 16-deep step of its 3 R / 16 steps (R the
#   reduction length): 9.2e-5 at R = 4096, 3.2e-4 at R = 14336.
GEMM_F32_RTOL, GEMM_F32_ATOL_FRAC = 1e-5, 1e-5
GEMM_F32_TC_ULPS = 1
# - the ring's lse merge: the same f32 formula on both sides, each product
#   and sum rounded on its own; exp and log of two math libraries may differ
#   by a few ulps: acc within 1e-5 of each element plus 1e-6 of the largest,
#   lse within 1e-5 absolute (lse of order 10, an ulp 1e-6), the finished
#   rows' bf16 output within one bf16 step (2^-7 relative) of the plain one.
#   A row merged with lse_b = -1e30 must come back bit for bit.
MERGE_RTOL, MERGE_ATOL_FRAC, MERGE_LSE_ATOL = 1e-5, 1e-6, 1e-5
# - the 2-layer ring step against the same step without the ring, both
#   through the kernels: every op but the attention is the same arithmetic
#   on the same inputs, and the ring's attention differs from the full
#   kernel's only by rounding each partial to bf16 before its merge (2^-9
#   rms relative of the attention output, measured 8.1e-8 relative on the
#   loss and 0.0116 of a gradient's largest on the H100). The loss, a mean
#   over 2048 tokens, within 1e-5 relative; every gradient within 3e-2 of
#   its tensor's largest magnitude.
RING_STEP_LOSS_RTOL, RING_STEP_GRAD_FRAC = 1e-5, 3e-2
# - the 2-layer f32 step (phase 14), kernels against plain: every op but
#   flash and RMSNorm is the same f32 arithmetic on both paths (TF32 off);
#   RMSNorm differs by summation order (a few f32 ulps) and flash by its
#   split, about 1e-5 of a tile's norm. The loss within 1e-5 relative;
#   every gradient within 1e-4 of its tensor's largest magnitude, between
#   what the kernel path reads (1.1e-5 on the H100, the q/k projections'
#   gradients) and what the plain path reads with its flash in TF32 (6.9e-4,
#   q_proj), the control the check runs and requires to exceed the limit;
#   AdamW's m and v after one TrainStep as in phase 6, from that limit.
F32_STEP_LOSS_RTOL, F32_STEP_GRAD_FRAC = 1e-5, 1e-4
# - ring flash attention: FLASH_TILE_RTOL (f32: FLASH_F32_TILE_RTOL) and
#   FLASH_LSE_ATOL above, tile by tile, against (a) the same schedule
#   through the plain versions (the backward given the kernel forward's
#   out and lse, as in phase 5) and (b) the full-sequence flash kernel of
#   phase 5 (the same function, another decomposition: the ring merges
#   partials each rounded to bf16, 2^-9 rms relative, and its backward
#   takes its own out and lse).

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
# flash beyond the square bf16 case: (label, B, sq, sk, H, Hk, head_dim,
# causal, dtype); sq != sk (bottom-right causal; the third has 1048 rows
# that see no key), then the f32 route (two bf16 pieces) and the padded
# route (bf16 at head_dim 96, 80 and 256, run as 128, 128 and 256 columns)
FLASH_GENERAL_CASES = (("sq1024_sk8192_causal", 1, 1024, 8192, 32, 8, 128, True, "bf16"),
                       ("sq1024_sk8192", 1, 1024, 8192, 32, 8, 128, False, "bf16"),
                       ("sq2048_sk1000_causal", 1, 2048, 1000, 32, 8, 128, True, "bf16"),
                       ("f32_s2048_causal", 1, 2048, 2048, 32, 8, 128, True, "f32"),
                       ("hd96_s2048_causal", 1, 2048, 2048, 32, 8, 96, True, "bf16"),
                       ("hd80_s2048_causal", 1, 2048, 2048, 32, 8, 80, True, "bf16"),
                       ("hd256_s2048_causal", 1, 2048, 2048, 32, 8, 256, True, "bf16"))
NORM_CASES = ((8192, 4096), (1000, 4096), (37, 4096))
TRAIN_SEQ = 8192
TRAIN_LAYERS = 4
TRAIN_STEPS = 3
# f32 training (phase 14): Llama-3-8B widths at its default f32, 2 layers
# (parameters, gradients and AdamW's moments in f32 take 16 bytes a
# parameter: 23.8 GB at 1.487 B)
F32_LAYERS = 2
CHECK_SEQ = 2048
CHECK_LAYERS = 2
LR = 3e-4

# int8 fine-tuning: the kernel checks' token counts (the training shape and a
# ragged one), and SwiGLU's cases [N, H]
INT8_TRAIN_M = (TRAIN_SEQ, 1000)
SWIGLU_CASES = ((TRAIN_SEQ, 14336), (1000, 14336), (37, 1001))

# context parallelism: the ring size of the mesh's sep axis in phases 12-13;
# (label, B, S, P, H, Hk, head_dim, causal) of the ring checks, the first at
# the training shape (checked once and timed), the others run twice for
# bit-identical gradients; the merge's cases (N, S / P, H, D, finished
# ranks written out), the first three the merges of a causal ring forward
# at the training shape (step s merges ranks [s, P) and finishes rank s; the
# first is the kernels line's), then a non-causal middle step (no finished
# rows) and last step (every rank finished) at ragged sizes
RING = 4
RING_CASES = (("s8192_p4", 1, TRAIN_SEQ, RING, 32, 8, 128, True),
              ("s2048_p2", 1, 2048, 2, 32, 8, 128, True),
              ("s2048_p4_noncausal", 1, 2048, RING, 32, 8, 128, False),
              ("s2048_p4_hd64_h16_hk8", 1, 2048, RING, 16, 8, 64, True),
              ("s4000_p4_ragged", 1, 4000, RING, 32, 8, 128, True),
              ("b2_s1024_p4", 2, 1024, RING, 32, 8, 128, True))
MERGE_CASES = tuple((RING - s, TRAIN_SEQ // RING, 32, 128, 1) for s in range(1, RING)) + (
    (3, 1000, 8, 64, 0), (3, 1000, 8, 64, 3))

# Llama-3-8B decode shapes: (name, K, N, launches per decode step)
GEMM_SHAPES = (("q", 4096, 4096, 32), ("k", 4096, 1024, 32), ("v", 4096, 1024, 32),
               ("o", 4096, 4096, 32), ("gate", 4096, 14336, 32), ("up", 4096, 14336, 32),
               ("down", 14336, 4096, 32), ("lm_head", 4096, 128256, 1))


def say(phase: str, **nums):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
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


RAGGED = [0, 1, 17, 250, 511, 700, 1000, 1023]
# timed at the serving shape (8 lanes, H 32, Hk 8, hd 128, bs 16, MB 64, bf16)
PAGED_TIMED = (("ragged", RAGGED), ("full", [1023] * 8), ("skewed", [1023] + [31] * 7))
# held only: (label, lengths, H, Hk, hd, bs, MB, dtype)
PAGED_CASES = (("fp16", RAGGED, 32, 8, 128, 16, 64, "float16"),
               ("f32", RAGGED, 32, 8, 128, 16, 64, "float32"),
               ("hd64_bs8", RAGGED, 32, 8, 64, 8, 128, "bfloat16"),
               ("hd80_bs32", RAGGED, 32, 8, 80, 32, 32, "bfloat16"),
               ("hd96", RAGGED, 32, 8, 96, 16, 64, "bfloat16"),
               ("hd256", RAGGED, 32, 8, 256, 16, 64, "bfloat16"),
               ("f32_hd256_bs32", RAGGED, 16, 4, 256, 32, 32, "float32"),
               ("fp16_hd80_bs8", [3, 0, 77, 1023], 32, 8, 80, 8, 128, "float16"),
               ("gqa12", RAGGED, 24, 2, 128, 16, 64, "bfloat16"),
               ("mha_hd64", RAGGED, 8, 8, 64, 16, 64, "bfloat16"),
               ("bs256", [0, 255, 256, 1023], 32, 8, 128, 256, 4, "bfloat16"),
               ("inactive", [0] * 8, 32, 8, 128, 16, 64, "bfloat16"),
               # rows that are no multiple of 16 bytes: the copying producer
               ("hd20", RAGGED, 32, 8, 20, 16, 64, "bfloat16"),
               ("fp16_hd100_bs8", RAGGED, 32, 8, 100, 8, 128, "float16"),
               ("f32_hd6", RAGGED, 32, 8, 6, 16, 64, "float32"))


def attention_inputs(gen, lengths, layers=4, H=32, Hk=8, hd=128, bs=16, MB=64,
                     dtype="bfloat16"):
    """Pools of ``layers`` layers (cycled when timing, so that the working
    set exceeds L2), a fragmented block table and ragged lengths. Lane i
    sees slots 0..lengths[i]; a length-0 lane with an all-zero row stands
    for an inactive lane on trash block 0. Every slot no lane may see
    (the tail of a last page, table entries past the length, the rest of
    block 0) holds 100.0, so a kernel that read one would miss by far."""
    import torch

    dt = getattr(torch, dtype)
    lanes = len(lengths)
    need = [-(-(n + 1) // bs) for n in lengths]
    stale_pages = 4
    nb = 1 + sum(need) + stale_pages
    dev = "cuda"
    pk = torch.randn((layers, nb, bs, Hk, hd), generator=gen, device=dev).to(dt)
    pv = torch.randn((layers, nb, bs, Hk, hd), generator=gen, device=dev).to(dt)
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
    q = torch.randn((layers, lanes, H, hd), generator=gen, device=dev).to(dt)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, table, ln


def poisoned(pages, table, ln):
    """A copy of a pool [..., nb, bs, Hk, hd] whose slots no lane sees hold
    NaN, +Inf and -Inf in turn (a torch.empty pool may hold any of them)."""
    import torch

    bs, mb = pages.shape[-3], table.shape[1]
    slots = torch.arange(mb * bs, device=pages.device)
    seen = slots[None, :] <= ln[:, None].long()
    vis = torch.zeros(pages.shape[-4:-2], dtype=torch.bool, device=pages.device)
    vis[table.long()[:, slots // bs][seen], (slots % bs).expand(len(ln), -1)[seen]] = True
    bad = torch.tensor([float("nan"), float("inf"), float("-inf")], device=pages.device)
    fill = bad[torch.arange(vis.numel(), device=pages.device) % 3].reshape(vis.shape)
    fill = fill[..., None, None].expand(pages.shape[-4:]).to(pages.dtype)
    return torch.where(vis[..., None, None], pages, fill)


def hold_paged(label, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    tol = ATTN_ATOL[dtype]
    if not err <= tol:  # NaN fails too
        raise AssertionError(f"paged attention ({label}) differs from its plain version by "
                             f"{err} > {tol}")
    return err


def hold_paged_cases(gen, cases, wide: bool = False):
    """Cases of PAGED_CASES' form with poisoned hidden slots, each called
    twice bit for bit and counted in its mode; the wide mode's held against
    the plain version evaluated in f32 (``time_paged``'s ``hold_f32``)."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    errs = {}
    for label, lengths, H, Hk, hd, bs, MB, dtype in cases:
        q, pk, pv, table, ln = attention_inputs(gen, lengths, 1, H, Hk, hd, bs, MB, dtype)
        want = pa.paged_decode_attention_ref(*((q[0].float(), pk[0].float(), pv[0].float())
                                               if wide else (q[0], pk[0], pv[0])), table, ln)
        pk, pv = poisoned(pk[0], table, ln), poisoned(pv[0], table, ln)
        before = dict(pa.paged_decode_attention.by_route)
        got = pa.paged_decode_attention(q[0], pk, pv, table, ln)
        if not torch.equal(got, pa.paged_decode_attention(q[0], pk, pv, table, ln)):
            raise AssertionError(f"two paged-attention calls ({label}) differ")
        mode = pa.mode(hd, bs)
        if mode != ("wide" if wide else "narrow") or \
                pa.paged_decode_attention.by_route[mode] != before[mode] + 2:
            raise AssertionError(f"paged attention ({label}) did not launch its kernel's "
                                 f"{mode} mode twice")
        errs[label] = hold_paged(label, got, want, dtype)
    say("kernels", kernel="paged_attention", mode="wide" if wide else "narrow",
        cases=json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))


def check_paged_cases(gen):
    """PAGED_CASES with poisoned hidden slots, each called twice bit for
    bit and counted; a captured graph replayed after lengths and the table
    change in place; one kernel a call in a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import paged_attention as pa

    hold_paged_cases(gen, PAGED_CASES)

    q, pk, pv, table, ln = attention_inputs(gen, [1023] * 8, 1)
    q, pk, pv = q[0], pk[0], pv[0]

    def kern():
        return pa.paged_decode_attention(q, pk, pv, table, ln)

    first, again = kern(), kern()
    if not torch.equal(first, again):
        raise AssertionError("two paged-attention calls differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern()
    graph.replay()
    before = hold_paged("graph", out, pa.paged_decode_attention_ref(q, pk, pv, table, ln),
                        "bfloat16")
    ln.copy_(torch.tensor(RAGGED, dtype=torch.int32, device="cuda"))
    table.copy_(table.flip(0))
    graph.replay()
    after = hold_paged("graph, new lengths and table", out,
                       pa.paged_decode_attention_ref(q, pk, pv, table, ln), "bfloat16")
    del graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern()
        torch.cuda.synchronize()
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    if len(kernels) != 1:
        raise AssertionError(f"one paged-attention call ran {len(kernels)} kernels: {kernels}")
    say("kernels", kernel="paged_attention", bit_identical=True, graph_err=before,
        graph_err_after_update=after, kernels_per_call=len(kernels), kernel_name=kernels[0][:60],
        smem_bytes=pa.smem_bytes(8, 32, 8, 128, 16, torch.bfloat16),
        grid=pa.grid_size(8, 32, 8, 64, torch.cuda.get_device_properties(0).multi_processor_count))


def paged_bound(lengths, lanes, H, Hk, hd, bs, MB, es=2):
    """(bytes, FLOPs) one call must move and do: q and out once, each
    visible K and V row once, the visible table entries and the lengths."""
    n_vis = [min(n + 1, MB * bs) for n in lengths]
    nbytes = (lanes * H * hd * es * 2 + sum(n_vis) * Hk * hd * es * 2
              + sum(-(-n // bs) for n in n_vis) * 4 + lanes * 4)
    return nbytes, sum(n_vis) * H * hd * 4


def time_paged(gen, label, lengths, kern=None, yardsticks: bool = True, hold: bool = True,
               shape=None, hold_f32: bool = False):
    """Hold (unless ``hold`` is false) and time one PAGED_TIMED case (4
    layers of pools, cycled; ``shape``: other ``attention_inputs`` sizes):
    the kernel (``kern(q, pk, pv, table, ln)``, the wrapper by default)
    and, with ``yardsticks``, its plain version and SDPA over the gathered
    window. With ``hold_f32`` the kernel is held against the plain version
    evaluated in f32 on the same inputs, for a kernel that keeps its
    probabilities and sums in f32 and rounds once (the plain version in
    bf16 rounds its probabilities and its output: at hd 512 an output in
    [4, 8) may then differ by one bf16 step, 0.03125, past ATTN_ATOL)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    kern = kern or pa.paged_decode_attention
    q, pk, pv, table, ln = attention_inputs(gen, lengths, **(shape or {}))
    layers, lanes, H, hd = q.shape
    _, nb, bs, Hk, _ = pk.shape

    def run(i):
        return kern(q[i], pk[i], pv[i], table, ln)

    def plain(i):
        return pa.paged_decode_attention_ref(q[i], pk[i], pv[i], table, ln)

    def plain32(i):
        return pa.paged_decode_attention_ref(q[i].float(), pk[i].float(), pv[i].float(),
                                             table, ln)

    want = plain32 if hold_f32 else plain
    err = max(hold_paged(label, run(i), want(i), "bfloat16") for i in range(layers)) \
        if hold else float("nan")
    nbytes, flops = paged_bound(lengths, lanes, H, Hk, hd, bs, table.shape[1])
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = device_ms(run, layers)
    out = {"max_abs_err": err, "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    if not yardsticks:
        return out
    # yardstick: one SDPA call over the gathered window (gather not timed)
    S = table.shape[1] * bs
    kw = [pk[i][table.long()].reshape(lanes, S, Hk, hd).transpose(1, 2) for i in range(layers)]
    vw = [pv[i][table.long()].reshape(lanes, S, Hk, hd).transpose(1, 2) for i in range(layers)]
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
    return {**out, "plain_ms": device_ms(plain, layers), "library_ms": device_ms(library, layers),
            "eager_ms": eager_ms(run, layers), "library_max_abs_err": lib_err}


def check_attention(gen):
    results = {}
    for label, lengths in PAGED_TIMED:
        r = time_paged(gen, label, lengths)
        say("kernels", kernel="paged_attention", case=label, lengths=lengths,
            max_abs_err=r["max_abs_err"], tol=ATTN_ATOL["bfloat16"], ms=round(r["ms"], 5),
            bound_ms=round(r["bound_ms"], 5), bound_by=r["bound_by"],
            bound_share=round(r["bound_ms"] / r["ms"], 4), plain_ms=round(r["plain_ms"], 5),
            library_ms=round(r["library_ms"], 5),
            library_ratio=round(r["ms"] / r["library_ms"], 4),
            eager_ms=round(r["eager_ms"], 5), library_max_abs_err=r["library_max_abs_err"],
            bytes=r["bytes"], GBps=round(r["bytes"] / r["ms"] / 1e6, 1))
        results[label] = r
    check_paged_cases(gen)
    return results["ragged"]


# the weight stream's lane counts held and timed a shape: one lane, the
# serving engine's 8 and a 16-token prefill chunk, and the largest M it takes
STREAM_M = (1, 8, 16, 64)


def check_int8(gen):
    """The weight stream at each GEMM_SHAPES shape and STREAM_M, held against
    the plain version and timed beside its bound, the plain version, the
    dequantize-then-matmul call (``library_ms``) and the bf16 engine's own
    call on weights dequantized before the timing (``bf16_gemm_ms``); the
    decode step (225 calls) summed at each M. Returns M = 8's step."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bf16_gemm_ms", "bytes", "flops")
    steps = {M: dict.fromkeys(keys, 0.0) for M in STREAM_M}
    max_err = 0.0
    for name, K, N, per_step in GEMM_SHAPES:
        n_bufs = max(1, min(8, math.ceil(3 * L2_BYTES / (K * N))))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(n_bufs)]
        ss = [torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(n_bufs)]
        w16 = [w.to(torch.bfloat16) for w in ws]
        for M in STREAM_M:
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()

            def kern(i):
                return qm.int8_matmul(x, ws[i], ss[i])

            def plain(i):
                return qm.int8_matmul_ref(x, ws[i], ss[i])

            def library(i):
                return torch.matmul(x, ws[i].to(torch.bfloat16)) * ss[i]

            def bf16_gemm(i):
                return torch.matmul(x, w16[i]) * ss[i]

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
            gemm_ms = device_ms(bf16_gemm, n_bufs)
            say("kernels", kernel="int8_matmul", shape=name, M=M, K=K, N=N,
                max_abs_err=err, rel_err=rel, ms=round(ms, 5), bound_ms=round(b_ms, 5),
                bound_by=b_by, bound_share=round(b_ms / ms, 4), plain_ms=round(plain_ms, 5),
                library_ms=round(lib_ms, 5), bf16_gemm_ms=round(gemm_ms, 5),
                eager_ms=round(eager_ms(kern, n_bufs), 5), GBps=round(nbytes / ms / 1e6, 1))
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms), ("bf16_gemm_ms", gemm_ms),
                             ("bytes", nbytes), ("flops", flops)):
                steps[M][key] += per_step * val
        del ws, ss, w16
        torch.cuda.empty_cache()
    for M, tot in steps.items():
        say("kernels", kernel="int8_matmul", case=f"decode_step_M{M}_225_launches",
            ms=round(tot["ms"], 5), bound_ms=round(tot["bound_ms"], 5),
            bound_share=round(tot["bound_ms"] / tot["ms"], 4),
            plain_ms=round(tot["plain_ms"], 5), library_ms=round(tot["library_ms"], 5),
            bf16_gemm_ms=round(tot["bf16_gemm_ms"], 5),
            ratio_to_M8=round(tot["ms"] / steps[8]["ms"], 4))
    total = steps[8]
    total["max_abs_err"] = max_err
    total["bound_by"] = bound_ms(total["bytes"], total["flops"])[1]
    check_int8_f32_decode(gen)
    stream_dependent_launch_in_graph(gen)
    return total


def graph_edges(graph) -> tuple:
    """(edges, programmatic edges) of a captured graph kept as a
    ``cudaGraph_t`` (``CUDAGraph(keep_graph=True)``), read through
    libcuda's ``cuGraphGetEdges_v2``: an edge is programmatic where a
    kernel launched with programmatic stream serialisation may start
    before the kernel it follows ends."""
    import ctypes

    class EdgeData(ctypes.Structure):
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuGraphGetEdges_v2
    fn.restype = ctypes.c_int
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if fn(handle, None, None, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (EdgeData * n.value)()
    if fn(handle, src, dst, data, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    return n.value, sum(1 for e in data if e.type == 1)   # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC


def stream_dependent_launch_in_graph(gen, copies: int = 4):
    """Does the weight stream's programmatic dependent launch survive a CUDA
    graph? One decode step's 225 calls at M = 8 (bf16; the projections
    cycled over ``copies`` weight sets so that L2 holds few of them)
    captured as one graph: its programmatic edges counted
    (``graph_edges``), then its replay timed. Returns (edges, programmatic
    edges, ms a step)."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    shapes = [(K, N) for name, K, N, _ in GEMM_SHAPES if name != "lm_head"]
    sets = [[(torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                            dtype=torch.int8),
              torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3)
             for K, N in shapes] for _ in range(copies)]
    _, K, N, _ = GEMM_SHAPES[-1]
    head = (torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8),
            torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3)
    xs = {K: torch.randn((8, K), generator=gen, device="cuda").bfloat16()
          for K in {k for k, _ in shapes}}
    calls = [(xs[w.shape[0]], w, s) for layer in range(32)
             for w, s in sets[layer % copies]] + [(xs[head[0].shape[0]], *head)]

    def step():
        for x, w, s in calls:
            qm.int8_matmul(x, w, s)

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        step()
    edges, programmatic = graph_edges(graph)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / 5
    say("kernels", kernel="int8_matmul", case="decode_step_M8_in_one_graph", calls=len(calls),
        graph_edges=edges, programmatic_edges=programmatic, ms=round(ms, 5),
        weight_sets=copies)
    del graph, sets, head, xs, calls
    torch.cuda.empty_cache()
    return edges, programmatic, ms


def hold_gemm_f32(label, got, want, reduction: int = 0) -> float:
    """GEMM_F32_RTOL and GEMM_F32_ATOL_FRAC elementwise, or for the
    tensor-core kernel (``reduction`` its length R) GEMM_F32_TC_ULPS ulps of
    the largest output per 16-deep step; returns the max abs error."""
    import torch

    if got.dtype != torch.float32:
        raise AssertionError(f"{label} returned {got.dtype}, not float32")
    diff = (got - want).abs()
    frac = (GEMM_F32_TC_ULPS * 3 * -(-reduction // 16) * 2.0 ** -23 if reduction
            else GEMM_F32_ATOL_FRAC)
    if not bool((diff <= GEMM_F32_RTOL * want.abs() + frac * want.abs().max()).all()):
        raise AssertionError(f"{label} differs from its plain version: max abs err "
                             f"{diff.max().item()}")
    return diff.max().item()


def check_int8_f32_decode(gen):
    """The weight stream with f32 activations: one decode step at M = 8 (the
    eight shapes, 225 launches), each shape held against the plain version
    and timed beside its bound (bytes), the plain version and cuBLAS in
    f32 (``torch.matmul`` on the weights cast to f32, TF32 off)."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    err = 0.0
    for name, K, N, per_step in GEMM_SHAPES:
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        x = torch.randn((8, K), generator=gen, device="cuda")
        err = max(err, hold_gemm_f32(f"int8_matmul f32 {name} M=8", qm.int8_matmul(x, w, s),
                                     qm.int8_matmul_ref(x, w, s)))
        wf = w.float()
        b_ms, _ = bound_ms(8 * K * 4 + K * N + N * 4 + 8 * N * 4, 2 * 8 * K * N)
        for key, fn, it in (("ms", lambda i: qm.int8_matmul(x, w, s), 20),
                            ("plain_ms", lambda i: qm.int8_matmul_ref(x, w, s), 5),
                            ("library_ms", lambda i: torch.matmul(x, wf) * s, 5)):
            tot[key] += per_step * device_ms(fn, 1, it)
        tot["bound_ms"] += per_step * b_ms
        del w, s, x, wf
        torch.cuda.empty_cache()
    say("kernels", kernel="int8_matmul", case="decode_step_M8_f32", max_abs_err=err,
        **{k: round(v, 5) for k, v in tot.items()})


# ---------------------------------------------------------------------------
# phases 3-4: the serving engine
# ---------------------------------------------------------------------------


def trace(n_requests: int, seed: int, vocab: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, int(rng.randint(16, 601))).tolist()
            for _ in range(n_requests)]


def serve(engine, prompts, max_new: int, phase: str, params=None):
    """Submit every prompt at once (with ``params[i]`` as its
    SamplingParams) and step until drained; returns the requests. Prints
    tokens/s, the step wall times (each step ends synchronised), TTFT, and
    on the card each program's calls and mean device span (CUDA events just
    before and after each call: for a graph, its device time; for the eager
    programs, with the gaps in which the card waits for the host) and their
    sum's share of the wall time."""
    import torch

    params = params or [None] * len(prompts)
    reqs = [engine.submit(p, max_new, sampling=sp) for p, sp in zip(prompts, params)]
    steps = []
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # each program call's device span (CUDA events just before and after it)
    spans: dict = {"decode": [], "prefill": []}
    progs = {"decode": engine._decode_prog, "prefill": engine._prefill_prog}

    def timed(name):
        def call():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
            progs[name]()
            b.record()
            spans[name].append((a, b))
        return call

    if cuda:
        engine._decode_prog, engine._prefill_prog = timed("decode"), timed("prefill")
    t0 = time.perf_counter()
    while engine.pending():
        s0 = time.perf_counter()
        engine.step()
        sync()
        steps.append(time.perf_counter() - s0)
    wall = time.perf_counter() - t0
    engine._decode_prog, engine._prefill_prog = progs["decode"], progs["prefill"]
    device = {f"{k}_calls": len(v) for k, v in spans.items()}
    device.update({f"{k}_device_ms_mean": round(sum(a.elapsed_time(b) for a, b in v) / len(v), 3)
                   for k, v in spans.items() if v})
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
        prompt_tokens=sum(len(p) for p in prompts), **device,
        program_span_share=round(sum(a.elapsed_time(b) for v in spans.values() for a, b in v)
                                 / (1e3 * wall), 4) if cuda else "not measured")
    return reqs


def serving_kernels(counts: dict) -> dict:
    """Launches of the serving path's kernels in a device trace's
    {kernel name: launches}: paged attention's two modes (narrow and wide)
    and the int8 weight stream, and the int8 tensor-core forward, which
    serving must not run."""
    return {kind: sum(n for name, n in counts.items() if sub in name)
            for kind, sub in (("paged", "paged_decode_kernel"),
                              ("paged_wide", "paged_decode_wide_kernel"),
                              ("stream", "int8_stream_kernel"),
                              ("large_m", "int8_tc_kernel<false"))}


def trace_launches(engine, phase: str, seed: int, int8: bool = False,
                   wide: bool = False) -> dict:
    """The kernels a graphed engine's device ran, read from a device trace
    (a replay runs kernels that no wrapper counts): under torch.profiler
    the engine serves 7 one-token requests and one whose prompt takes 3
    prefill chunks, 4 tokens each, to the end. Holds the traced launches
    exactly against the programs' calls in that window: paged attention
    once a layer in each decode call (in its wide mode with ``wide``: pages
    past 256 slots); with int8 the weight stream once a
    projection in each call (7 a layer in either program, and the lm_head
    in decode), the tensor-core forward never; without, the stream never.
    Returns the traced launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    layers = engine.model.config.num_hidden_layers
    vocab, C = engine.model.config.vocab_size, engine.config.prefill_chunk
    rng = np.random.RandomState(seed + 2)
    reqs = [engine.submit([int(rng.randint(1, vocab))], 4)
            for _ in range(engine.config.num_lanes - 1)]
    reqs.append(engine.submit(rng.randint(1, vocab, 3 * C + 1).tolist(), 4))
    before = engine.stats()["program_calls"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run()
        torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in engine.stats()["program_calls"].items()}
    counts: dict = {}
    kernel_times(prof, counts)
    traced = serving_kernels(counts)
    head = 1 if engine._w["lm_head"] is not None else 0
    paged = layers * calls["decode"]
    want = {"paged": 0 if wide else paged, "paged_wide": paged if wide else 0,
            "stream": (7 * layers + head) * calls["decode"] + 7 * layers * calls["prefill"]
            if int8 else 0, "large_m": 0}
    say(phase, traced_program_calls=json.dumps(calls), traced_launches=json.dumps(traced),
        want=json.dumps(want))
    if any(r.status != "done" for r in reqs) or calls["prefill"] < 3 or traced != want:
        raise AssertionError(f"{phase}: the traced graphed programs {calls} launched {traced} "
                             f"(want {want})")
    return traced


def hold_decode_step(per_step: dict, layers: int, int8: bool, phase: str, wide: bool = False):
    """A profiled graphed decode step (profile_decode's launches a step by
    kernel name) runs paged attention once a layer (in its wide mode with
    ``wide``, the narrow one never) and, with int8, the weight stream once a
    projection (7 a layer and the lm_head)."""
    got = serving_kernels(per_step)
    want = {"paged": 0 if wide else layers, "paged_wide": layers if wide else 0,
            "stream": 7 * layers + 1 if int8 else 0, "large_m": 0}
    other = sorted(k for k in per_step if "finalize" in k or "int8_gemm_kernel" in k)
    say(phase, kernels_per_decode_step=json.dumps(got), want=json.dumps(want),
        other_stream_kernels=json.dumps(other))
    if got != want or other:
        raise AssertionError(f"{phase}: a graphed decode step launched {got} (want {want}) "
                             f"and {other}")


def sampled_params(n: int, seed: int):
    """The sampling phase's mix: every other request greedy (None), the
    others with their own temperature, top-k, top-p and seed."""
    from paddle_tpu_torch.inference.serving import SamplingParams

    return [None if i % 2 else SamplingParams(temperature=(0.7, 1.0, 0.9)[i % 3],
                                              top_k=(0, 50, 200)[i % 3],
                                              top_p=(0.9, 1.0, 0.95)[i % 3], seed=seed + i)
            for i in range(n)]


def hold_captures(engine, phase: str):
    caps = engine.stats()["captures"]
    say(phase, captures=json.dumps(caps))
    if caps != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"{phase}: the engine captured {caps}, not one decode and one "
                             "prefill program")


def check_sampling(model, serve_cfg: dict, prompts, greedy_reqs, seed: int):
    """The sampling head at full width (bf16, graphed): mixed greedy and
    sampled requests served twice, bit-identical; their greedy requests
    equal the greedy engine's (phase 3); every request at ``top_k=1``
    equals the greedy engine's too; one decode and one prefill capture an
    engine; a decode step's device ms by kind (the vocabulary sort among
    them)."""
    from paddle_tpu_torch.inference.serving import SamplingParams, ServeConfig, ServingEngine

    params = sampled_params(len(prompts), seed)
    runs = []
    for run in range(2):
        engine = ServingEngine(model, ServeConfig(sampling=True, **serve_cfg))
        runs.append([r.generated for r in serve(engine, prompts, NEW_TOKENS,
                                                f"sampling-run{run}", params)])
        hold_captures(engine, "sampling")
        if run == 1:
            hold_decode_step(profile_decode(engine, model.config.vocab_size, seed, "sampling"),
                             model.config.num_hidden_layers, False, "sampling")
        del engine
    if runs[0] != runs[1]:
        raise AssertionError("two sampled runs of one trace differ")
    greedy = [r.generated for r in greedy_reqs]
    mismatched = [i for i, p in enumerate(params) if p is None and runs[0][i] != greedy[i]]
    sampled_differ = sum(runs[0][i] != greedy[i] for i, p in enumerate(params) if p)
    engine = ServingEngine(model, ServeConfig(sampling=True, **serve_cfg))
    top1 = [r.generated for r in serve(
        engine, prompts, NEW_TOKENS, "sampling-top_k1",
        [SamplingParams(top_k=1, temperature=0.8, seed=seed + i) for i in range(len(prompts))])]
    hold_captures(engine, "sampling")
    del engine
    say("sampling", replay_bit_identical=True, greedy_requests_equal_greedy_engine=not mismatched,
        sampled_requests_differing_from_greedy=sampled_differ,
        top_k1_equal_greedy_engine=top1 == greedy)
    if mismatched or top1 != greedy:
        raise AssertionError(f"greedy requests {mismatched} of the sampling engine, or its "
                             "top_k=1 run, differ from the greedy engine")


def check_nan_guard(model, serve_cfg: dict, prompts):
    """The NaN guard at full width (bf16, graphed): three requests, one
    lane's K pages poisoned with NaN once it has two tokens; that request
    fails with "nonfinite logits", the others equal a clean guarded run."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    def run(poison: bool):
        engine = ServingEngine(model, ServeConfig(nan_guard=True, **serve_cfg))
        reqs = [engine.submit(p[:40], NEW_TOKENS) for p in prompts[:3]]
        while len(reqs[1].generated) < 2:
            engine.step()
        if poison:
            engine._kv.pages_k[:, engine._kv.lane_blocks(reqs[1].lane)] = float("nan")
        engine.run()
        torch.cuda.synchronize()
        hold_captures(engine, "nan-guard")
        return reqs

    bad, clean = run(True), run(False)
    survivors = [r.generated for r in (bad[0], bad[2])] == \
        [r.generated for r in (clean[0], clean[2])]
    say("nan-guard", poisoned_status=bad[1].status, error=repr(bad[1].error),
        poisoned_tokens_before=len(bad[1].generated), survivors_bit_identical=survivors,
        clean_done=all(r.status == "done" for r in clean))
    if bad[1].status != "failed" or bad[1].error != "nonfinite logits" or not survivors:
        raise AssertionError("the NaN guard did not evict the poisoned lane alone")


FP16_INT8_LAYERS = 4


def check_fp16_int8_engine(seed: int, serve_cfg: dict, prompts):
    """An fp16 model with int8 weights (the weight stream's fp16
    instantiation on the serving path), at Llama-3-8B widths cut to
    FP16_INT8_LAYERS layers: the graphed engine against the eager one on
    the trace, greedy tokens identical; returns the weight stream's
    launches in the graphed engine's traced window."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=FP16_INT8_LAYERS)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float16, seed=seed)
    int8_cfg = dict(weight_dtype="int8", **serve_cfg)
    engine = ServingEngine(model, ServeConfig(**int8_cfg))
    got = [r.generated for r in serve(engine, prompts, NEW_TOKENS, "fp16-int8-engine")]
    hold_captures(engine, "fp16-int8-engine")
    launches = trace_launches(engine, "fp16-int8-engine", seed, int8=True)["stream"]
    del engine
    eager = ServingEngine(model, ServeConfig(**int8_cfg), eager=True)
    want = [r.generated for r in serve(eager, prompts, NEW_TOKENS, "fp16-int8-eager")]
    del eager, model
    torch.cuda.empty_cache()
    say("fp16-int8-engine", layers=FP16_INT8_LAYERS, graphed_equals_eager=got == want)
    if got != want:
        raise AssertionError("the fp16 int8 engine: graphed tokens differ from eager")
    return launches


WIDE_ENGINE_LAYERS = 2
WIDE_ENGINE_CFG = dict(num_lanes=8, block_size=512, max_seq_len=1024, prefill_chunk=16)


def check_wide_engine(seed: int, prompts):
    """Serving with pages of 512 slots, the paged kernel's wide mode on the
    serving path: Llama-3-8B widths cut to WIDE_ENGINE_LAYERS layers, bf16,
    WIDE_ENGINE_CFG, graphed, against the eager engine on the trace (greedy
    tokens identical); a profiled decode step runs the wide mode once a
    layer and the narrow one never. Returns the wide mode's launches in the
    graphed engine's traced window."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=WIDE_ENGINE_LAYERS)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    engine = ServingEngine(model, ServeConfig(**WIDE_ENGINE_CFG))
    got = [r.generated for r in serve(engine, prompts, NEW_TOKENS, "wide-engine")]
    hold_captures(engine, "wide-engine")
    hold_decode_step(profile_decode(engine, cfg.vocab_size, seed, "wide-engine"),
                     WIDE_ENGINE_LAYERS, False, "wide-engine", wide=True)
    launches = trace_launches(engine, "wide-engine", seed, wide=True)["paged_wide"]
    del engine
    eager = ServingEngine(model, ServeConfig(**WIDE_ENGINE_CFG), eager=True)
    want = [r.generated for r in serve(eager, prompts, NEW_TOKENS, "wide-eager")]
    del eager, model
    torch.cuda.empty_cache()
    say("wide-engine", layers=WIDE_ENGINE_LAYERS, block_size=WIDE_ENGINE_CFG["block_size"],
        graphed_equals_eager=got == want)
    if got != want:
        raise AssertionError("the wide-page engine: graphed tokens differ from eager")
    return launches


def compare_eager(model, serve_cfg: dict, prompts, graphed_reqs, phase: str):
    """The same trace through the eager engine (the plain version of the two
    programs): every request's greedy tokens must equal the graphed
    engine's."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    eager = ServingEngine(model, ServeConfig(**serve_cfg), eager=True)
    want = serve(eager, prompts, NEW_TOKENS, f"{phase}-eager")
    del eager
    torch.cuda.empty_cache()
    same = [a.generated == b.generated for a, b in zip(graphed_reqs, want)]
    say(phase, graphed_tokens_equal_eager=all(same), requests=len(same))
    if not all(same):
        raise AssertionError(f"{phase}: the graphed engine's greedy tokens differ from the "
                             "eager engine's for requests "
                             f"{[i for i, s in enumerate(same) if not s]}")


# device kernels of a training step by kind: (kind, name substrings)
KERNEL_KINDS = (("paged attention (port)", ("paged_decode_kernel",)),
                ("paged attention wide (port)", ("paged_decode_wide_kernel",)),
                ("flash attention (port)", ("flash_", "split_kernel")),
                ("ring merge (port)", ("ring_merge_kernel",)),
                ("rms norm (port)", ("rms_fwd_kernel", "rms_bwd_dx_kernel")),
                ("int8 weight stream (port)", ("int8_stream_kernel",)),
                ("int8 forward (port)", ("int8_tc_kernel<false",)),
                ("int8 dX (port)", ("int8_tc_kernel<true", "prepass_kernel")),
                ("swiglu (port)", ("swiglu_fwd_kernel", "swiglu_bwd_kernel")),
                ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                ("sort (sampling)", ("sort",)),
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


def kernel_times(prof, counts: dict | None = None) -> tuple[dict, int]:
    """({kernel name: device microseconds}, device operations) of a
    torch.profiler run; ``counts``, where given, gets each name's launches."""
    import torch

    per_kernel: dict = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            launches += 1
            if counts is not None:
                counts[ev.name] = counts.get(ev.name, 0) + 1
    return per_kernel, launches


def profile_decode(engine, vocab: int, seed: int, phase: str):
    """Device busy share of decode-only steps: 8 one-token requests (no
    prefill), 3 warm-up steps, 5 unprofiled steps (wall time, host time of
    the decode program's call, its device span), then 5 steps under
    torch.profiler. Busy time
    is the sum of the kernels' device intervals (one stream, so they do not
    overlap); the rest of the wall time the card waits for the host. Also
    the device ms a decode step by KERNEL_KINDS kind, and returns the
    launches a decode step of each kernel name."""
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
    # unprofiled first: the step's wall time, the host time of the decode
    # program's call (a graph's replay) and the device span from just
    # before that call to just after it (CUDA events)
    prog, host, spans = engine._decode_prog, [], []

    def timed():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        prog()
        host.append(time.perf_counter() - t)
        b.record()
        spans.append((a, b))

    engine._decode_prog = timed
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    engine._decode_prog = prog
    say(phase, unprofiled_decode_steps=steps, step_ms=round(1e3 * plain_wall / steps, 3),
        program_call_host_ms=round(1e3 * sum(host) / steps, 3),
        program_device_span_ms=round(sum(a.elapsed_time(b) for a, b in spans) / steps, 3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in reqs:
        engine.cancel(r)
    counts: dict = {}
    per_kernel, launches = kernel_times(prof, counts)
    busy = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    say(phase, profiled_decode_steps=steps, step_ms=round(1e3 * wall / steps, 3),
        device_busy_ms_per_step=round(1e3 * busy / steps, 3),
        device_busy_share=round(busy / wall, 4) if busy else "not measured",
        device_ops_per_step=launches / steps)
    say(phase, device_ms_per_step_by_kind=json.dumps(
        {k: round(v / steps, 4) for k, v in by_kind(per_kernel).items()}))
    for name, us in top:
        print(f"  {phase} top kernel: {us / 1e3 / steps:.4f} ms/step {name[:90]}", flush=True)
    return {name: n / steps for name, n in counts.items()}


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
# phase 2, the eleventh slice's kernels: fp16 int8, RMSNorm's composed-form
# rounding, attention past 256 columns
# ---------------------------------------------------------------------------

# fp16 x int8 products are exact in f32; the kernel and the plain version
# sum them in f32 in another order and round once to fp16: one fp16 step
# relative plus GEMM_ATOL_FRAC of the largest output
GEMM_FP16_RTOL = 2.0 ** -10
# flash past 256 columns (the wide route): (label, B, Sq, Sk, H, Hk, hd,
# causal); the last case streams the most boxes (16) into four chunks
WIDE_FLASH_CASES = (("hd320_s2048_causal", 1, 2048, 2048, 8, 2, 320, True),
                    ("hd512_s1024", 1, 1024, 1024, 8, 2, 512, False),
                    ("hd1024_sq512_sk1024_causal", 1, 512, 1024, 4, 1, 1024, True))
# paged attention past 256 (the kernel's wide mode), timed at ragged
# lengths: (label, lengths, attention_inputs shape)
WIDE_PAGED_CASES = (("hd320", RAGGED, dict(H=16, Hk=4, hd=320)),
                    ("hd512", RAGGED, dict(H=8, Hk=2, hd=512)),
                    ("bs512_hd128", [0, 300, 511, 1023, 17, 700, 1000, 5], dict(bs=512, MB=2)),
                    ("hd1024", RAGGED, dict(H=8, Hk=2, hd=1024)))
# held only, as PAGED_CASES: every dtype at head dims 520 and 1024, pages of
# 300 slots, the copying producer (hd 300 in bf16) and two passes
WIDE_PAGED_HELD = (("fp16_hd320", RAGGED, 16, 4, 320, 16, 64, "float16"),
                   ("f32_hd320", RAGGED, 16, 4, 320, 16, 64, "float32"),
                   ("hd520", RAGGED, 8, 2, 520, 16, 64, "bfloat16"),
                   ("f32_hd512_bs8", RAGGED, 8, 2, 512, 8, 128, "float32"),
                   ("fp16_hd1024", RAGGED, 8, 2, 1024, 16, 64, "float16"),
                   ("f32_hd1024", RAGGED, 4, 1, 1024, 16, 64, "float32"),
                   ("bs300", [0, 299, 300, 1023, 17, 700, 899, 5], 32, 8, 128, 300, 4,
                    "bfloat16"),
                   ("f32_bs300_hd64", [0, 299, 300, 1023, 17, 700, 899, 5], 32, 8, 64, 300, 4,
                    "float32"),
                   ("hd300_copies", RAGGED, 16, 4, 300, 16, 64, "bfloat16"),
                   ("gqa12_hd320", RAGGED, 24, 2, 320, 16, 64, "bfloat16"))


def hold_fp16_gemm(label, got, want) -> float:
    diff = (got.float() - want.float()).abs()
    tol = GEMM_FP16_RTOL * want.float().abs() + GEMM_ATOL_FRAC * want.float().abs().max()
    if got.dtype.itemsize != 2 or not bool((diff <= tol).all()):
        raise AssertionError(f"{label} differs from its plain version: max abs err "
                             f"{diff.max().item()} ({got.dtype})")
    return diff.max().item()


def check_int8_fp16(gen):
    """fp16 activations on the int8 kernels (what an fp16 int8 serving
    engine reaches through ``decode_matmul``): the weight stream at every
    GEMM_SHAPES shape and STREAM_M, held against the plain version, the
    decode step at M = 8 timed beside its bound, the plain version and
    cuBLAS on fp16 weights dequantized before the timing (``library_ms``);
    then the tensor-core kernel at M = 8192 over one layer's seven
    projections, the same way. Returns (stream step, tensor-core layer, the
    tensor-core kernel's launches by the held calls)."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    layer = dict(step)
    err_s = err_t = 0.0
    nbytes = flops = lbytes = lflops = tc_launches = 0
    for name, K, N, per_step in GEMM_SHAPES:
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        w16 = w.half()
        for M in STREAM_M:
            x = torch.randn((M, K), generator=gen, device="cuda").half()
            err_s = max(err_s, hold_fp16_gemm(f"int8_matmul fp16 {name} M={M}",
                                              qm.int8_matmul(x, w, s), qm.int8_matmul_ref(x, w, s)))
            if M != 8:
                continue
            b = M * K * 2 + K * N + N * 4 + M * N * 2
            nbytes, flops = nbytes + per_step * b, flops + per_step * 2 * M * K * N
            step["bound_ms"] += per_step * bound_ms(b, 2 * M * K * N)[0]
            for key, fn, it in (("ms", lambda i: qm.int8_matmul(x, w, s), 20),
                                ("plain_ms", lambda i: qm.int8_matmul_ref(x, w, s), 5),
                                ("library_ms", lambda i: torch.matmul(x, w16) * s, 20)):
                step[key] += per_step * device_ms(fn, 1, it)
        if name != "lm_head":
            x = torch.randn((8192, K), generator=gen, device="cuda").half()
            before = qm.int8_matmul_large_m.launches
            got = qm.int8_matmul(x, w, s)
            tc_launches += qm.int8_matmul_large_m.launches - before
            err_t = max(err_t, hold_fp16_gemm(f"int8_matmul_large_m fp16 {name} M=8192",
                                              got, qm.int8_matmul_ref(x, w, s)))
            b, f = 8192 * K * 2 + K * N + N * 4 + 8192 * N * 2, 2 * 8192 * K * N
            lbytes, lflops = lbytes + b, lflops + f
            layer["bound_ms"] += bound_ms(b, f)[0]
            for key, fn, it in (("ms", lambda i: qm.int8_matmul_large_m(x, w, s), 5),
                                ("plain_ms", lambda i: qm.int8_matmul_ref(x, w, s), 2),
                                ("library_ms", lambda i: torch.matmul(x, w16) * s, 5)):
                layer[key] += device_ms(fn, 1, it)
        del w, s, w16, x
        torch.cuda.empty_cache()
    step.update(max_abs_err=err_s, bound_by=bound_ms(nbytes, flops)[1],
                at="fp16 x, sum over one Llama-3-8B decode step at M=8 (225 calls); held at "
                   "M 1, 8, 16, 64; library: cuBLAS on fp16 weights dequantized before the "
                   "timing, times the scales")
    layer.update(max_abs_err=err_t, bound_by=bound_ms(lbytes, lflops)[1],
                 at="fp16 x, one Llama-3-8B layer's 7 projections at M=8192; library: cuBLAS "
                    "on fp16 weights, times the scales")
    for label, nums in (("decode_step_M8_fp16", step), ("layer_M8192_fp16", layer)):
        say("kernels", kernel="int8_matmul", case=label,
            **{k: (round(v, 5) if isinstance(v, float) and k != "max_abs_err" else v)
               for k, v in nums.items() if k != "at"})
    return step, layer, tc_launches


def check_rms_round_first(gen):
    """RMSNorm's composed-form mode (``round_first``, what TrainStep runs)
    at [8192, 4096] bf16 and a ragged N, forward and dx against the plain
    versions of that mode (the forward's bits too, with the plain fused
    version as a control: ROUND_MISMATCH_MAX), timed at [8192, 4096] beside the bound, the plain
    version and ``F.rms_norm`` (forward) / aten's fused backward."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_norm as fn

    eps, res, errs = 1e-5, {}, [0.0, 0.0]
    for N, H in ((8192, 4096), (37, 4096)):
        n_bufs = 3 if N * H * 2 > L2_BYTES // 4 else 1
        xs = [(torch.randn((N, H), generator=gen, device="cuda") * 3).bfloat16()
              for _ in range(n_bufs)]
        dos = [torch.randn((N, H), generator=gen, device="cuda").bfloat16()
               for _ in range(n_bufs)]
        w = (torch.rand((H,), generator=gen, device="cuda") + 0.5).bfloat16()
        out, inv = fn.rms_norm_fwd(xs[0], w, eps, round_first=True)
        ref_out, ref_inv = fn.rms_norm_fwd_ref(xs[0], w, eps, round_first=True)
        dx = fn.rms_norm_bwd_dx(xs[0], w, inv, dos[0], round_first=True)
        ref_dx = fn.rms_norm_bwd_dx_ref(xs[0], w, ref_inv, dos[0], round_first=True)
        for i, (got, want, name) in enumerate(((out, ref_out, "forward"),
                                               (dx, ref_dx, "backward dx"))):
            diff = (got.float() - want.float()).abs()
            tol = NORM_RTOL * want.float().abs() + NORM_ATOL_FRAC * want.float().abs().max()
            if not bool((diff <= tol).all()):
                raise AssertionError(f"RMSNorm round_first {name} [{N}, {H}] differs from its "
                                     f"plain version: max abs err {diff.max().item()}")
            errs[i] = max(errs[i], diff.max().item())
        fused_out = fn.rms_norm_fwd_ref(xs[0], w, eps)[0]
        mismatch = (out != ref_out).float().mean().item()
        control = (out != fused_out).float().mean().item()
        say("kernels", kernel="rms_norm_fwd", mode="round_first", shape=f"[{N}, {H}]",
            bits_differing_from_plain=mismatch, bits_differing_from_plain_fused=control,
            limit=ROUND_MISMATCH_MAX)
        if mismatch > ROUND_MISMATCH_MAX or control <= ROUND_MISMATCH_MAX:
            raise AssertionError(f"RMSNorm round_first forward [{N}, {H}]: bits differ from the "
                                 f"plain round_first version on {mismatch} of the elements and "
                                 f"from the plain fused version on {control} (limit "
                                 f"{ROUND_MISMATCH_MAX}: the first must be within it, the "
                                 "control past it)")
        if N != 8192:
            continue
        invs = [fn.rms_norm_fwd(x, w, eps, round_first=True)[1] for x in xs]
        row = N * H * 2
        rstds = [torch.ops.aten._fused_rms_norm(x, [H], w, eps)[1] for x in xs] \
            if hasattr(torch.ops.aten, "_fused_rms_norm_backward") else None
        res["fwd"] = {
            "ms": device_ms(lambda i: fn.rms_norm_fwd(xs[i], w, eps, True), n_bufs),
            "plain_ms": device_ms(lambda i: fn.rms_norm_fwd_ref(xs[i], w, eps, True), n_bufs),
            "library_ms": device_ms(lambda i: F.rms_norm(xs[i], (H,), w, eps), n_bufs),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(2 * row + H * 2 + N * 4, 4 * N * H))),
            "at": f"[{N}, {H}] bf16, round_first; library: torch.nn.functional.rms_norm"}
        res["bwd"] = {
            "ms": device_ms(lambda i: fn.rms_norm_bwd_dx(xs[i], w, invs[i], dos[i], True),
                            n_bufs),
            "plain_ms": device_ms(lambda i: fn.rms_norm_bwd_dx_ref(xs[i], w, invs[i], dos[i],
                                                                   True), n_bufs),
            "library_ms": None if rstds is None else device_ms(
                lambda i: torch.ops.aten._fused_rms_norm_backward(
                    dos[i], xs[i], [H], rstds[i], w, [True, False]), n_bufs),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(3 * row + H * 2 + N * 4, 8 * N * H))),
            "at": f"[{N}, {H}] bf16, round_first; library: "
                  "torch.ops.aten._fused_rms_norm_backward (dx only)"}
        del xs, dos, invs, rstds
        torch.cuda.empty_cache()
    res["fwd"]["max_abs_err"], res["bwd"]["max_abs_err"] = errs
    for key in ("fwd", "bwd"):
        say("kernels", kernel=f"rms_norm_{key}", mode="round_first",
            **{k: (round(v, 5) if isinstance(v, float) and k != "max_abs_err" else v)
               for k, v in res[key].items() if k != "at"})
    return res["fwd"], res["bwd"]


def sdpa_backend(q, k, v, **kw) -> str:
    """The first SDPA backend, in PyTorch's order of preference, that takes
    these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, **kw)
            return backend.name
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend took the wide flash inputs")


def check_wide_attention(gen):
    """Attention past 256 columns. Flash's wide route (WIDE_FLASH_CASES,
    bf16): forward and backward against the plain versions tile by tile,
    timed beside the bound (bf16 peak), the plain version and SDPA with the
    backend it picks (K/V expanded to every head; causal with Sq != Sk as a
    bottom-right mask, ``causal_lower_right``); then its main path,
    ``nn.functional.flash_attention`` forward and backward on each case, the
    launch counts set to 0 before. Paged attention's wide mode through
    ``paged_decode_attention``: WIDE_PAGED_CASES held and timed as phase 2's
    paged cases, WIDE_PAGED_HELD held as PAGED_CASES (both against the plain
    version in f32), every call counted under the wide mode (the engine of
    phase 4 reads the kernel's name from a device trace). Returns ((flash fwd, flash bwd),
    flash launches, the hd 320 paged case's numbers)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    res, inputs = {}, {}
    for label, B, S, Sk, H, Hk, hd, causal in WIDE_FLASH_CASES:
        q, do = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
                 for _ in "qo")
        k, v = (torch.randn((B, Sk, Hk, hd), generator=gen, device="cuda").bfloat16()
                for _ in "kv")
        if fa.route(q) != "wide":
            raise AssertionError(f"flash {label} takes route {fa.route(q)}, not wide")
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
        errs = hold_flash(label, (out, lse), fa.flash_attention_fwd_ref(q, k, v, causal), grads,
                          fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal))
        pairs = general_pairs(B, S, Sk, H, causal)
        qo, kv, st = B * S * H * hd * 2, B * Sk * Hk * hd * 2, B * H * S * 4
        bf, byf = bound_ms(2 * qo + 2 * kv + st, 4 * pairs * hd)
        bb, byb = bound_ms(3 * qo + 4 * kv + 2 * st, 10 * pairs * hd)
        qt, dot = q.transpose(1, 2), do.transpose(1, 2)
        kt, vt = (t.repeat_interleave(H // Hk, dim=2).transpose(1, 2) for t in (k, v))
        kw = (dict(attn_mask=causal_lower_right(S, Sk)) if causal and S != Sk
              else dict(is_causal=causal))
        backend = sdpa_backend(qt, kt, vt, **kw)
        with sdpa_kernel([getattr(SDPBackend, backend)]):
            lib_fwd = device_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt, **kw), 1, 3)
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, **kw)
            lib_bwd = eager_ms(lambda i: torch.autograd.grad(lib_out, (ql, kl, vl), dot,
                                                             retain_graph=True), 1, 2, 1)
        fwd = dict(max_abs_err=errs["fwd_err"], tile_err=errs["out_tile_err"],
                   ms=device_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 1, 2, 2),
                   plain_ms=eager_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v, causal),
                                     1, 1, 1),
                   bound_ms=bf, bound_by=byf, library_ms=lib_fwd, library_backend=backend)
        bwd = dict(max_abs_err=errs["bwd_err"], tile_err=max(errs["dq_dk_dv_tile_err"]),
                   ms=device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                                                 causal), 1, 2, 2),
                   plain_ms=eager_ms(lambda i: fa.flash_attention_bwd_ref(
                       q, k, v, do, lse, delta, causal), 1, 1, 1),
                   bound_ms=bb, bound_by=byb, library_ms=lib_bwd, library_backend=backend)
        for key, nums in (("fwd", fwd), ("bwd", bwd)):
            say("kernels", kernel=f"flash_attention_{key}", route="wide", case=label,
                chunks=list(fa.chunk_plan(hd)),
                **{k2: (round(v2, 5) if isinstance(v2, float) and "err" not in k2 else v2)
                   for k2, v2 in nums.items()},
                bound_share=round(nums["bound_ms"] / nums["ms"], 4),
                library_ratio=round(nums["ms"] / nums["library_ms"], 4))
        res[label] = (fwd, bwd)
        inputs[label] = (q, k, v, do, causal, out)
        del ql, kl, vl, lib_out, qt, kt, vt, dot, grads, delta, lse
        torch.cuda.empty_cache()
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        w.by_route.update(dict.fromkeys(fa.ROUTES, 0))
    for label, (q, k, v, do, causal, out) in inputs.items():
        qs = q.detach().requires_grad_(True)
        got, _ = PF.flash_attention(qs, k, v, causal=causal)
        got.backward(do)
        torch.cuda.synchronize()
        if not torch.equal(got.detach(), out):
            raise AssertionError(f"nn.functional.flash_attention ({label}) differs from the "
                                 "wide route's forward kernel")
    launches = {"fwd": dict(fa.flash_attention_fwd.by_route),
                "bwd": dict(fa.flash_attention_bwd.by_route)}
    want = dict.fromkeys(fa.ROUTES, 0)
    want["wide"] = len(inputs)
    if launches != {"fwd": want, "bwd": want}:
        raise AssertionError(f"the wide flash path launched {launches}, expected {want}")
    say("kernels", kernel="flash_attention", main_path="nn.functional.flash_attention past 256 "
        "columns, forward and backward", launches_by_route=json.dumps(launches))
    del inputs
    torch.cuda.empty_cache()

    paged = {}
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.by_route.update(dict.fromkeys(pa.MODES, 0))
    for label, lengths, shape in WIDE_PAGED_CASES:
        r = time_paged(gen, label, lengths, shape=shape, hold_f32=True)
        say("kernels", kernel="paged_attention_wide", case=label, lengths=lengths,
            held_against="the plain version in f32",
            **{k: (round(v, 5) if isinstance(v, float) and "err" not in k else v)
               for k, v in r.items()}, bound_share=round(r["bound_ms"] / r["ms"], 4),
            library_ratio=round(r["ms"] / r["library_ms"], 4))
        paged[label] = r
    hold_paged_cases(gen, WIDE_PAGED_HELD, wide=True)
    launches_by_mode = dict(pa.paged_decode_attention.by_route)
    say("kernels", kernel="paged_attention", mode="wide",
        launches_by_mode=json.dumps(launches_by_mode))
    if launches_by_mode["narrow"] or launches_by_mode["wide"] <= 0 or \
            launches_by_mode["wide"] != pa.paged_decode_attention.launches:
        raise AssertionError(f"the wide paged cases launched {launches_by_mode}: want the wide "
                             "mode only")
    fwd, bwd = res[WIDE_FLASH_CASES[0][0]]
    fwd["at"] = ("B1 S2048 H8 Hk2 hd320 causal bf16, the wide route (chunks of 192 and 128 "
                 "columns); bound at 989 TFLOP/s; library: SDPA "
                 f"({fwd['library_backend']}) over K/V expanded to every head")
    bwd["at"] = fwd["at"] + ", backward alone by torch.autograd.grad (eager)"
    nums = dict(paged["hd320"])
    nums["at"] = ("8 lanes, H16 Hk4 hd320 bs16 MB64, ragged lengths, bf16, the kernel's wide "
                  "mode; library: SDPA over the gathered window")
    return (fwd, bwd), launches["fwd"]["wide"], nums


# ---------------------------------------------------------------------------
# phase 5: training kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_inputs(gen, B, S, H, Hk, hd, f32: bool = False):
    import torch

    def draw(heads):
        x = torch.randn((B, S, heads, hd), generator=gen, device="cuda")
        return x if f32 else x.bfloat16()

    return draw(H), draw(Hk), draw(Hk), draw(H)


def flash_counts(causal: bool, B, S, H, Hk, hd, es: int = 2):
    """(forward bytes, backward bytes, forward FLOPs, backward FLOPs) of one
    call on ``es``-byte elements: every input read once and every output
    written once; 4 FLOPs per (query, key, dim) pair the mask keeps in the
    forward (two products), 10 in the backward (five products)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    qo, kv, stats = B * S * H * hd * es, B * S * Hk * hd * es, B * H * S * 4
    fwd_bytes = 2 * qo + 2 * kv + stats                   # q k v in; o lse out
    bwd_bytes = 3 * qo + 4 * kv + 2 * stats               # q k v dO lse delta in; dq dk dv out
    return fwd_bytes, bwd_bytes, 4 * pairs * B * H * hd, 10 * pairs * B * H * hd


def hold_flash(label, fwd, ref_fwd, grads, ref_grads) -> dict:
    """Hold the kernels' (out, lse) and (dq, dk, dv) against the plain
    versions'; raise past the limits (FLASH_F32_TILE_RTOL for f32,
    FLASH_TILE_RTOL otherwise). Returns the errors."""
    import torch

    from paddle_tpu_torch.ops.flash_attention import tile_errors

    def tile_err(got, want):
        return tile_errors(got, want, FLASH_TILE, FLASH_TILE_FLOOR)

    (out, lse), (ref_out, ref_lse) = fwd, ref_fwd
    rtol = FLASH_F32_TILE_RTOL if out.dtype == torch.float32 else FLASH_TILE_RTOL
    out_tile, out_err = tile_err(out, ref_out)
    lse_err = ((lse - ref_lse).abs() - FLASH_LSE_RTOL * ref_lse.abs()).clamp_min(0).max().item()
    if not (out_tile <= rtol and lse_err <= FLASH_LSE_ATOL):
        raise AssertionError(f"flash forward ({label}) differs from its plain version: out "
                             f"{out_tile} of a tile's norm (tol {rtol}), lse "
                             f"{lse_err} (tol {FLASH_LSE_ATOL})")
    errs = [tile_err(g, w) for g, w in zip(grads, ref_grads)]
    if not all(t <= rtol for t, _ in errs):
        raise AssertionError(f"flash backward ({label}) differs from its plain version: "
                             f"dq/dk/dv {[t for t, _ in errs]} of a tile's norm "
                             f"(tol {rtol})")
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


def time_flash(gen, f32: bool = False):
    """The kernels at the training shape (B 1, S 8192, H 32, Hk 8, hd 128,
    causal) on the card, in bf16 (phase 7's calls) or in f32 (phase 14's:
    the f32 route), the plain versions on the same inputs (one call per
    KV-head group, 4 query heads each, so that the S x S scores fit), the
    kernels held against them (f32 with its TF32 control), and the library
    yardstick: SDPA forward, and its backward alone (``torch.autograd.grad``
    of one forward kept alive); bf16 through ``enable_gqa``, f32 over K/V
    expanded to every head, as phase 5's f32 case (faster in f32 than
    ``enable_gqa`` at S 2048 on the H100)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, Hk, hd = 1, TRAIN_SEQ, 32, 8, 128
    rep = H // Hk
    q, k, v, do = flash_inputs(gen, B, S, H, Hk, hd, f32)
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

    def plain():
        """((out, lse), (dq, dk, dv)) of the plain versions, group by group."""
        outs, lses = zip(*plain_fwd(0))
        return (torch.cat(outs, 2), torch.cat(lses, 1)), [torch.cat(t, 2)
                                                          for t in zip(*plain_bwd(0))]

    def plain_out_grads():
        (o, _), g = plain()
        return o, g

    ref_fwd, ref_grads = plain()
    errs = hold_flash("training_shape" + ("_f32" if f32 else ""), (out, lse), ref_fwd, grads,
                      ref_grads)
    control = tf32_control(plain_out_grads, ref_fwd[0], ref_grads) if f32 else {}
    del ref_fwd, ref_grads, grads
    ms_fwd = device_ms(lambda i: fa.flash_attention_fwd(q, k, v, True), 1, 5)
    ms_bwd = device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta, True), 1, 5)
    plain_fwd_ms = eager_ms(plain_fwd, 1, 2, 1)
    plain_bwd_ms = eager_ms(plain_bwd, 1, 2, 1)
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    if f32:
        kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
        gqa = {}
    else:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        gqa = {"enable_gqa": True}

    def lib_fwd(i):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)

    lib_fwd_ms = device_ms(lib_fwd, 1, 5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, **gqa)
    lib_bwd_ms = eager_ms(lambda i: torch.autograd.grad(lib_out, (ql, kl, vl), dot,
                                                        retain_graph=True), 1, 5, 2)

    def lib_fwd_bwd(i):
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, **gqa)
        torch.autograd.grad(o, (ql, kl, vl), dot)

    lib_fwd_bwd_ms = eager_ms(lib_fwd_bwd, 1, 5, 2)
    fwd_b, bwd_b, fwd_f, bwd_f = flash_counts(True, B, S, H, Hk, hd, q.element_size())
    peak = ATTN_F32_FLOP_PER_S if f32 else BF16_FLOP_PER_S
    bf, byf = bound_ms(fwd_b, fwd_f, peak)
    bb, byb = bound_ms(bwd_b, bwd_f, peak)
    dt = "f32" if f32 else "bf16"
    say("train-kernels", kernel="flash_attention", case="training_shape", B=B, S=S, H=H,
        Hk=Hk, hd=hd, causal=True, dtype=dt, route=fa.route(q),
        **{k_: v_ for k_, v_ in errs.items() if k_ not in ("fwd_err", "bwd_err")}, **control,
        ms_fwd=round(ms_fwd, 5), bound_ms_fwd=round(bf, 5),
        plain_ms_fwd=round(plain_fwd_ms, 5), library_ms_fwd=round(lib_fwd_ms, 5),
        ms_bwd=round(ms_bwd, 5), bound_ms_bwd=round(bb, 5), plain_ms_bwd=round(plain_bwd_ms, 5),
        library_ms_bwd=round(lib_bwd_ms, 5), library_ms_fwd_bwd=round(lib_fwd_bwd_ms, 5),
        library_ratio_fwd=round(ms_fwd / lib_fwd_ms, 4), library_ratio_bwd=round(ms_bwd / lib_bwd_ms, 4),
        bound_share_fwd=round(bf / ms_fwd, 4), bound_share_bwd=round(bb / ms_bwd, 4),
        TFLOPs_fwd=round(fwd_f / ms_fwd / 1e9, 1), TFLOPs_bwd=round(bwd_f / ms_bwd / 1e9, 1))
    del q, k, v, do, out, lse, delta, qt, kt, vt, dot, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    at = (f"B1 S{S} H{H} Hk{Hk} hd{hd} causal {dt}, max_abs_err and tile_err at this "
          f"shape; plain version in {Hk} calls of one KV-head group each")
    if f32:
        at += ("; bound at 989 / 3 TFLOP/s (two bf16 pieces, three products); library: SDPA "
               "over K/V expanded to every head (f32)")
    else:
        at += "; library: F.scaled_dot_product_attention(is_causal, enable_gqa)"
    return ({"max_abs_err": errs["fwd_err"], "tile_err": errs["out_tile_err"], "ms": ms_fwd,
             "plain_ms": plain_fwd_ms, "bound_ms": bf, "bound_by": byf, "library_ms": lib_fwd_ms,
             "library_ratio": ms_fwd / lib_fwd_ms, "bound_share": bf / ms_fwd, "at": at},
            {"max_abs_err": errs["bwd_err"], "tile_err": max(errs["dq_dk_dv_tile_err"]),
             "ms": ms_bwd, "plain_ms": plain_bwd_ms, "bound_ms": bb, "bound_by": byb,
             "library_ms": lib_bwd_ms, "library_ratio": ms_bwd / lib_bwd_ms,
             "bound_share": bb / ms_bwd,
             "at": at + ", backward alone by torch.autograd.grad (eager)"})


def general_pairs(B, sq, sk, H, causal) -> int:
    """The (query, key) pairs a call needs: bottom-right causal rows see
    ``min(sk, i + sk - sq + 1)`` keys, a row that sees no key is uniform
    over all sk of them."""
    if not causal:
        return B * H * sq * sk
    off = sk - sq
    dead = max(0, min(sq, -off))
    live = sum(min(sk, i + off + 1) for i in range(dead, sq))
    return B * H * (dead * sk + live)


@contextlib.contextmanager
def tf32_matmuls():
    """f32 matrix products in TF32 (10 mantissa bits) for the controls."""
    import torch

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def tf32_control(plain, ref_out, ref_grads) -> dict:
    """The f32 flash limit's control: ``plain()``, the plain f32 versions'
    ``(out, (dq, dk, dv))``, run with TF32 matmuls (what a kernel that
    rounded its operands to TF32 would compute), read tile by tile against
    the same plain versions in full f32. Raises unless every reading
    exceeds FLASH_F32_TILE_RTOL, so the limit can fail such a kernel.
    Returns the readings."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def tile_err(got, want):
        return fa.tile_errors(got, want, FLASH_TILE, FLASH_TILE_FLOOR)[0]

    with tf32_matmuls():
        out_t, grads_t = plain()
    reads = [tile_err(out_t, ref_out), *(tile_err(a, b) for a, b in zip(grads_t, ref_grads))]
    if not all(r > FLASH_F32_TILE_RTOL for r in reads):
        raise AssertionError(f"the TF32 control of the f32 flash limit reads {reads}, not all "
                             f"above FLASH_F32_TILE_RTOL {FLASH_F32_TILE_RTOL}")
    return {"tf32_control_out_dq_dk_dv_tile_err": reads, "f32_tile_rtol": FLASH_F32_TILE_RTOL}


def check_flash_general(gen):
    """Flash beyond the square bf16 case (FLASH_GENERAL_CASES): forward (out,
    lse) and backward (dQ, dK, dV, on the kernel forward's lse and delta)
    against the plain versions tile by tile, each timed beside its bound
    (bf16 cases at the bf16 peak, f32 at 989 / 3), the plain version and one
    library call (SDPA over K/V expanded to every head; bottom-right causal
    through ``causal_lower_right``, since ``is_causal`` aligns top-left; its
    backward alone by ``torch.autograd.grad``). Then the padded route's main
    path: ``nn.functional.flash_attention`` (the user's entry point) on the
    head_dim 96, 80 and 256 cases, forward and backward, with the launch
    counts set to 0 just before and read just after. Returns the numbers of
    the head_dim 96 case, forward and backward, and those launches (the f32
    route's kernels line comes from ``time_flash(gen, f32=True)`` and phase
    14)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops import flash_attention as fa

    res = {}
    inputs = {}
    for label, B, sq, sk, H, Hk, hd, causal, dt in FLASH_GENERAL_CASES:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        q, do = (torch.randn((B, sq, H, hd), generator=gen, device="cuda").to(dtype)
                 for _ in "qo")
        k, v = (torch.randn((B, sk, Hk, hd), generator=gen, device="cuda").to(dtype)
                for _ in "kv")
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
        again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
        ref_fwd = fa.flash_attention_fwd_ref(q, k, v, causal)
        ref_grads = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash ({label}) backward is not deterministic")
        errs = hold_flash(label, (out, lse), ref_fwd, grads, ref_grads)
        control = {}
        if dt == "f32":
            control = tf32_control(lambda: (
                fa.flash_attention_fwd_ref(q, k, v, causal)[0],
                fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)), ref_fwd[0], ref_grads)
        del ref_fwd, ref_grads, again
        peak = ATTN_F32_FLOP_PER_S if dt == "f32" else BF16_FLOP_PER_S
        es = q.element_size()
        pairs = general_pairs(B, sq, sk, H, causal)
        qo, kv, st = B * sq * H * hd * es, B * sk * Hk * hd * es, B * H * sq * 4
        bf, byf = bound_ms(2 * qo + 2 * kv + st, 4 * pairs * hd, peak)
        bb, byb = bound_ms(3 * qo + 4 * kv + 2 * st, 10 * pairs * hd, peak)
        ms_fwd = device_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 1, 5)
        ms_bwd = device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta, causal),
                           1, 5)
        plain_fwd = eager_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v, causal), 1, 1, 1)
        plain_bwd = eager_ms(lambda i: fa.flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                                                  causal), 1, 1, 1)
        rep = H // Hk
        qt, dot = q.transpose(1, 2), do.transpose(1, 2)
        kt, vt = (t.repeat_interleave(rep, dim=2).transpose(1, 2) for t in (k, v))
        mask = causal_lower_right(sq, sk) if causal and sq != sk else None
        kw = dict(attn_mask=mask) if mask is not None else dict(is_causal=causal)
        lib_fwd = device_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt, **kw), 1, 5)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, **kw)
        lib_bwd = eager_ms(lambda i: torch.autograd.grad(lib_out, (ql, kl, vl), dot,
                                                         retain_graph=True), 1, 3, 1)
        nums = dict(max_abs_err=errs["fwd_err"], tile_err=errs["out_tile_err"], ms=ms_fwd,
                    plain_ms=plain_fwd, bound_ms=bf, bound_by=byf, library_ms=lib_fwd)
        nums_b = dict(max_abs_err=errs["bwd_err"], tile_err=max(errs["dq_dk_dv_tile_err"]),
                      ms=ms_bwd, plain_ms=plain_bwd, bound_ms=bb, bound_by=byb,
                      library_ms=lib_bwd)
        say("train-kernels", kernel="flash_attention", case=label, B=B, sq=sq, sk=sk, H=H,
            Hk=Hk, hd=hd, causal=causal, dtype=dt,
            route=fa.route(q),
            out_tile_err=errs["out_tile_err"], lse_err=errs["lse_err"],
            dq_dk_dv_tile_err=errs["dq_dk_dv_tile_err"], **control, bit_identical_grads=True,
            ms_fwd=round(ms_fwd, 5), bound_ms_fwd=round(bf, 5),
            plain_ms_fwd=round(plain_fwd, 5), library_ms_fwd=round(lib_fwd, 5),
            ms_bwd=round(ms_bwd, 5), bound_ms_bwd=round(bb, 5),
            plain_ms_bwd=round(plain_bwd, 5), library_ms_bwd=round(lib_bwd, 5),
            library_ratio_fwd=round(ms_fwd / lib_fwd, 4),
            library_ratio_bwd=round(ms_bwd / lib_bwd, 4),
            bound_share_fwd=round(bf / ms_fwd, 4), bound_share_bwd=round(bb / ms_bwd, 4))
        res[label] = (nums, nums_b)
        if label.startswith("hd"):
            inputs[label] = (q, k, v, do, causal, out)
        del ql, kl, vl, lib_out, qt, kt, vt, dot, grads, delta, lse
        torch.cuda.empty_cache()

    # the padded route's main path, through the user's entry point
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        w.by_route.update(dict.fromkeys(fa.ROUTES, 0))
    for label, (q, k, v, do, causal, out) in inputs.items():
        qs = q.detach().requires_grad_(True)
        got, _ = PF.flash_attention(qs, k, v, causal=causal)
        got.backward(do)
        torch.cuda.synchronize()
        if not torch.equal(got.detach(), out):
            raise AssertionError(f"nn.functional.flash_attention ({label}) differs from the "
                                 "padded route's forward kernel")
    launches = {"fwd": dict(fa.flash_attention_fwd.by_route),
                "bwd": dict(fa.flash_attention_bwd.by_route)}
    say("train-kernels", kernel="flash_attention", main_path="nn.functional.flash_attention "
        "on the head_dim 96, 80 and 256 cases, forward and backward",
        launches_by_route=json.dumps(launches))
    want = dict.fromkeys(fa.ROUTES, 0)
    want["padded"] = len(inputs)
    if launches != {"fwd": want, "bwd": want}:
        raise AssertionError(f"the padded flash path launched {launches}, expected {want}")
    del inputs
    torch.cuda.empty_cache()
    fwd, bwd = res["hd96_s2048_causal"]
    fwd["at"] = ("B1 S2048 H32 Hk8 hd96 causal bf16; bound at 989 TFLOP/s on the true head_dim; "
                 "library: SDPA over K/V expanded to every head (bf16)")
    bwd["at"] = fwd["at"] + ", backward alone by torch.autograd.grad (eager)"
    return (fwd, bwd), launches["fwd"]["padded"]


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


def check_int8_f32_train(gen):
    """f32 activations at one Llama-3-8B layer's seven projections, M =
    8192: the tensor-core forward and dX (each with its split pre-pass)
    against the plain versions (the same three-piece products), timed
    beside the bound (three bf16 products a product: 989 / 3 TFLOP/s), the
    plain version and cuBLAS in f32 (TF32 off); the split pre-pass alone
    (the forward's x and dX's dO * s of every projection) against
    ``split3``, bit for bit, beside its byte bound. Then an f32
    ``QuantizedLinear`` of the q projection's shape, forward and backward,
    with the launch counts set to 0 just before: two pre-passes, one
    forward, one dX."""
    import torch

    from paddle_tpu_torch.nn import quant as nq
    from paddle_tpu_torch.ops import quant_matmul as qm

    M = TRAIN_SEQ
    tot = {key: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                 "max_abs_err": 0.0} for key in ("fwd", "dx")}
    split = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for name, K, N, _ in GEMM_SHAPES[:7]:
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        x = torch.randn((M, K), generator=gen, device="cuda")
        do = torch.randn((M, N), generator=gen, device="cuda")
        wf = w.float()
        calls = {"fwd": (lambda i: qm.int8_matmul_large_m(x, w, s),
                         lambda i: qm.int8_matmul_ref(x, w, s),
                         lambda i: torch.matmul(x, wf) * s,
                         M * K * 4 + K * N + N * 4 + M * N * 4),
                 "dx": (lambda i: qm.int8_matmul_dx(do, w, s),
                        lambda i: qm.int8_matmul_dx_ref(do, w, s),
                        lambda i: torch.matmul(do * s, wf.T),
                        M * N * 4 + K * N + N * 4 + M * K * 4)}
        for key, (kern, plain, library, nbytes) in calls.items():
            r = tot[key]
            r["max_abs_err"] = max(r["max_abs_err"], hold_gemm_f32(
                f"int8 {key} f32 {name}", kern(0), plain(0), K if key == "fwd" else N))
            r["bound_ms"] += bound_ms(nbytes, 2 * M * K * N, INT8_F32_FLOP_PER_S)[0]
            r["ms"] += device_ms(kern, 1, 3)
            r["plain_ms"] += eager_ms(plain, 1, 1, 1)
            r["library_ms"] += device_ms(library, 1, 2)
        for a, sc in ((x, None), (do, s)):
            got = qm.int8_prepass(a, sc)
            if not torch.equal(got, qm.split3(a if sc is None else a * sc)):
                raise AssertionError(f"int8_prepass ({name}) differs from split3")
            nbytes = a.numel() * (4 + 6) + (0 if sc is None else sc.numel() * 4)
            split["bytes"] += nbytes
            split["bound_ms"] += bound_ms(nbytes, a.numel() * 6)[0]
            split["ms"] += device_ms(lambda i: qm.int8_prepass(a, sc), 1, 10)
            split["plain_ms"] += device_ms(
                lambda i: qm.split3(a if sc is None else a * sc), 1, 3)
        del w, s, x, do, wf, got
        torch.cuda.empty_cache()
    for key, r in tot.items():
        say("int8-kernels", kernel="int8_matmul_large_m" if key == "fwd" else "int8_matmul_dx",
            case="one_layer_M8192_f32_split", bound_by="operations",
            **{k_: round(v_, 5) for k_, v_ in r.items()})
    say("int8-kernels", kernel="int8_prepass", case="one_layer_M8192_f32_split",
        **{k_: round(v_, 5) if isinstance(v_, float) else v_ for k_, v_ in split.items()})

    # the main path of the split: an f32 QuantizedLinear, forward and backward
    lin = torch.nn.Module()
    lin.weight = torch.randn((4096, 4096), generator=gen, device="cuda") * 0.02
    lin.bias = None
    ql = nq.QuantizedLinear(lin)
    x = torch.randn((M, 4096), generator=gen, device="cuda").requires_grad_(True)
    qm.int8_prepass.launches = qm.int8_matmul_large_m.launches = qm.int8_matmul_dx.launches = 0
    ql(x).sum().backward()
    torch.cuda.synchronize()
    launches = {"int8_prepass": qm.int8_prepass.launches,
                "int8_matmul_large_m": qm.int8_matmul_large_m.launches,
                "int8_matmul_dx": qm.int8_matmul_dx.launches}
    say("int8-kernels", main_path="f32 QuantizedLinear 4096 -> 4096, M 8192, forward and "
        "backward", **launches)
    if launches != {"int8_prepass": 2, "int8_matmul_large_m": 1, "int8_matmul_dx": 1}:
        raise AssertionError(f"the f32 QuantizedLinear launched {launches}")
    if not bool(torch.isfinite(x.grad).all()):
        raise AssertionError("the f32 QuantizedLinear's input gradient is not finite")
    del ql, lin, x
    torch.cuda.empty_cache()


def check_int8_prepass(gen):
    """The pre-pass on the fine-tuning path: dX's bf16(dO * bf16(s)) at one
    layer's seven projections, M = 8192, against the plain version bit for
    bit, timed beside its byte bound; the one PyTorch call computing it
    (``dO * s.bfloat16()``) is the plain version and the library call
    both. Returns the numbers, summed over the seven."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    r = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for name, K, N, _ in GEMM_SHAPES[:7]:
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        do = torch.randn((TRAIN_SEQ, N), generator=gen, device="cuda").bfloat16()
        if not torch.equal(qm.int8_prepass(do, s), do * s.bfloat16()):
            raise AssertionError(f"int8_prepass ({name}, bf16) differs from dO * bf16(s)")
        nbytes = do.numel() * 4 + N * 4
        r["bytes"] += nbytes
        r["bound_ms"] += bound_ms(nbytes, do.numel())[0]
        r["ms"] += device_ms(lambda i: qm.int8_prepass(do, s), 1, 10)
        r["plain_ms"] += device_ms(lambda i: do * s.bfloat16(), 1, 10)
        del s, do
    torch.cuda.empty_cache()
    say("int8-kernels", kernel="int8_prepass", case="one_layer_M8192_bf16_dx",
        **{k_: round(v_, 5) if isinstance(v_, float) else v_ for k_, v_ in r.items()})
    return {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["plain_ms"],
            "at": f"dX's bf16(dO * bf16(s)) summed over the seven projections of one "
                  f"Llama-3-8B layer at M={TRAIN_SEQ}; max_abs_err against dO * "
                  "s.bfloat16() (bit for bit), which is also the library call; the f32 "
                  "split's numbers are phase 8's int8_prepass f32 line; launches from the "
                  f"{TRAIN_STEPS} timed int8 fine-tuning steps ({TRAIN_LAYERS} layers)"}


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
# phase 11: the ring's kernels against their plain versions
# ---------------------------------------------------------------------------


def check_ring_merge(gen) -> dict:
    """The merge kernel against its plain version at every case (a third
    of the rows merged with lse_b = -1e30, which must come back bit for
    bit), each causal merge at the training shape timed beside its byte
    bound and the same merge composed of torch ops (the plain version; no
    single PyTorch call computes it). Returns the first case's numbers."""
    import torch

    from paddle_tpu_torch.ops import ring_flash as rf

    res, err_max, causal_ms = None, 0.0, []
    for N, S, H, D, n_out in MERGE_CASES:
        acc = torch.randn((N, S, H, D), generator=gen, device="cuda")
        out_b = torch.randn((N, S, H, D), generator=gen, device="cuda").bfloat16()
        lse = torch.randn((N, H, S), generator=gen, device="cuda") * 2 + 8
        lse_b = torch.randn((N, H, S), generator=gen, device="cuda") * 2 + 8
        lse_b[:, :, ::3] = -1e30
        got = [acc.clone(), lse.clone(), torch.zeros((n_out, S, H, D), dtype=torch.bfloat16,
                                                     device="cuda") if n_out else None]
        want = [None if t is None else t.clone() for t in got]
        rf.ring_merge(*got[:2], out_b, lse_b, got[2])
        rf.ring_merge_plain(*want[:2], out_b, lse_b, want[2])
        torch.cuda.synchronize()
        (ga, gl, go), (wa, wl, wo) = got, want
        err = (ga - wa).abs().max().item()
        lse_err = (gl - wl).abs().max().item()
        out_err = (go.float() - wo.float()).abs() if n_out else torch.zeros(1, device="cuda")
        ok = (bool(((ga - wa).abs() <= MERGE_RTOL * wa.abs()
                    + MERGE_ATOL_FRAC * wa.abs().max()).all())
              and lse_err <= MERGE_LSE_ATOL
              and (not n_out or bool((out_err <= 2.0 ** -7 * wo.float().abs() + 1e-6).all())))
        same = torch.equal(ga[:, ::3], acc[:, ::3]) and torch.equal(gl[:, :, ::3], lse[:, :, ::3])
        if not (ok and same):
            raise AssertionError(f"ring_merge [{N}, {S}, {H}, {D}] (finishing {n_out}) differs "
                                 f"from its plain version: acc {err}, lse {lse_err}, out "
                                 f"{out_err.max().item()}, masked rows unchanged: {same}")
        err_max = max(err_max, err)
        nums = dict(N=N, S=S, H=H, D=D, finished=n_out, acc_err=err, lse_err=lse_err,
                    out_err=out_err.max().item(), masked_rows_unchanged=same)
        if S == TRAIN_SEQ // RING:
            nbytes = N * S * H * D * (4 + 4 + 2) + n_out * S * H * D * 2 + N * H * S * 4 * 3
            b_ms, b_by = bound_ms(nbytes, 10 * N * S * H * D)
            ms = device_ms(lambda i: rf.ring_merge(ga, gl, out_b, lse_b, go), 1)
            plain_ms = device_ms(lambda i: rf.ring_merge_plain(wa, wl, out_b, lse_b, wo), 1, 5)
            causal_ms.append(ms)
            if res is None:
                res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=None,
                           at=f"acc [{N}, {S}, {H}, {D}] f32, out_b bf16, one finished rank "
                              "written in bf16 (the first merge of a causal ring forward at "
                              "the training shape); library: none (plain_ms is the merge "
                              "composed of torch ops); launches from the timed ring training "
                              "steps")
            nums.update(ms=round(ms, 5), bound_ms=round(b_ms, 5), plain_ms=round(plain_ms, 5),
                        GBps=round(nbytes / ms / 1e6, 1))
        say("ring-kernels", kernel="ring_merge", **nums)
        del acc, out_b, lse, lse_b, got, want, ga, gl, go, wa, wl, wo
        torch.cuda.empty_cache()
    res.update(max_abs_err=err_max, ms_causal_forward=sum(causal_ms))
    say("ring-kernels", kernel="ring_merge",
        ms_of_one_causal_forward=round(sum(causal_ms), 5), merges=len(causal_ms))
    return res


def ring_lse(lse, P: int):
    """A folded ring's lse [P * B, H, S / P] as the sequence's [B, H, S]."""
    n, H, Sl = lse.shape
    return lse.reshape(P, n // P, H, Sl).permute(1, 2, 0, 3).reshape(n // P, H, P * Sl)


def check_ring(gen):
    """Every ring case through ``ring_attention``, the user's entry point
    (its gate sends every case to the kernels, the ragged shard of 1000
    positions too): forward and backward through torch autograd (twice,
    bit-identical, for all but the training shape), the launches of one
    call (flash forward and backward P times, the merge P - 1 times), the
    forward and backward held against the same schedule through the plain
    versions and against the full-sequence flash kernel; then, at the
    training shape, the timing beside the full flash kernel, the bound and
    the SDPA yardstick. Returns the merge's and the ring's numbers."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops import ring_flash as rf

    merge = check_ring_merge(gen)
    counters = {"fwd": (fa.flash_attention_fwd.by_route, "wgmma"),
                "bwd": (fa.flash_attention_bwd.by_route, "wgmma"),
                "merge": (vars(rf.ring_merge), "launches")}
    ring = None
    for label, B, S, P, H, Hk, hd, causal in RING_CASES:
        timed = label == RING_CASES[0][0]
        q, k, v, do = flash_inputs(gen, B, S, H, Hk, hd)
        runs = []
        for _ in range(1 if timed else 2):
            before = read_counts(counters)
            qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            out = ra.ring_attention(qs, ks, vs, P, causal)
            out.backward(do)
            runs.append((out.detach(), qs.grad, ks.grad, vs.grad))
            launched = {key: n - before[key] for key, n in read_counts(counters).items()}
            if launched != {"fwd": P, "bwd": P, "merge": P - 1}:
                raise AssertionError(f"ring ({label}) launched {launched} in one call")
        fq, fk, fv, fdo = (rf.fold(t, P) for t in (q, k, v, do))
        out_k, lse_k = rf.ring_flash_fwd(fq, fk, fv, P, causal)
        grads_k = rf.ring_flash_bwd(fq, fk, fv, out_k, lse_k, fdo, P, causal)
        with plain_kernels():
            ref_fwd = rf.ring_flash_fwd(fq, fk, fv, P, causal)
            ref_grads = rf.ring_flash_bwd(fq, fk, fv, out_k, lse_k, fdo, P, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[-1])):
            raise AssertionError(f"ring flash attention ({label}) is not deterministic")
        if not all(torch.equal(rf.unfold(a, P), b) for a, b in zip((out_k, *grads_k), runs[0])):
            raise AssertionError(f"ring flash attention ({label}): the autograd op differs "
                                 "from the forward and backward it is made of")
        plain_errs = hold_flash(f"ring {label}, vs the plain schedule", (out_k, lse_k),
                                ref_fwd, grads_k, ref_grads)
        del ref_fwd, ref_grads
        full_out, full_lse = fa.flash_attention_fwd(q, k, v, causal)
        qf, kf, vf = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        fa.flash_attention(qf, kf, vf, causal).backward(do)
        full_errs = hold_flash(f"ring {label}, vs the full flash kernel",
                               (runs[0][0], ring_lse(lse_k, P)), (full_out, full_lse),
                               runs[0][1:], (qf.grad, kf.grad, vf.grad))
        nums = dict(case=label, B=B, S=S, P=P, H=H, Hk=Hk, hd=hd, causal=causal,
                    bit_identical_grads=not timed or "not repeated",
                    **{f"plain_{k_}": v_ for k_, v_ in plain_errs.items()
                       if k_.endswith("tile_err") or k_ == "lse_err"},
                    **{f"full_{k_}": v_ for k_, v_ in full_errs.items()
                       if k_.endswith("tile_err") or k_ == "lse_err"})
        if timed:
            delta = (do.float() * full_out.float()).sum(-1).transpose(1, 2).contiguous()
            t = dict(
                ms_fwd=device_ms(lambda i: rf.ring_flash_fwd(fq, fk, fv, P, causal), 1, 5),
                ms_bwd=device_ms(lambda i: rf.ring_flash_bwd(fq, fk, fv, out_k, lse_k, fdo, P,
                                                             causal), 1, 5),
                full_ms_fwd=device_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 1, 5),
                full_ms_bwd=device_ms(lambda i: fa.flash_attention_bwd(
                    q, k, v, do, full_lse, delta, causal), 1, 5))
            with plain_kernels():
                t["plain_ms_fwd"] = eager_ms(lambda i: rf.ring_flash_fwd(fq, fk, fv, P, causal),
                                             1, 2, 1)
                t["plain_ms_bwd"] = eager_ms(lambda i: rf.ring_flash_bwd(
                    fq, fk, fv, out_k, lse_k, fdo, P, causal), 1, 2, 1)
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            t["library_ms_fwd"] = device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 1, 5)
            ql, kl, vl = (x.detach().requires_grad_(True) for x in (qt, kt, vt))

            def lib_fwd_bwd(i):
                o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
                torch.autograd.grad(o, (ql, kl, vl), dot)

            t["library_ms_fwd_bwd"] = eager_ms(lib_fwd_bwd, 1, 5, 2)
            fwd_b, bwd_b, fwd_f, bwd_f = flash_counts(causal, B, S, H, Hk, hd)
            t["bound_ms_fwd"], by = bound_ms(fwd_b, fwd_f)
            t["bound_ms_bwd"], _ = bound_ms(bwd_b, bwd_f)
            nums.update({k_: round(v_, 5) for k_, v_ in t.items()})
            nums["ms_fwd_bwd_vs_full_flash"] = round(
                (t["ms_fwd"] + t["ms_bwd"]) / (t["full_ms_fwd"] + t["full_ms_bwd"]), 4)
            ring = {"max_abs_err": max(plain_errs["fwd_err"], plain_errs["bwd_err"]),
                    "tile_err": max(plain_errs["out_tile_err"],
                                    *plain_errs["dq_dk_dv_tile_err"]),
                    "full_flash_tile_err": max(full_errs["out_tile_err"],
                                               *full_errs["dq_dk_dv_tile_err"]),
                    "ms": t["ms_fwd"] + t["ms_bwd"],
                    "plain_ms": t["plain_ms_fwd"] + t["plain_ms_bwd"],
                    "bound_ms": t["bound_ms_fwd"] + t["bound_ms_bwd"], "bound_by": by,
                    "library_ms": t["library_ms_fwd_bwd"], **t,
                    "at": f"B{B} S{S} P{P} H{H} Hk{Hk} hd{hd} causal bf16, forward and "
                          "backward (ms is their sum, the backward from the forward's out "
                          "and lse); max_abs_err and tile_err against the plain schedule; "
                          "library: SDPA forward and torch.autograd.grad (eager) over the "
                          "whole sequence; launches are the flash forward, flash backward "
                          "and merge launches the ring's calls made in the timed ring "
                          "training steps (P + P + P - 1 a call, one call a layer)"}
            del ql, kl, vl, delta
        say("ring-kernels", kernel="ring_flash_attention", **nums)
        del q, k, v, do, runs, fq, fk, fv, fdo, out_k, lse_k, grads_k, full_out, full_lse
        del qf, kf, vf
        torch.cuda.empty_cache()
    return merge, ring


def check_ring_f32(gen):
    """The ring in f32 (phase 11): the merge kernel with an f32 partial
    against its plain version, and ``ring_attention`` (the gate, which sends
    f32 to the ring schedule over flash's f32 route) at B 1, S 2048,
    P 4, H 32, Hk 8, hd 128, causal, forward
    and backward, held tile by tile against the same schedule through the
    plain versions and against the full-sequence flash kernel, with the
    launches of one call."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops import ring_flash as rf

    N, S, H, D = 3, 1000, 8, 64
    acc, out_b = (torch.randn((N, S, H, D), generator=gen, device="cuda") for _ in "ab")
    lse, lse_b = (torch.randn((N, H, S), generator=gen, device="cuda") * 2 + 8 for _ in "ab")
    got = [acc.clone(), lse.clone(), torch.zeros((1, S, H, D), device="cuda")]
    want = [t.clone() for t in got]
    rf.ring_merge(*got[:2], out_b, lse_b, got[2])
    rf.ring_merge_plain(*want[:2], out_b, lse_b, want[2])
    torch.cuda.synchronize()
    merge_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if not all(bool(((a - b).abs() <= MERGE_RTOL * b.abs() + MERGE_ATOL_FRAC * b.abs().max()
                     ).all()) for a, b in zip(got, want)):
        raise AssertionError(f"ring_merge with an f32 partial differs: {merge_err}")

    B, S, P, H, Hk, hd = 1, 2048, RING, 32, 8, 128
    q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda")
                   for n in (H, Hk, Hk, H))
    if not ra.flash_runs(q):
        raise AssertionError("the ring's gate keeps f32 composed on the card")
    def counts():
        return (fa.flash_attention_fwd.by_route["f32"], fa.flash_attention_bwd.by_route["f32"],
                rf.ring_merge.launches)

    before = counts()
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = ra.ring_attention(qs, ks, vs, P, True)
    out.backward(do)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(counts(), before))
    if launched != (P, P, P - 1):
        raise AssertionError(f"the f32 ring launched {launched} (f32 flash fwd, bwd, merge)")
    fq, fk, fv, fdo = (rf.fold(t, P) for t in (q, k, v, do))
    out_k, lse_k = rf.ring_flash_fwd(fq, fk, fv, P, True)
    grads_k = rf.ring_flash_bwd(fq, fk, fv, out_k, lse_k, fdo, P, True)
    with plain_kernels():
        ref_fwd = rf.ring_flash_fwd(fq, fk, fv, P, True)
        ref_grads = rf.ring_flash_bwd(fq, fk, fv, out_k, lse_k, fdo, P, True)
    plain_errs = hold_flash("f32 ring, vs the plain schedule", (out_k, lse_k), ref_fwd,
                            grads_k, ref_grads)
    full_out, full_lse = fa.flash_attention_fwd(q, k, v, True)
    qf, kf, vf = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fa.flash_attention(qf, kf, vf, True).backward(do)
    full_errs = hold_flash("f32 ring, vs the full flash kernel",
                           (out.detach(), ring_lse(lse_k, P)), (full_out, full_lse),
                           (qs.grad, ks.grad, vs.grad), (qf.grad, kf.grad, vf.grad))
    say("ring-kernels", kernel="ring_flash_attention", case="f32_s2048_p4", B=B, S=S, P=P,
        H=H, Hk=Hk, hd=hd, causal=True, launched_f32_fwd_bwd_merge=list(launched),
        merge_f32_partial_err=merge_err,
        **{f"plain_{k_}": v_ for k_, v_ in plain_errs.items()
           if k_.endswith("tile_err") or k_ == "lse_err"},
        **{f"full_{k_}": v_ for k_, v_ in full_errs.items()
           if k_.endswith("tile_err") or k_ == "lse_err"})
    del q, k, v, do, qs, ks, vs, out, fq, fk, fv, fdo, out_k, lse_k, grads_k, ref_fwd
    del ref_grads, full_out, full_lse, qf, kf, vf
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

def training_counters() -> dict:
    """{name: (dict, key)}: where the launch count of each training and
    fine-tuning kernel lives (the int8 weight stream too, which a training
    step must not launch): a wrapper's ``launches`` among its attributes,
    flash's under each route of its ``by_route``, RMSNorm's also under each
    rounding mode of its ``by_mode``."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops import ring_flash as rf

    return {**{f"flash_{r}_{d}": (w.by_route, r) for r in fa.ROUTES
               for d, w in (("fwd", fa.flash_attention_fwd), ("bwd", fa.flash_attention_bwd))},
            **{f"{name}_{m}": (w.by_mode, m) for m in fn.MODES.values()
               for name, w in (("rms_norm_fwd", fn.rms_norm_fwd),
                               ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx))},
            **{name: (vars(w), "launches") for name, w in (
                ("rms_norm_fwd", fn.rms_norm_fwd), ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx),
                ("int8_matmul", qm.int8_matmul), ("int8_matmul_large_m", qm.int8_matmul_large_m),
                ("int8_matmul_dx", qm.int8_matmul_dx), ("int8_prepass", qm.int8_prepass),
                ("ring_merge", rf.ring_merge))}}


def read_counts(counters: dict) -> dict:
    return {name: d[key] for name, (d, key) in counters.items()}


def zero_counts(counters: dict):
    for d, key in counters.values():
        d[key] = 0


def expected_launches(layers: int, int8: bool = False, ring: int = 0,
                      f32: bool = False, traced: bool = True) -> dict:
    """Per training step: flash forward and backward once per layer (with
    a ring of P ranks, P times each and the merge P - 1 times, one ring
    call a layer), all on flash's f32 route in f32, else all on its wgmma
    route (head_dim 128); RMSNorm forward and backward twice per
    layer and once for the final norm; with int8-frozen projections, the
    tensor-core forward and dX once per projection (7 per layer), and never
    the weight stream. ``traced``: the step is a TrainStep (RMSNorm in its
    round_first mode), not an eager forward and backward."""
    from paddle_tpu_torch.ops.flash_attention import ROUTES

    proj = 7 * layers if int8 else 0
    flash = layers * max(ring, 1)
    route = "f32" if f32 else "wgmma"
    return {**{f"flash_{r}_{d}": flash if r == route else 0
               for r in ROUTES for d in ("fwd", "bwd")},
            "rms_norm_fwd": 2 * layers + 1, "rms_norm_bwd_dx": 2 * layers + 1,
            # a TrainStep runs the composed form's rounding (a traced call);
            # an eager forward and backward the fused one
            **{f"rms_norm_{d}_{mode}": (2 * layers + 1) * (traced == (mode == "round_first"))
               for d in ("fwd", "bwd_dx") for mode in ("fused", "round_first")},
            "int8_matmul": 0, "int8_matmul_large_m": proj, "int8_matmul_dx": proj,
            "int8_prepass": proj, "ring_merge": layers * max(ring - 1, 0)}


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
def plain_kernels(tf32_flash: bool = False):
    """Route the training ops' autograd functions to the plain versions for
    the reference path of phases 6, 9 and 14. The package has no such
    switch: a CUDA tensor always reaches the kernel. With ``tf32_flash`` the
    plain flash versions take their f32 products in TF32 (phase 14's
    control)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops import ring_flash as rf

    def in_tf32(fn):
        def run(*args, **kwargs):
            with tf32_matmuls():
                return fn(*args, **kwargs)
        return run

    fwd, bwd = fa.flash_attention_fwd_ref, fa.flash_attention_bwd_ref
    if tf32_flash:
        fwd, bwd = in_tf32(fwd), in_tf32(bwd)
    swaps = ((fa, "flash_attention_fwd", fwd),
             (fa, "flash_attention_bwd", bwd),
             (fn, "rms_norm_fwd", fn.rms_norm_fwd_ref),
             (fn, "rms_norm_bwd_dx", fn.rms_norm_bwd_dx_ref),
             (qm, "int8_matmul", qm.int8_matmul_ref),
             (qm, "int8_matmul_dx", qm.int8_matmul_dx_ref),
             (rf, "ring_merge", rf.ring_merge_plain))
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


def f32_matmuls() -> str:
    """Raise unless f32 matrix products run in full f32 (torch's default:
    TF32 off, precision "highest"); returns the setting."""
    import torch

    prec = torch.get_float32_matmul_precision()
    if torch.backends.cuda.matmul.allow_tf32 or prec != "highest":
        raise AssertionError(f"f32 matmuls run in TF32 (precision {prec!r})")
    return prec


def check_train_step(seed: int, int8: bool = False, f32: bool = False):
    """Phase 6 (phase 9 with ``int8``: every projection int8-frozen; phase 14
    with ``f32``: the model at its default f32, flash on its f32 route): the
    same 2-layer model and batch through the kernels and through the plain
    versions. In f32 the plain path runs once more with its flash in TF32,
    a control that the gradient limit must fail."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    phase = "int8-step-check" if int8 else "f32-step-check" if f32 else "train-step-check"
    loss_tol, grad_tol = (F32_STEP_LOSS_RTOL, F32_STEP_GRAD_FRAC) if f32 else (
        STEP_LOSS_RTOL, STEP_GRAD_FRAC)
    dtype = torch.float32 if f32 else torch.bfloat16
    extra = {"f32_matmul_precision": f32_matmuls()} if f32 else {}
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS)
    kern = LlamaForCausalLM(cfg, device="cuda", dtype=dtype, seed=seed)
    plain = LlamaForCausalLM(cfg, device="cuda", dtype=dtype, seed=seed + 1)
    if int8:
        quantize_projections(kern)
        quantize_projections(plain)
    plain.load_state_dict(kern.state_dict())
    ids, labels = token_batch(np.random.RandomState(seed + 2), CHECK_SEQ, cfg.vocab_size)
    counters = training_counters()
    results = {}
    runs = (("kernel", kern), ("plain", plain)) + ((("tf32_control", plain),) if f32 else ())
    for name, model in runs:
        before = read_counts(counters)
        with (plain_kernels(tf32_flash=name == "tf32_control") if name != "kernel"
              else contextlib.nullcontext()):
            loss, _ = model(ids, labels=labels)
            loss.backward()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in read_counts(counters).items()}
        want = (expected_launches(CHECK_LAYERS, int8, f32=f32, traced=False)
                if name == "kernel" else dict.fromkeys(counters, 0))
        if launched != want:
            raise AssertionError(f"{name} path launched {launched}, expected {want}")
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        results[name] = (loss.item(), grads)
    (loss_k, grads_k), (loss_p, grads_p) = results["kernel"], results["plain"]

    def grad_frac(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    worst = (0.0, "")
    for n, gp in grads_p.items():
        frac = grad_frac(grads_k[n], gp)
        worst = max(worst, (frac, n))
        if not (math.isfinite(frac) and frac <= grad_tol):
            raise AssertionError(f"gradient of {n}: kernel and plain paths differ by {frac} of "
                                 f"its largest magnitude (tol {grad_tol})")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not loss_rel <= loss_tol:
        raise AssertionError(f"loss: kernel path {loss_k}, plain path {loss_p}")
    if f32:
        loss_c, grads_c = results.pop("tf32_control")
        ctrl = max((grad_frac(grads_c[n], gp), n) for n, gp in grads_p.items())
        extra.update(control_worst_grad_frac=ctrl[0], control_worst_grad=ctrl[1],
                     control_loss_rel_diff=abs(loss_c - loss_p) / abs(loss_p))
        if not ctrl[0] > grad_tol:
            raise AssertionError(f"the TF32 control of the f32 step reads {ctrl[0]} ({ctrl[1]}), "
                                 f"not above the gradient limit {grad_tol}")
        del grads_c
    n_trainable = len(grads_p)
    del grads_k, grads_p, results
    steps, losses = {}, {}
    for name, model in (("kernel", kern), ("plain", plain)):
        steps[name] = make_train_step(model)
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            losses[name] = steps[name](ids, labels).item()
    torch.cuda.synchronize()
    if not abs(losses["kernel"] - losses["plain"]) <= loss_tol * abs(losses["plain"]):
        raise AssertionError(f"TrainStep losses differ: {losses}")
    # the state is in named_parameters() order on both
    tols = {"m": grad_tol, "v": 2 * grad_tol + grad_tol ** 2}
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
    say(phase, layers=CHECK_LAYERS, seq=CHECK_SEQ, trainable=n_trainable, **extra,
        loss_kernel=loss_k, loss_plain=loss_p, loss_rel_diff=loss_rel, loss_tol=loss_tol,
        worst_grad_frac=worst[0], worst_grad=worst[1], grad_tol=grad_tol,
        trainstep_loss_kernel=losses["kernel"], trainstep_loss_plain=losses["plain"],
        worst_m_frac=moment_worst["m"], m_tol=tols["m"], worst_v_frac=moment_worst["v"],
        v_tol=tols["v"])
    del kern, plain, steps
    torch.cuda.empty_cache()


def ring_mesh():
    """The one-process mesh of phases 12-13: a sep axis of RING ranks."""
    from paddle_tpu_torch.distributed import ProcessMesh

    return ProcessMesh(shape=[1, RING], dim_names=["dp", "sep"])


def check_ring_step(seed: int):
    """Phase 12: the same 2-layer model and batch through the ring
    (``context_parallel="ring"`` under a mesh whose sep axis has RING
    ranks) and without it, both through the kernels: the loss and every
    parameter's gradient agree within RING_STEP_LOSS_RTOL and
    RING_STEP_GRAD_FRAC."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    with ring_mesh():
        ring = LlamaForCausalLM(LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS,
                                                      context_parallel="ring"),
                                device="cuda", dtype=torch.bfloat16, seed=seed)
        full = LlamaForCausalLM(LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS),
                                device="cuda", dtype=torch.bfloat16, seed=seed + 1)
        full.load_state_dict(ring.state_dict())
        ids, labels = token_batch(np.random.RandomState(seed + 2), CHECK_SEQ,
                                  ring.config.vocab_size)
        counters = training_counters()
        results = {}
        for name, model, p in (("ring", ring, RING), ("full", full, 0)):
            before = read_counts(counters)
            loss, _ = model(ids, labels=labels)
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in read_counts(counters).items()}
            want = expected_launches(CHECK_LAYERS, ring=p, traced=False)
            if launched != want:
                raise AssertionError(f"{name} path launched {launched}, expected {want}")
            results[name] = (loss.item(), {n: q.grad for n, q in model.named_parameters()})
    (loss_r, grads_r), (loss_f, grads_f) = results["ring"], results["full"]
    worst = (0.0, "")
    for n, gf in grads_f.items():
        frac = ((grads_r[n].float() - gf.float()).abs().max()
                / gf.float().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (frac, n))
        if not (math.isfinite(frac) and frac <= RING_STEP_GRAD_FRAC):
            raise AssertionError(f"gradient of {n}: ring and full attention differ by {frac} "
                                 f"of its largest magnitude (tol {RING_STEP_GRAD_FRAC})")
    loss_rel = abs(loss_r - loss_f) / abs(loss_f)
    if not loss_rel <= RING_STEP_LOSS_RTOL:
        raise AssertionError(f"loss: ring {loss_r}, full attention {loss_f} "
                             f"({loss_rel} relative, tol {RING_STEP_LOSS_RTOL})")
    say("ring-step-check", layers=CHECK_LAYERS, seq=CHECK_SEQ, sep=RING, loss_ring=loss_r,
        loss_full=loss_f, loss_rel_diff=loss_rel, loss_tol=RING_STEP_LOSS_RTOL,
        worst_grad_frac=worst[0], worst_grad=worst[1], grad_tol=RING_STEP_GRAD_FRAC)
    del ring, full, results, grads_r, grads_f
    torch.cuda.empty_cache()


def train(seed: int, int8: bool = False, ring: int = 0, f32: bool = False,
          count: bool = True) -> dict:
    """Phase 7 (phase 10 with ``int8``: every projection int8-frozen, the
    embedding, norms and head trained; phase 13 with ``ring``: the ring's
    context parallelism over that many ranks, under the current mesh): the
    4-layer run; phase 14 with ``f32``: the model at its default f32 with
    F32_LAYERS layers. Returns the launch counts of the three timed steps,
    the mean step time and the profiled step's device ms by kind. Without
    ``count`` it reads no launch counter, so that ``tools/train_ab.py`` can
    time an older checkout's package with it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import QuantizedLinear

    phase = "finetune" if int8 else "ring-train" if ring else "f32-train" if f32 else "train"
    layers = F32_LAYERS if f32 else TRAIN_LAYERS
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                context_parallel="ring" if ring else None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32 if f32 else torch.bfloat16,
                             seed=seed)
    extra = {"dtype": "float32", "f32_matmul_precision": f32_matmuls()} if f32 else {}
    if int8:
        quantize_projections(model)
        frozen = [m for m in model.modules() if isinstance(m, QuantizedLinear)]
        extra = dict(int8_projections=len(frozen),
                     int8_weight_bytes=sum(m.weight.numel() for m in frozen),
                     scale_bytes=sum(4 * m.weight_scale.numel() for m in frozen))
    torch.cuda.synchronize()
    n_params = model.num_params()
    n_embed = model.llama.embed_tokens.weight.numel()
    say(phase, layers=layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
        seq=TRAIN_SEQ, trainable_params=n_params, **extra,
        model_init_s=round(time.perf_counter() - t0, 2))
    step = make_train_step(model)
    rng = np.random.RandomState(seed + 3)
    counters = training_counters() if count else {}
    per_step = expected_launches(layers, int8, ring, f32) if count else {}

    def run(n_steps):
        zero_counts(counters)
        losses, times = [], []
        for _ in range(n_steps):
            ids, labels = token_batch(rng, TRAIN_SEQ, cfg.vocab_size)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
        counts = read_counts(counters)
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
    attn_flops = layers * 3.5 * flash_counts(True, 1, TRAIN_SEQ, cfg.num_attention_heads,
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
        **({"f32_peak_share": round(model_flops / step_s / F32_FLOP_PER_S, 4)} if f32 else {}),
        max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        launches=counts, **({"sep": ring} if ring else {}))
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
    return {"launches": counts, "step_ms": 1e3 * step_s, "device_ms_by_kind": by_kind(per_kernel),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device_busy_share": busy / wall if busy else None}


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS")


def ptxas_kernels(log: str) -> list:
    """``[(kernel, registers, spill store bytes, spill load bytes)]`` of
    every kernel in an ``nvcc -Xptxas -v`` log, names demangled by
    ``cu++filt`` beside nvcc where there is one."""
    from paddle_tpu_torch.ops import _build

    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    tool = Path(_build.nvcc_path()).parent / "cu++filt"
    if rows and tool.is_file():
        names = subprocess.run([str(tool)], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.split(">(")[0] + ">" if ">(" in n else n
                r[0] = re.sub(r"\((?:int|bool)\)|void |<unnamed>::|\(anonymous namespace\)::| ",
                              "", n)
    return [tuple(r) for r in rows]


def sass_counts(names) -> dict | None:
    """{name: {opcode: count}} of SASS_OPS in the built library of each
    kernel in ``names`` (one cuobjdump each, run together), or None where
    the toolkit has no cuobjdump beside nvcc."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")

    def count(name):
        out = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300, check=True).stdout
        found = pattern.findall(out)
        return {op: found.count(op) for op in SASS_OPS}

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(count, names)))


def check_quant_sass():
    """SASS counts of each kernel of the quant_matmul library: the weight
    stream's (``int8_stream_kernel``) must hold HMMA (mma.sync) and UTMALDG
    and no HGMMA, the tensor-core kernel's (``int8_tc_kernel``) HGMMA and
    UTMALDG and no HMMA."""
    from paddle_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path("quant_matmul"))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    found = {"int8_stream_kernel": [], "int8_tc_kernel": []}
    for part in out.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        for kernel in found:
            if kernel in name:
                ops = pattern.findall(part)
                found[kernel].append({op: ops.count(op) for op in SASS_OPS})
    for kernel, rows in found.items():
        say("setup", sass_kernel=kernel, instantiations=len(rows),
            **{op: sum(r[op] for r in rows) for op in SASS_OPS})
        want, none = ("HMMA", "HGMMA") if kernel == "int8_stream_kernel" else ("HGMMA", "HMMA")
        if not rows or not all(r[want] > 0 and r["UTMALDG"] > 0 and r[none] == 0 for r in rows):
            raise AssertionError(f"{kernel}: each instantiation must hold {want} and UTMALDG "
                                 f"and no {none}: {rows}")


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
    marks, phase_s = [t_start], {}

    def lap(phase: str):
        """Seconds since the end of the phase before (the done line)."""
        marks.append(time.perf_counter())
        phase_s[phase] = round(marks[-1] - marks[-2], 1)

    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("setup", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(kind), count=torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _build.build()
    say("setup", build_s=round(time.perf_counter() - t0, 2), built=sorted(logs),
        **{f"build_s_{k}": round(v[1], 2) for k, v in logs.items()})
    for name, (log, _) in logs.items():
        for kernel, regs, stores, loads in ptxas_kernels(log):
            say("setup", ptxas=name, kernel=kernel, registers=regs, spill_stores=stores,
                spill_loads=loads)
            if "paged_decode_wide_kernel" in kernel and (stores or loads):
                raise AssertionError(f"{kernel} spills {stores} / {loads} bytes")
    sass = sass_counts(_build.KERNELS)
    if sass is None:
        say("setup", sass="no cuobjdump beside nvcc: no SASS counts")
    for name, counts in (sass or {}).items():
        say("setup", sass=name, **counts)
        if name == "flash_attention" and not (
                counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0):
            raise AssertionError(f"the {name} kernels are not wgmma fed by TMA: {counts}")
        if name == "quant_matmul":
            check_quant_sass()
        if name == "paged_attention" and not (counts["UTMALDG"] > 0 and counts["HMMA"] > 0):
            raise AssertionError(f"the paged-attention kernel is not mma.sync fed by TMA: "
                                 f"{counts}")
    lap("1")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    attn = check_attention(gen)
    gemm = check_int8(gen)
    fp16_step, fp16_layer, fp16_tc_launches = check_int8_fp16(gen)
    rms_rf = check_rms_round_first(gen)
    wide_flash, wide_flash_launches, wide_paged = check_wide_attention(gen)
    lap("2")

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
    bf16_reqs = serve(engine, prompts, NEW_TOKENS, "bf16-engine")
    # a graph's replays run the kernels its capture recorded, and the
    # wrappers count only where they call the launch: the warm-up and the
    # capture. The launches the device ran are read from a device trace.
    if paged_decode_attention.launches <= 0:
        raise AssertionError("the bf16 engine never called the paged-attention kernel")
    hold_captures(engine, "bf16-engine")
    compare_eager(model, serve_cfg, prompts, bf16_reqs, "bf16-engine")
    teacher_forced_check(engine, prompts)
    hold_decode_step(profile_decode(engine, cfg.vocab_size, args.seed, "bf16-engine"),
                     cfg.num_hidden_layers, False, "bf16-engine")
    attn_launches = trace_launches(engine, "bf16-engine", args.seed)["paged"]
    del engine
    torch.cuda.empty_cache()
    lap("3")
    check_sampling(model, serve_cfg, prompts, bf16_reqs, args.seed)
    lap("3s")
    check_nan_guard(model, serve_cfg, prompts)
    lap("3g")

    engine = ServingEngine(model, ServeConfig(weight_dtype="int8", **serve_cfg))
    say("int8-engine", layers=model.config.num_hidden_layers,
        weight_bytes=sum(t.numel() * t.element_size() for lw in engine._w["layers"]
                         for leaf in lw.values()
                         for t in (leaf.values() if isinstance(leaf, dict) else (leaf,))))
    paged_decode_attention.launches = 0
    int8_matmul.launches = int8_matmul_large_m.launches = 0
    int8_reqs = serve(engine, prompts, NEW_TOKENS, "int8-engine")
    agree = [a == b for r1, r2 in zip(bf16_reqs, int8_reqs)
             for a, b in zip(r1.generated, r2.generated)]
    say("int8-engine", greedy_top1_agreement_vs_bf16=round(sum(agree) / len(agree), 4))
    if paged_decode_attention.launches <= 0 or int8_matmul.launches <= 0:
        raise AssertionError("the int8 engine did not call both kernels")
    hold_captures(engine, "int8-engine")
    compare_eager(model, dict(weight_dtype="int8", **serve_cfg), prompts, int8_reqs,
                  "int8-engine")
    hold_decode_step(profile_decode(engine, cfg.vocab_size, args.seed, "int8-engine"),
                     cfg.num_hidden_layers, True, "int8-engine")
    gemm_launches = trace_launches(engine, "int8-engine", args.seed, int8=True)["stream"]
    del engine, model
    torch.cuda.empty_cache()
    fp16_launches = check_fp16_int8_engine(args.seed, serve_cfg, prompts)
    wide_paged_launches = check_wide_engine(args.seed, prompts)
    lap("4")

    flash_fwd, flash_bwd = check_flash(gen)
    padded, padded_launches = check_flash_general(gen)
    f32_fwd, f32_bwd = time_flash(gen, f32=True)
    from paddle_tpu_torch.ops import fused_norm

    for w in (fused_norm.rms_norm_fwd, fused_norm.rms_norm_bwd_dx):
        w.by_mode["fused"] = 0
    norm_fwd, norm_bwd = check_rms_norm(gen)
    norm_launches = {"fwd": fused_norm.rms_norm_fwd.by_mode["fused"],
                     "bwd": fused_norm.rms_norm_bwd_dx.by_mode["fused"]}
    lap("5")
    check_train_step(args.seed)
    lap("6")
    trained = train(args.seed)
    train_launches = trained["launches"]
    lap("7")
    int8_fwd, int8_dx = check_int8_train(gen)
    prepass = check_int8_prepass(gen)
    check_int8_f32_train(gen)
    swiglu_fwd, swiglu_bwd, swiglu_launches = check_swiglu(gen)
    lap("8")
    check_train_step(args.seed, int8=True)
    lap("9")
    finetune_launches = train(args.seed, int8=True)["launches"]
    lap("10")
    merge, ring = check_ring(gen)
    check_ring_f32(gen)
    lap("11")
    check_ring_step(args.seed)
    lap("12")
    with ring_mesh():
        ring_trained = train(args.seed, ring=RING)
    ring_launches = ring_trained["launches"]
    # the ring's launches: those of the flash and merge kernels its calls
    # made (every flash launch of phase 13 is a ring's, as its exact counts
    # show: P per layer, with P - 1 merges)
    ring_launches["ring_flash_attention"] = sum(
        ring_launches[k] for k in ("flash_wgmma_fwd", "flash_wgmma_bwd", "ring_merge"))
    per_step = expected_launches(TRAIN_LAYERS, ring=RING)["ring_merge"]
    merge["profiled_step_ms_per_launch"] = (
        ring_trained["device_ms_by_kind"].get("ring merge (port)", 0.0) / per_step)
    say("ring-train", step_ms_ratio_to_train=round(ring_trained["step_ms"] / trained["step_ms"], 4),
        train_step_ms=round(trained["step_ms"], 3),
        merge_device_ms_per_launch=round(merge["profiled_step_ms_per_launch"], 5))
    lap("13")
    check_train_step(args.seed, f32=True)
    f32_launches = train(args.seed, f32=True)["launches"]
    lap("14")

    kernels = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:68",
         "launches": attn_launches, "max_abs_err": attn["max_abs_err"],
         "ms": attn["ms"], "plain_ms": attn["plain_ms"], "bound_ms": attn["bound_ms"],
         "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
         "at": "8 lanes, H32 Hk8 hd128 bs16 MB64, ragged lengths, bf16 (full and skewed "
               "lengths on the kernels lines of phase 2); launches traced on the device in "
               "the graphed bf16 engine's traced window (8 requests, 3 prefill chunks)"},
        {"name": "int8_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:117",
         "launches": gemm_launches, "max_abs_err": gemm["max_abs_err"],
         "ms": gemm["ms"], "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
         "bf16_gemm_ms": gemm["bf16_gemm_ms"],
         "at": "sum over one Llama-3-8B decode step at M=8 (7 projections x 32 "
               "layers + lm_head), bf16; library_ms dequantizes then multiplies, "
               "bf16_gemm_ms multiplies weights dequantized before the timing (the bf16 "
               "engine's call); launches traced on the device in the graphed int8 "
               "engine's traced window (8 requests, 3 prefill chunks)"},
    ]
    for name, source, replaces, nums in (
            ("flash_attention_fwd", "flash_attention.cu", "flash_kernel.py:173", flash_fwd),
            ("flash_attention_bwd", "flash_attention.cu", "flash_kernel.py:208", flash_bwd)):
        wrapper = {"flash_attention_fwd": "flash_wgmma_fwd",
                   "flash_attention_bwd": "flash_wgmma_bwd"}[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}",
            "launches": train_launches[wrapper], **nums})
        kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed training steps "
                              f"({TRAIN_LAYERS} layers)")
    for name, nums, launches in (("rms_norm_fwd", norm_fwd, norm_launches["fwd"]),
                                 ("rms_norm_bwd", norm_bwd, norm_launches["bwd"])):
        kernels.append({
            "name": name, "route": "cuda", "source": "paddle_tpu_torch/csrc/rms_norm.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm.py:79", "launches": launches, **nums})
        kernels[-1]["at"] += ("; the fused rounding, which eager calls take (a TrainStep "
                              "takes round_first): launches from phase 5's checks")
    for name, source, replaces, nums, launches in (
            ("flash_attention_fwd_f32", "flash_attention.cu", "flash_attention.py:112",
             f32_fwd, f32_launches["flash_f32_fwd"]),
            ("flash_attention_bwd_f32", "flash_attention.cu", "flash_attention.py:112",
             f32_bwd, f32_launches["flash_f32_bwd"]),
            ("flash_attention_fwd_padded", "flash_attention.cu", "flash_attention.py:112",
             padded[0], padded_launches),
            ("flash_attention_bwd_padded", "flash_attention.cu", "flash_attention.py:112",
             padded[1], padded_launches),
            ("int8_matmul_large_m", "quant_matmul.cu", "quant_matmul.py:117", int8_fwd,
             finetune_launches["int8_matmul_large_m"]),
            ("int8_matmul_dx", "quant_matmul.cu", "quant_matmul.py:143", int8_dx,
             finetune_launches["int8_matmul_dx"]),
            ("int8_prepass", "quant_matmul.cu", "quant_matmul.py:143", prepass,
             finetune_launches["int8_prepass"]),
            ("swiglu_fwd", "swiglu.cu", "fused_norm.py:152", swiglu_fwd,
             swiglu_launches["swiglu_fwd"]),
            ("swiglu_bwd", "swiglu.cu", "fused_norm.py:152", swiglu_bwd,
             swiglu_launches["swiglu_bwd"])):
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": launches, **nums})
        if name in ("int8_matmul_large_m", "int8_matmul_dx"):
            kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed int8 fine-tuning "
                                  f"steps ({TRAIN_LAYERS} layers)")
        elif name.endswith("_f32"):
            kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed f32 training steps "
                                  f"({F32_LAYERS} layers)")
        elif name.endswith("_padded"):
            kernels[-1]["at"] += ("; launches from nn.functional.flash_attention on the head_dim "
                                  "96, 80 and 256 cases")
    for name, source, replaces, nums in (
            ("ring_merge", "csrc/ring_merge.cu", "ring_flash.py:44", merge),
            ("ring_flash_attention", "ops/ring_flash.py", "ring_flash.py:145", ring)):
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": ring_launches[name],
            **nums})
        kernels[-1]["at"] += (f" ({TRAIN_STEPS} steps, {TRAIN_LAYERS} layers, sep={RING})")
    for name, source, replaces, nums, launches, where in (
            ("int8_matmul_fp16", "quant_matmul.cu", "quant_matmul.py:117", fp16_step,
             fp16_launches, "the traced window of the graphed fp16 int8 engine "
             f"({FP16_INT8_LAYERS} layers)"),
            ("int8_matmul_large_m_fp16", "quant_matmul.cu", "quant_matmul.py:117", fp16_layer,
             fp16_tc_launches, "phase 2's held calls (no serving path runs M > 64)"),
            ("rms_norm_fwd_round_first", "rms_norm.cu", "fused_norm.py:79", rms_rf[0],
             train_launches["rms_norm_fwd_round_first"], f"the {TRAIN_STEPS} timed training "
             "steps (TrainStep runs the composed form's rounding)"),
            ("rms_norm_bwd_round_first", "rms_norm.cu", "fused_norm.py:79", rms_rf[1],
             train_launches["rms_norm_bwd_dx_round_first"],
             f"the {TRAIN_STEPS} timed training steps"),
            ("flash_attention_fwd_wide", "flash_attention.cu", "flash_attention.py:112",
             wide_flash[0], wide_flash_launches,
             "nn.functional.flash_attention past 256 columns (no model path runs them)"),
            ("flash_attention_bwd_wide", "flash_attention.cu", "flash_attention.py:112",
             wide_flash[1], wide_flash_launches, "the same calls' backward"),
            ("paged_decode_attention_wide", "paged_attention.cu", "paged_attention.py:68",
             wide_paged, wide_paged_launches,
             f"the traced window of the graphed {WIDE_ENGINE_LAYERS}-layer engine with pages "
             f"of {WIDE_ENGINE_CFG['block_size']} slots (its wide mode)")):
        kernels.append({
            "name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": launches,
            **{k: v for k, v in nums.items() if k not in ("tile_err", "eager_ms",
                                                          "library_max_abs_err", "bytes")}})
        kernels[-1]["at"] = kernels[-1].get("at", "") + f"; launches from {where}"
    say("done", total_s=round(time.perf_counter() - t_start, 1), phase_s=json.dumps(phase_s))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
