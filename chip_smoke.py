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
   int8 weight stream at M = 1, 8, 16, 40 (the speculative verify's rows)
   and 64 a shape, with the decode step's sum (225 calls, as one verify
   call's at M = 40) at each M, and a second yardstick, the bf16
   engine's own call (``torch.matmul`` on weights dequantized before the
   timing, twice the bytes), then with f32 activations at M = 8. Paged attention
   is timed at three length mixes (PAGED_TIMED: ragged, full, skewed) and
   held at more (PAGED_CASES: fp16, f32, head_dim 64/80/96/256, pages of
   8, 32 and 256 slots, a GQA group of 12 heads, one of 1, every lane
   inactive; head_dims 20, 100 and 6, whose rows TMA cannot map) with
   every hidden slot poisoned with NaN and +-Inf against
   the plain version on the same pools poisoned with 100.0; two calls bit
   for bit; lane 0's bits unchanged while the other lanes hold 1, 30 or
   1000 tokens, narrow and wide, each call against the CPU emulation of
   the kernel's schedule; one captured CUDA graph replayed after ``lengths`` and the
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
   failed with "nonfinite logits", the others equal to a clean run. The
   served trace also holds the observability plane (``profiler``): the
   registry's ``serve.admitted`` / ``completed`` / ``steps`` equal
   ``stats()``, ``serve.ttft_us`` counts a request each, the
   ``serve.decode.dispatch`` spans the decode calls, ``serve.compiles``
   the captures, and ``serve.decode_roofline_frac`` lies in (0, 1] and its
   ratio before the clamp in (0, ROOFLINE_CEIL];
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
   then one parameter group poisoned with NaN on the card: the numerics
   watchdog names it, ``train.numerics_events{kind=nonfinite}`` counts 1
   and the flight ring is dumped;
7. training: Llama-3-8B widths at 4 layers, batch 1 x seq 8192 seeded
   tokens, bf16, ``AdamW(3e-4, weight_decay=0.1)`` with global-norm
   clipping in ``TrainStep``: one warm-up and three timed steps, finite
   losses, exact launch counts (flash forward and backward once per layer
   per step, RMSNorm forward and backward 2 L + 1 times, the fused
   optimizer once per step, as in phases 10, 13 and 14), step time,
   tokens/s, model FLOPs share of bf16 peak, peak memory, and one profiled
   step's device-busy share. Numerics are at the default ``summary``: the
   sentinels' kernel runs once a step (exact), and on the profiled step
   (through ``paddle_tpu_torch.profiler.Profiler``) their ``grad_norm``
   agrees with the global-norm clip's norm of the same gradients within
   SENTINEL_NORM_RTOL, the nonfinite counts are 0 and the digest equals a
   host recomputation from copies of those gradients; the exported Chrome
   trace names the step's hand kernels; ``device_trace_summary`` of
   ``jit.dispatch`` agrees with the device's busy ms within
   DEVICE_TRACE_RTOL; ``jit.program_mfu{program=step}`` with the FLOPs
   share within MFU_RTOL, it and the roofline fraction before the clamp in
   (0, ROOFLINE_CEIL]; the goodput fraction lies in (0, 1]; two steps
   with ``telemetry_export_every=1`` write one snapshot each. Then a
   ``TrainStep(numerics="off")`` over the same model runs as many steps:
   both step times, the sentinels' device ms a step and both peaks;
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
   device ms by kind;
15. the prefix cache at Llama-3-8B width (32 layers, bf16, random weights
   from the seed; 8 lanes, pages of 16 slots, 1024 slots a lane, chunks of
   16): first the paged kernel over the prefix cache's tables (every lane's
   first 32 pages shared, one lane holding a fork of the last) held
   against its plain version, twice bit for bit, timed beside a bound
   that reads each shared row once, the plain version and SDPA; then a
   trace of 16 requests, 13 opening with one shared 512-token system
   prompt (12 with a private tail of 16-128 tokens, one with none: a COW
   fork), 32 tokens each, submitted at once to a cold engine and to a
   ``prefix_cache=True`` engine: hits, hit fraction, forks, the peak of
   shared blocks, TTFT p50 of each, and every request's greedy tokens
   equal to the cold engine's (the paged kernel's split schedule depends
   on each lane's own length only); one decode and one prefill capture;
   a traced window of 8 hits (one a fork) where the device must run paged
   attention once a layer in each decode call. Then the trace in waves of
   8 whose prefill ends in one step, greedy tokens bit for bit equal to
   the cold engine's; three system
   prompts in rotation, one request at a time, in a pool of 96 usable
   blocks with a host tier of 96 blocks (evictions to the host and
   restores) and without one (drops), each bit for bit equal to the cold
   engine; the waves with int8 weights against the int8 cold engine;
16. speculative decoding: the target of phase 15 and a draft at Meta's
   Llama-3.2-1B widths (hidden 2048, tied embeddings, random weights from
   seed 1, its rope_scaling left out) cut to DRAFT_LAYERS = 4 of its 16
   layers (the script's time limit), ``DraftConfig(k=4)``,
   8 lanes, SPEC_REQUESTS = 4 requests of 16-256 prompt tokens (8 before
   phase 28 took their time), 32 tokens each: the graphed
   engine (one capture each of draft decode, verify and prefill; each
   program's calls and device span, tokens/s, the accept rate) against
   the eager one, greedy tokens identical; one round's 5 verify logits a
   lane against the decode step's fed the same tokens, within
   SPEC_LOGITS_TOL_FRAC; greedy agreement with the non-speculative engine
   printed per request (not held: the verify's products run at M = 40,
   decode's at M = 8); the trace with every other request sampled, served
   twice bit for bit; an int8 target, graphed against eager, whose traced
   window runs the weight stream exactly 225 times a verify call and no
   other int8 kernel; and the f32 self-draft control (draft = target, 2
   layers of full width, TF32 off): tokens equal to the non-speculative
   f32 engine's at an accept rate of at least 0.95;
17. the fused optimizer step: phase 7's AdamW (weight decay 0.1,
   global-norm clip 1.0) over phase 7's 39 bf16 tensors (1,923,125,248
   parameters), the same seeded gradients to ``Optimizer.step()`` in its
   fused regime (the multi-tensor kernel, ``csrc/fused_optimizer.cu``) and
   in the per-parameter regime (``PADDLE_OPT_FUSED=0``, the card's
   composed update): parameters and moments bit for bit after each of 3
   steps, one launch a step; then the update alone timed (CUDA events
   around eager calls) beside its byte bound, its plain version, both
   whole steps and ``torch.optim.AdamW(fused=True)`` on the same tensors;
   (17s) the numerics sentinels' kernel (``csrc/sentinels.cu``) over
   phase 7's 39 gradients and 39 parameters with a NaN and Infs put in:
   digests and counts exactly its plain version's, sums of squares within
   SENTINEL_SQ_RTOL; timed beside its byte bound and the plain version;
18. mixed-precision training, Paddle's eager AMP loop
   (``paddle_tpu_torch.amp``: forward and loss under ``auto_cast``,
   ``GradScaler`` scale, backward, step, update, ``clear_grad``) with
   phase 7's AdamW and clip at Llama-3-8B widths, the model built in f32:
   (18a) the training cell (4 layers, batch 1 x 8192) at O2 bf16,
   ``decorate``-d (bf16 parameters, f32 masters), and (18b) at O1 (f32
   parameters, bf16 products), each one warm-up and 3 timed steps: step
   ms, tokens/s, share of the bf16 peak, peak memory, exact launches a
   step by kernel and mode (flash on its wgmma route, RMSNorm fused in
   f32, the fused optimizer once a step, in its master mode at O2), one
   profiled step's device ms by kind and the unscale's device ms; (18c) 2
   layers at seq 2048, 3 steps through the kernels against the same steps
   through the plain versions at O2 bf16, O1 bf16 and O2 fp16 with
   ``GradScaler(init_loss_scaling=1000.0)``: losses, masters, scaler
   state; then an fp16 step with an infinite gradient, skipped on both
   paths (state bit for bit, the scale halved, the step count unmoved);
   (18d) phase 17 with f32 masters: the kernel's master mode bit for bit
   against the composed update over 3 steps, timed beside its byte bound
   (28 bytes a parameter), its plain version and
   ``torch.optim.AdamW(fused=True)`` over f32 copies of the masters;
19. ERNIE-3.0 base (``ErnieConfig.base()``: vocab 40000, hidden 768, 12
   layers, 12 heads, FFN 3072), the sequence classifier (2 classes) in
   bf16, ``bench.py``'s ERNIE headline with ragged rows (each row's real
   length drawn from 16 to 128, pad id 0 after it): (19a) finetune, AdamW
   5e-5 through ``TrainStep`` at batch 32 x 128, dropout 0, 2 warm-up and 6
   timed steps: step ms, tokens/s padded and real, the bf16 peak share,
   peak memory, exact launches (the fused optimizer twice a step for 201
   tensors, no other kernel: the mask sends attention to the composed
   path), one profiled step's device ms by kind and top kernels, the
   masked attention's share (its own forward and backward timed at the
   step's shapes) and the optimizer's; then the observability plane's
   cost: turns of steps with numerics at ``summary``, ``off``, and off
   with telemetry off (no spans, no attribution), each step split into
   its host time and its wait for the device, the ``summary`` steps into
   the sentinels' enqueue, the wait before their copy and the host fold;
   (19d) ``EvalStep`` forwards at 32 x
   128 and 8 x 512: ms a batch and sequences/s; (19b) the config's dropout
   0.1 / 0.1: step ms, and from one set of weights two steps from one
   state of the model's generator give one loss, another state another;
   (19c) 3 steps of 19a twice, through the fused optimizer's kernel and
   through its plain version: parameters and moments bit for bit; (19e)
   the reference's separable task (class 1 rows start with token 1) at
   full width and the test's 2 layers under ``amp`` O2 (f32 masters,
   ``GradScaler``, the config's dropout) for 200 steps: the step at which
   the last 5 losses first average below 0.6 of the first 5, and below it
   at the end (the test's criterion).
20. the vision path: (20a) ``bench.py``'s ResNet-50 step,
   ``resnet50(num_classes=1000)`` cast to bf16, ``Momentum(0.1,
   momentum=0.9)`` through ``TrainStep`` at batch 64 x 3 x 224 x 224, 2
   warm-up and 6 timed steps: step ms, images/s, the convolutions' and the
   classifier's FLOPs (forward from the shapes, backward twice that) as a
   share of the bf16 peak, peak memory, exact launches (the fused
   optimizer twice a step for 161 tensors, no other kernel: convolutions
   are cuDNN's, batch norm and the pools torch's ops), one profiled step's
   device ms by kind (cuDNN forward, dgrad and wgrad, layout transposes,
   pools, reductions, elementwise, the optimizer) and top kernels, and the
   running statistics moved and finite; (20d) ``EvalStep`` forwards in
   eval mode at that batch: ms a batch and images/s; (20b) resnet18 and
   resnet50 in f32 (cuDNN without TF32) at 64 x 64, batch 4, against the
   same weights on the CPU: logits and every gradient within 16 times the
   CPU's own difference with the batch reversed, and a TF32 control past
   both limits; (20c) 3 steps of 20a at batch 16, each step's gradients
   taken once and fed to the fused optimizer's kernel and to its plain
   version: parameters, velocities and batch-norm buffers bit for bit,
   with the difference between two backward passes from one state
   printed; (20e) LeNet on the synthetic MNIST, Adam 3e-3, batch 64,
   through ``TrainStep``, the weights drawn on the CPU from the seed: after
   50 steps the last loss below 0.8 of the first and the accuracy on 256
   training images above 0.5 (``tests/test_train_lenet.py``'s criteria),
   then a 200-step run with the accuracy on the training split printed,
   and how many of seeds 0-7 meet the criteria; its batches come from the
   port's ``io.DataLoader`` on the card;
21. ``paddle.Model`` on the card (``hapi``, ``io``, ``vision.transforms``,
   ``metric``, ``save``/``load``): (21a) Paddle's quick start,
   ``Model(LeNet())`` with ``Adam(1e-3)``, ``nn.CrossEntropyLoss()`` and
   ``metric.Accuracy()``, ``fit`` one epoch of the synthetic MNIST
   normalised by 127.5 (the model's own loader on the card), a second
   epoch timed alone, ``evaluate`` and ``predict``: ``test_hapi_model_fit``'s criteria, predict's accuracy
   equal to evaluate's, the fused optimizer once a step; (21b) that fit
   for 20 steps over a ``shuffle=False`` loader on the card and on the
   CPU from one state, each loss within 16 times the CPU's own difference
   with every batch reversed; (21c) ``resnet50(num_classes=102)`` in f32
   on Flowers-102 (the synthetic surrogate) through ``fit``, the loader
   ``ToTensor``, ``Resize(224)``, ``RandomHorizontalFlip``, ``Normalize``
   on 4 worker processes, ``Momentum(0.01, momentum=0.9)``, one epoch of
   15 steps: ms a step, images/s, the consumer's wait for the loader, the
   device's busy share and ms by kind, peak memory, exact launches, the
   loader's ``dataload.fetch`` spans (one a batch and the epoch's end)
   and its goodput stall; then ``evaluate`` and ``predict`` on the test
   split, the loader alone (an
   epoch with no model) and the same steps through ``TrainStep`` over
   batches already on the card; (21d) an epoch of the device loader with
   0 and 4 workers equal to the CPU loader's bit for bit, and an
   exception in a worker raised in the consumer; (21e) ``Model.save`` on
   the card and ``Model.load`` into a fresh model: equal logits;
22. a Mixture-of-Experts Llama at Mixtral-8x7B's widths (vocab 32000,
   hidden 4096, FFN 14336, 32 / 8 heads, 8 experts, top-2, GShard routing
   with capacity factor 1.5) through ``distributed.fleet.MoELayer``: (22b)
   2 layers at seq 2048, each MoE layer on its own input through dense and
   sort dispatch (truncation decisions, combine weights, aux losses and two
   sort runs bit for bit in bf16; outputs and gradients in f32 within
   MOE_PATH_F32_FRAC), phase 6's kernels-against-plain step check with the
   routers' aux losses, and a 1-layer f32 MoE Llama at small widths on the
   card against the CPU; (22a) 4 layers, batch 1 x 4096, bf16, phase 7's
   AdamW and clip in ``TrainStep``, the loss with 0.02 times the aux
   losses, 2 warm-up and 6 timed steps: step ms, tokens/s, the share of the
   bf16 peak counting active parameters, peak memory, exact launches, one
   profiled step's busy share and device ms by kind (expert GEMMs, the
   dispatch and combine products, routing, flash, RMSNorm, the optimizer,
   cross entropy), the dispatch the measured policy chose with its probe's
   two times; (22c) step 1's gradients under ``recompute_policy``
   ``every_layer`` and ``selective`` against ``none`` (bit for bit, or the
   largest difference), then each policy's step ms and peak memory; (22d)
   ``bench.py``'s MoE step (``MoELayer`` alone, T 16384, d 1024, dh 2816,
   8 experts, SGD) under the policy, sort and dense, round-robin best of
   2: tokens/s, dense over sort, the policy's efficiency;
23. the op surface and ``nn.Layer``: (23a) ``OpsLlama`` (``ops_llama_class``),
   Llama written as a Paddle user writes it (``nn.Layer`` subclasses,
   ``create_parameter`` with ``ParamAttr(initializer=Normal(0, 0.02))``,
   a forward of public ops: ``matmul``, ``reshape``, ``split`` /
   ``concat`` RoPE, ``nn.functional.rms_norm``,
   ``scaled_dot_product_attention(is_causal=True)``, ``silu``,
   ``cross_entropy``) at phase 7's cell, its weights carried from
   ``LlamaForCausalLM`` by ``set_state_dict``: step 1's loss and every
   gradient against that model's eager forward and backward (OPS_LOSS_RTOL,
   OPS_GRAD_FRAC), then Paddle's eager loop with phase 7's AdamW and clip,
   3 timed steps after step 1 on one batch: finite, falling losses, exact
   launches (flash forward and backward 4 a step, RMSNorm fused 9 each way,
   the fused update 1), step ms beside phase 7's ``TrainStep``, tokens/s,
   peak memory, one profiled step's busy share; (23b) every op of the
   registry at small shapes (``paddle_tpu_torch.tools.op_cases``) on the
   card against the CPU, within each dtype class's tolerance, drawing ops
   by shape, dtype, range and replay, and the host microseconds of the
   registry's ``add`` beside ``torch.add``; (23c) ``seed(0)`` twice gives
   bit-identical ``create_parameter`` draws, layers' default draws and
   dropout masks on the card,
   ``get_cuda_rng_state`` / ``set_cuda_rng_state`` replay, and a
   ``PyLayer``'s gradient equals the plain composition's;
24. multi-process training (``paddle_tpu_torch/tools/dist_train.py``, its
   ranks started through ``python -m paddle_tpu_torch.distributed.launch``
   after the parent frees its cached memory; a rank's non-zero exit fails
   the phase): (24a) one rank on NCCL: ``fleet.init`` with
   ``sharding_degree=1``, ``group_sharded_parallel(level="p_g_os")`` and
   ``TrainStep`` on the sharded model with phase 7's AdamW and clip; at
   the step-check cell step 1's loss and every parameter bit for bit
   against a plain ``TrainStep`` (one rank: no collective runs, and the
   clip's squared norms are summed in the same order), then phase 7's cell (4 layers, batch 1 x 8192): a warm-up and 3
   timed steps with exact launches (flash 4 each way a step, RMSNorm
   ``round_first`` 9 each way, the fused update 1), the collectives a step
   by kind (the port's counters), step ms beside phase 7's ``TrainStep``,
   peak memory and one profiled step's busy share; (24b) two ranks on the
   one card over gloo: ``DataParallel`` with the bucketed reducer at the
   step-check cell, each rank on its row of a batch of 2 x 2048, one eager
   AdamW step: the gradients after the reduce and the parameters after the
   step bit-identical across the ranks (a checksum each), rank 0's
   reduced gradients against a one-process backward on the whole batch
   (each leaf's largest difference within ``dist_train.GRAD_TOL`` of its
   largest entry) and two planted faults, the gradient not divided by the
   world and rank 0's local gradient, refused by that check; rank 0's
   parameters against a one-process ``TrainStep`` on the whole batch
   within 2 lr plus one bf16 rounding (loose: AdamW's first step is about
   lr times the gradient's sign), the buckets fired and
   ``comm_buffer_size``, exact launches
   each rank (flash 2 each way, RMSNorm fused 5 each way, the fused update
   1);
25. tensor parallelism (``tools/dist_train.py --phase t``: two gloo ranks
   sharing the card, launched as phase 24's, over
   ``Partitioner(build_program_mesh(tensor=2))`` and
   ``PartitionedTrainStep``, each rank on 16 query heads and 4 KV heads,
   its MLP columns and its vocabulary rows): (25c) the semi-auto API on
   CUDA tensors, ``shard_tensor`` then ``reshard`` to ``Replicate`` equal
   to the input in f32 and bf16 and the gradient back whole; (25b) at the
   step-check cell (batch 1 x 2048 on both ranks) each rank's slices of the
   reduced gradients against a one-process ``TrainStep``'s backward on the
   card (each leaf within ``dist_train.GRAD_TOL`` of its largest entry),
   two planted faults refused by that check (the row-parallel products'
   all-reduce skipped; the column-parallel inputs' backward all-reduce
   skipped), one step whose numerics sentinels publish the same loss,
   grad norm and digest on both ranks (the norm the one-process
   gradients' within ``dist_train.SENTINEL_NORM_TOL``) and after which the
   uncut parameters (the norms) have the same bits on both ranks, and the
   same with ``sequence_parallel``;
   (25a) phase 7's cell (4 layers, batch 1 x 8192, phase 7's AdamW and
   clip) at tensor 2: a warm-up and 3 timed steps (gloo's transport through
   the host included), exact launches on each rank (flash 4 each way a
   step, RMSNorm ``round_first`` 9 each way, the fused update 1), the
   collectives a step by kind and bytes, per-rank peak memory and one
   profiled step's busy share; and, in this process, flash at the rank's
   shape (H 16, Hk 4, hd 128, S 8192, causal, bf16) held and timed alone
   with SDPA's time and the bound;
26. the pipeline (``tools/dist_train.py --phase p``: two gloo ranks
   sharing the card, launched as phase 24's, over
   ``ProcessMesh(shape=[2], dim_names=["pp"])``, the Llama split into the
   embedding, the decoder layers and the final norm with the head): (26b)
   at the step-check widths with 4 layers, batch 4 x 2048, for each of
   ``1f1b`` (M 4), ``fthenb`` (M 2), ``zero_bubble`` (M 4) and ``vpp`` (2
   chunks, M 4) the loss and every leaf's gradient of
   ``forward_backward_pipeline``, reassembled from both ranks, against a
   one-process traced forward and backward of the whole batch on the card
   (each leaf within ``dist_train.GRAD_TOL`` of its largest entry), and
   two planted faults refused by that check (the last stage seeding its
   backward with 1 instead of 1/M; stage 0 taking the cotangents of
   microbatches 0 and 1 through each other's graph); (26c) phase 7's widths
   and depth at 8 microbatches of 1 x 1024: each stage's peak memory above
   its resting state over one pass of the schedule under ``fthenb`` and
   ``1f1b``, 1F1B's below FThenB's on stage 0; (26a) phase 7's widths and
   depth (4 layers, 8192 tokens a step) as batch 4 x 2048 in 4
   microbatches under ``1f1b``, ``PipelineParallel.train_batch`` with
   AdamW(3e-4, weight_decay 0.1) and no clip (the reference's
   ``train_batch`` reads none): a warm-up and 3 timed steps (the host's
   transport included), exact launches on each rank (a step: flash 8
   each way, RMSNorm ``round_first`` 16 each way on stage 0 and 20 on
   stage 1, the fused update 1), the sends and receives a step and their
   bytes, per-rank peak memory and one profiled step's busy share;
27. hybrid parallelism (``tools/dist_train.py --phase h``: four gloo ranks
   sharing the card over ``ProcessMesh([2, 2], ["pp", "mp"])``, the
   Llama's stages from ``LlamaForCausalLM.pipeline_stages``, each rank on
   its heads, MLP columns and vocabulary rows, the loss
   ``ParallelCrossEntropy`` on the head's vocabulary columns): (27b) at
   the step-check widths with 4 layers, batch 4 x 2048, for 1F1B with
   sequence parallelism and ``activation_spec``, without them, and vpp at
   2 chunks with them, the loss and every leaf's gradient gathered over
   pipe and tensor against a one-process traced backward on the card
   (each leaf within ``GRAD_TOL``), and two planted faults refused (the
   gradients partial over tensor left unsummed; stage 1 taking the
   sequence shards of stage 0's other tensor rank); (27a) phase 7's widths
   and depth (2 layers a stage) as batch 4 x 2048 in 4 microbatches under
   1F1B with sequence parallelism and ``activation_spec``, ``train_batch``
   with AdamW: a warm-up and 3 timed steps (the host's transport
   included), exact launches on each rank (a step: flash 8 each way at H
   16, Hk 4; RMSNorm ``round_first`` on [1024, 4096] 16 each way on stage
   0 and 20 on stage 1; the fused update 1), the sends and receives a step
   with their bytes (33,554,432 each way, exactly: half the sequence),
   per-rank peak memory and a profiled step's busy share; (27c) pp 2 x
   sharding 2 through fleet (sharding stage 1) at 2 layers: the gradient
   check, and each rank's optimizer state exactly half of its stage's;
28. context parallelism across processes (``tools/dist_train.py --phase
   s``: gloo ranks sharing the card, the Llama's ``context_parallel``
   through ``parallelize`` and ``TrainStep``, each rank of the ``sep``
   axis on its half of the sequence, the loss the global token mean, the
   gradients summed over sep): (28b) two ranks over ``ProcessMesh([2],
   ["sep"])`` at the step-check widths (2 layers, batch 1 x 2048): the
   ring and Ulysses, the loss and every leaf's reduced gradient against a
   one-process traced backward on the card within ``GRAD_TOL``, and a
   planted fault refused (RoPE at every rank's positions from 0); (28a)
   the ring across the two processes against the one-process ring (phase
   13's kernels) at the cell's layer shapes (q [1, 4096, 32, 128] a rank,
   K/V at 8 heads, bf16, causal), output and dQ, dK, dV bit for bit; then
   phase 13's cell (4 layers, batch 1 x 8192, AdamW with the clip) at sep
   2: a warm-up and SEP_STEPS = 1 timed step (the host's transport
   included), exact
   launches on each rank (a step: rank r flash r + 1 times each way a
   layer and the merge r times, RMSNorm ``round_first`` 9 each way on its
   [4096, 4096] rows, the fused update 1), the ring's bytes a step
   exactly as the schedule reckons them (K/V bf16 P - 1 hops each way,
   f32 dK/dV P hops: 402,653,184 each way) and the gradient all-reduce's
   (4 bytes a parameter, f32 over gloo, and the loss's sum and count),
   the ratio to phases 13 and 7, per-rank peak memory and a profiled
   step's busy share; (28c) four ranks over ``ProcessMesh([2, 2], ["sep",
   "mp"])`` (each rank on H 16, Hk 4; Ulysses then H 8, Hk 2): the step
   check of 28b, each rank holding its tensor slices.
29. expert parallelism (``tools/dist_train.py --phase e``: two gloo ranks
   sharing the card, an MoE Llama at Mixtral-8x7B's widths cut to 2
   layers, bf16, loss the cross entropy plus 0.02 x the layers' aux,
   AdamW with the clip, ``PartitionedTrainStep``; every MoE layer routes
   the global batch): the step checks, each rank's reduced gradients (its
   slices) against a one-process traced backward of the whole batch on
   the card within ``GRAD_TOL`` (the one process routing from the logits
   the ranks computed): (29a) the experts over dp (the all-to-all, 4
   experts a rank), a global batch of 2 x 4096; (29c) the same at
   capacity factor 0.5 (tokens drop) and 2 x 2048, then the planted fault
   of every rank routing its own rows, which the check must refuse;
   (29b) the experts over tensor (partial sums, the attention cut by
   heads), 1 x 2048; then 29a's cell: a warm-up and EP_STEPS = 2 timed
   steps (the host's transport included), exact launches on each rank
   (flash 2 each way, RMSNorm ``round_first`` 5 each way, the fused update
   1 a step), the all-to-all's bytes exactly 2 x (rows sent + rows
   received) x 4096 x 2 a layer, every kept choice of the global batch
   sent and returned, the replicated gradients' all-reduce exactly 4
   bytes a parameter, per-rank peak memory and a profiled step's busy
   share.

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
training steps; paged attention over the prefix cache's tables from phase
15's traced window, the weight stream at the verify's M = 40 from phase
16's; the fused optimizer from the three timed training steps of phase 7,
phase 18's O1 steps, phase 19a's six, phase 20a's six, phase 20e's
first 50, phase 21's fits (21a's two epochs, 21b's card steps, 21c's
epoch) and phase 23a's eager steps, with its numbers from phase 17,
and in its master mode from phase 18's O2 steps and phase 19e's, with its
numbers from 18d; flash and
RMSNorm also count phase 18's and phase 23a's timed steps, flash, RMSNorm's ``round_first``
mode and the fused optimizer phase 22a's timed steps, the optimizer 22d's
steps too; flash, RMSNorm's ``round_first`` mode and the fused optimizer
phase 24a's three timed steps, flash, RMSNorm's fused mode and the fused
optimizer phase 24b's step on each of its two ranks, and flash, RMSNorm's
``round_first`` mode and the fused optimizer phase 25a's three timed steps
on each of its two ranks, phase 26a's on each of its two stages, phase
27a's on each of its four ranks, phase 28a's on each of its two sep
ranks, whose merges and ring launches the ring's rows count too, and
phase 29a's on each of its two ranks), and last ``{"ok": true,
"device": {...}}``. Any failure
raises and exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. ``--seed`` changes the
weights, the kernel inputs and the request trace.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
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

# the observability plane (phases 3, 6, 7, 17s, 21c). The sentinels' sums of
# squares: the same f32 terms as the plain version's, summed in another
# order (digests and counts are integers, held exactly). Their grad_norm
# against the global-norm clip's norm of the same gradients: two f32 sums
# of 1.9e9 squares in different orders. The device time under the
# jit.dispatch span against the step's busy time: the span holds every
# launch of the step but the sentinels' one read-back copy. The program's
# MFU gauge (counted FLOPs over the step program's device time) against the
# phase's model-FLOPs share (model FLOPs over the host's step time): the
# counted FLOPs add the elementwise work, the update's and the sentinels',
# and the device time excludes the host's tail.
SENTINEL_SQ_RTOL = 1e-5
SENTINEL_NORM_RTOL = 1e-3
DEVICE_TRACE_RTOL = 0.05
MFU_RTOL = 0.15
# attribution's MFU and roofline fractions before the gauges' clamp to 1: a
# reading past this means the counted FLOPs or bytes exceed the work the
# device can have done in the measured time (5% for the event timer's edges)
ROOFLINE_CEIL = 1.05
# the step's hand kernels the exported Chrome trace must name
TRACE_KERNELS = ("flash_fwd_kernel", "flash_bwd_kv_kernel", "flash_bwd_dq_kernel",
                 "rms_fwd_kernel", "rms_bwd_dx_kernel", "multi_tensor_update_kernel",
                 "sentinel_stats_kernel")
# telemetry snapshots written by TrainStep(telemetry_export_every=1) in phase 7
EXPORT_STEPS = 2

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


# (label, head_dim, bs, MB): the serving shape (narrow), and the wide mode
# past 256 columns and past 256 slots a page
LANE_BITS_CASES = (("narrow", 128, 16, 64), ("wide_hd320", 320, 16, 64),
                   ("wide_pages512", 128, 512, 2))
LANE_BITS_OTHERS = (1, 30, 1000)
# (lanes, the lane held): the first lane, the last, and the last of 40
# lanes, whose 320 pairs outnumber the grid, so blocks take its chunks as
# their second, after another lane's first
LANE_BITS_HELD = ((8, 0), (8, 7), (40, 39))


def hold_lane_bits(gen):
    """A lane's bits do not depend on the other lanes' lengths: each
    LANE_BITS_HELD lane (length 600) through the kernel while the others
    hold each of LANE_BITS_OTHERS tokens, bit for bit, in both modes; every
    call held against the kernel's schedule and merge emulated on the CPU
    (``paged_decode_attention_split`` at the launch's grid) within
    ATTN_ATOL (the card's tensor-core sums and exp2 round apart from the
    CPU's f32)."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    errs = {}
    for label, hd, bs, mb in LANE_BITS_CASES:
        for lanes, held in LANE_BITS_HELD:
            # pools valid up to the longest length, so no lane sees a poisoned slot
            q, pk, pv, table, ln = attention_inputs(gen, [max(LANE_BITS_OTHERS)] * lanes, 1,
                                                    hd=hd, bs=bs, MB=mb)
            q, pk, pv = q[0], pk[0], pv[0]
            grid = pa._plan_for(q, pk, table)[0]
            cpu = [t.cpu() for t in (q, pk, pv, table)]
            held_out, err = [], 0.0
            for other in LANE_BITS_OTHERS:
                lengths = [other] * lanes
                lengths[held] = 600
                ln.copy_(torch.tensor(lengths, dtype=torch.int32))
                got = pa.paged_decode_attention(q, pk, pv, table, ln)
                emu = pa.paged_decode_attention_split(*cpu, ln.cpu(), grid)
                err = max(err, hold_paged(f"{label} vs the emulation", got, emu.cuda(),
                                          "bfloat16"))
                held_out.append(got[held])
            if not all(torch.equal(f, held_out[0]) for f in held_out[1:]):
                raise AssertionError(f"paged attention ({label}, {lanes} lanes): lane {held}'s "
                                     "output moved with the other lanes' lengths")
            errs[f"{label}_lane{held}of{lanes}"] = err
    say("kernels", kernel="paged_attention", lane_bits_independent=True,
        held=json.dumps(LANE_BITS_HELD), others=list(LANE_BITS_OTHERS),
        emulation_err=json.dumps(errs))


def check_paged_cases(gen):
    """PAGED_CASES with poisoned hidden slots, each called twice bit for
    bit and counted; a lane's bits across the other lanes' lengths; a
    captured graph replayed after lengths and the table change in place;
    one kernel a call in a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import paged_attention as pa

    hold_paged_cases(gen, PAGED_CASES)
    hold_lane_bits(gen)

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


def paged_bound(lengths, lanes, H, Hk, hd, bs, MB, es=2, kv_rows=None):
    """(bytes, FLOPs) one call must move and do: q and out once, each
    visible K and V row once (``kv_rows``: the distinct visible rows where
    lanes share pages), the visible table entries and the lengths."""
    n_vis = [min(n + 1, MB * bs) for n in lengths]
    rows = sum(n_vis) if kv_rows is None else kv_rows
    nbytes = (lanes * H * hd * es * 2 + rows * Hk * hd * es * 2
              + sum(-(-n // bs) for n in n_vis) * 4 + lanes * 4)
    return nbytes, sum(n_vis) * H * hd * 4


def alias_pages(table, shared: int):
    """Make ``table`` the prefix cache's, in place: every lane's first
    ``shared`` entries lane 0's pages, lane 1's last shared entry its own
    page (a COW fork)."""
    own = int(table[1, shared - 1])
    table[1:, :shared] = table[0, :shared]
    table[1, shared - 1] = own


def distinct_rows(table, lengths, bs: int) -> int:
    """The distinct (page, slot) pairs the lanes see: the K and V rows a
    call must read where lanes share pages."""
    rows = table.cpu().numpy()
    return len({(int(rows[b, s // bs]), s % bs) for b, n in enumerate(lengths)
                for s in range(n + 1)})


def time_paged(gen, label, lengths, kern=None, yardsticks: bool = True, hold: bool = True,
               shape=None, hold_f32: bool = False, alias: int = 0):
    """Hold (unless ``hold`` is false) and time one PAGED_TIMED case (4
    layers of pools, cycled; ``shape``: other ``attention_inputs`` sizes):
    the kernel (``kern(q, pk, pv, table, ln)``, the wrapper by default)
    and, with ``yardsticks``, its plain version and SDPA over the gathered
    window. With ``hold_f32`` the kernel is held against the plain version
    evaluated in f32 on the same inputs, for a kernel that keeps its
    probabilities and sums in f32 and rounds once (the plain version in
    bf16 rounds its probabilities and its output: at hd 512 an output in
    [4, 8) may then differ by one bf16 step, 0.03125, past ATTN_ATOL).
    With ``alias`` every lane's first ``alias`` table entries are the same
    pages, one lane holding a fork of the last (``alias_pages``), and the
    bound counts each shared row once."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    kern = kern or pa.paged_decode_attention
    q, pk, pv, table, ln = attention_inputs(gen, lengths, **(shape or {}))
    layers, lanes, H, hd = q.shape
    _, nb, bs, Hk, _ = pk.shape
    kv_rows = None
    if alias:
        alias_pages(table, alias)
        kv_rows = distinct_rows(table, lengths, bs)

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
    nbytes, flops = paged_bound(lengths, lanes, H, Hk, hd, bs, table.shape[1], kv_rows=kv_rows)
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
# serving engine's 8, a 16-token prefill chunk, the speculative verify's 40
# (8 lanes x k + 1 = 5 positions) and the largest M it takes
STREAM_M = (1, 8, 16, 40, 64)
VERIFY_M = 40


def check_int8(gen):
    """The weight stream at each GEMM_SHAPES shape and STREAM_M, held against
    the plain version and timed beside its bound, the plain version, the
    dequantize-then-matmul call (``library_ms``) and the bf16 engine's own
    call on weights dequantized before the timing (``bf16_gemm_ms``); the
    decode step (225 calls) summed at each M. Returns M = 8's step (the
    decode step) and M = VERIFY_M's (one verify call of the speculative
    engine, 225 calls too)."""
    import torch

    from paddle_tpu_torch.ops import quant_matmul as qm

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bf16_gemm_ms", "bytes", "flops")
    steps = {M: dict.fromkeys(keys, 0.0) for M in STREAM_M}
    max_err = dict.fromkeys(STREAM_M, 0.0)
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
            max_err[M] = max(max_err[M], err)
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
    for M in (8, VERIFY_M):
        steps[M]["max_abs_err"] = max_err[M]
        steps[M]["bound_by"] = bound_ms(steps[M]["bytes"], steps[M]["flops"])[1]
    check_int8_f32_decode(gen)
    stream_dependent_launch_in_graph(gen)
    return steps[8], steps[VERIFY_M]


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
    # each program call's device span (CUDA events just before and after
    # it): decode and prefill, or a speculative engine's draft decode,
    # verify and prefill
    attrs = {p.name: a for a in ("_decode_prog", "_draft_prog", "_verify_prog", "_prefill_prog")
             if (p := getattr(engine, a, None)) is not None}
    progs = {name: getattr(engine, a) for name, a in attrs.items()}
    spans: dict = {name: [] for name in attrs}

    def timed(name):
        def call():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
            progs[name]()
            b.record()
            spans[name].append((a, b))
        return call

    if cuda:
        for name, a in attrs.items():
            setattr(engine, a, timed(name))
    t0 = time.perf_counter()
    while engine.pending():
        s0 = time.perf_counter()
        engine.step()
        sync()
        steps.append(time.perf_counter() - s0)
    wall = time.perf_counter() - t0
    for name, a in attrs.items():
        setattr(engine, a, progs[name])
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


@contextlib.contextmanager
def recording_decode(engine):
    """Yields a list that gets, before each call of ``engine``'s decode
    program, the lanes' lengths and block table (host copies) that the
    call's paged-attention launches read."""
    prog, kv, got = engine._decode_prog, engine._kv, []

    def call():
        got.append((kv.lengths.copy(), kv.block_table.copy()))
        prog()

    call.name = prog.name
    engine._decode_prog = call
    try:
        yield got
    finally:
        engine._decode_prog = prog


# the narrow mode's FILL values timed on served traffic, in this order
TRAFFIC_FILLS = (1, 2, 2, 1)


def time_decode_traffic(gen, traffic: str, batches, num_blocks: int):
    """The paged-attention kernel over the decode calls an engine served
    (``batches``, from :func:`recording_decode`: each call's lengths and
    block table, aliased pages and all) at the serving shape (H 32, Hk 8,
    hd 128, pages of 16, bf16, random pools of ``num_blocks`` pages): the
    mean device ms a call, every call once in one CUDA graph, with the
    narrow mode's FILL at each of TRAFFIC_FILLS in turn. Prints and
    returns {FILL: [ms, ...]}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    lanes, _ = batches[0][1].shape
    q = torch.randn((lanes, 32, 128), generator=gen, device="cuda").bfloat16()
    pk, pv = (torch.randn((num_blocks, 16, 8, 128), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    lens = torch.from_numpy(np.stack([ln for ln, _ in batches])).cuda()
    tabs = torch.from_numpy(np.stack([t for _, t in batches])).cuda()

    def run(i):
        return pa.paged_decode_attention(q, pk, pv, tabs[i], lens[i])

    kept, times = pa.FILL, {}
    try:
        for fill in TRAFFIC_FILLS:
            pa.FILL = fill
            times.setdefault(fill, []).append(round(device_ms(run, len(batches),
                                                              iters=len(batches)), 5))
    finally:
        pa.FILL = kept
    n = lens.cpu().numpy()
    say("paged-traffic", traffic=traffic, calls=len(batches), lanes=lanes,
        length_mean=round(float(n.mean()), 1), length_max=int(n.max()),
        length_spread_mean=round(float((n.max(1) - n.min(1)).mean()), 1),
        **{f"fill{f}_ms": ts for f, ts in times.items()}, fill=kept)
    return times


def trace_launches(engine, phase: str, seed: int, int8: bool = False,
                   wide: bool = False, prompts=None) -> dict:
    """The kernels a graphed engine's device ran, read from a device trace
    (a replay runs kernels that no wrapper counts): under torch.profiler
    the engine serves 7 one-token requests and one whose prompt takes 3
    prefill chunks, 4 tokens each, to the end. Holds the traced launches
    exactly against the programs' calls in that window (``prompts``, where
    given, are served instead, 4 tokens each): paged attention
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
    if prompts is None:
        reqs = [engine.submit([int(rng.randint(1, vocab))], 4)
                for _ in range(engine.config.num_lanes - 1)]
        reqs.append(engine.submit(rng.randint(1, vocab, 3 * C + 1).tolist(), 4))
    else:
        reqs = [engine.submit(p, 4) for p in prompts]
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
    if any(r.status != "done" for r in reqs) or traced != want or \
            calls["prefill"] < (3 if prompts is None else 1):
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


# ---------------------------------------------------------------------------
# phases 15-16: the prefix cache and speculative decoding
# ---------------------------------------------------------------------------

PREFIX_CFG = dict(num_lanes=8, block_size=16, max_seq_len=1024, prefill_chunk=16)
PREFIX_SYSTEM = 512               # the shared system prompt: 32 blocks
PREFIX_REQUESTS = 16
PREFIX_PRIVATE = (4, 9, 14)       # requests with a private prompt (13 of 16 share)
PREFIX_FORK = 11                  # the request whose prompt is the system prompt alone
# the pressure runs: 96 usable blocks (a request reserves 35-42) and the
# host tier's budget. A pool of 128 usable blocks holds the three system
# prompts' chains (about 108 blocks) beside one request and never evicts
# in this rotation
PRESSURE_BLOCKS, PRESSURE_HOST = 97, 96
# a wave's prefill budget: every admitted prompt is prefilled in its
# admission step, so two engines decode the same batches step for step
WAVE_PREFILL = 4096
# the paged kernel over the prefix cache's tables: 8 lanes past the shared
# 512 slots (the trace's tails), timed with aliased pages
PREFIX_LENGTHS = [527, 560, 511, 600, 639, 530, 545, 620]


def prefix_trace(seed: int, vocab: int):
    """(system prompt, prompts): 13 of 16 requests open with one shared
    512-token system prompt, 12 of them followed by a private tail of
    16-128 tokens and request PREFIX_FORK by nothing (its hit covers the
    block its first decode step writes: a COW fork); PREFIX_PRIVATE are
    private prompts of 16-600 tokens."""
    import numpy as np

    rng = np.random.RandomState(seed + 15)
    system = rng.randint(1, vocab, PREFIX_SYSTEM).tolist()
    prompts = []
    for i in range(PREFIX_REQUESTS):
        if i in PREFIX_PRIVATE:
            prompts.append(rng.randint(1, vocab, int(rng.randint(16, 601))).tolist())
        elif i == PREFIX_FORK:
            prompts.append(list(system))
        else:
            prompts.append(system + rng.randint(1, vocab, int(rng.randint(16, 129))).tolist())
    return system, prompts


def peak_shared(engine) -> list:
    """Wrap ``engine.step`` to keep the most blocks held by more than one
    lane after any step, in the returned list's one element."""
    peak, step = [0], engine.step

    def wrapped():
        n = step()
        peak[0] = max(peak[0], engine._kv.shared_blocks)
        return n

    engine.step = wrapped
    return peak


def ttft_p50_ms(reqs) -> float:
    ttft = sorted(r.first_token_time - r.submit_time for r in reqs)
    return round(1e3 * ttft[len(ttft) // 2], 2)


def serve_waves(model, prompts, phase: str, wave: int = 8, **cfg):
    """The trace in waves of ``wave`` requests, each wave run to its end
    with WAVE_PREFILL chunks a step. Returns (tokens, the engine's
    stats)."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    engine = ServingEngine(model, ServeConfig(max_prefill_chunks_per_step=WAVE_PREFILL,
                                              **PREFIX_CFG, **cfg))
    out = []
    for i in range(0, len(prompts), wave):
        out += [r.generated for r in serve(engine, prompts[i:i + wave], NEW_TOKENS,
                                           f"{phase}-wave{i // wave}")]
    hold_captures(engine, phase)
    st = engine.stats()
    del engine
    torch.cuda.empty_cache()
    return out, st


def serve_one_by_one(model, prompts, phase: str, **cfg):
    """Each request alone, run to its end. Returns (tokens, the engine's
    stats)."""
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine

    engine = ServingEngine(model, ServeConfig(**PREFIX_CFG, **cfg))
    out = [serve(engine, [p], NEW_TOKENS, f"{phase}-{i}")[0].generated
           for i, p in enumerate(prompts)]
    hold_captures(engine, phase)
    st = engine.stats()
    del engine
    torch.cuda.empty_cache()
    return out, st


def check_prefix_cache(model, seed: int, gen):
    """Phase 15: the prefix cache at Llama-3-8B width (``model``, bf16,
    PREFIX_CFG). Returns (the paged kernel's numbers over aliased tables,
    its launches in the cached engine's traced window)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.ops import paged_attention as pa

    vocab = model.config.vocab_size
    system, prompts = prefix_trace(seed, vocab)
    # the kernel over the prefix cache's tables (32 shared pages, a fork)
    kern = time_paged(gen, "prefix_aliased", PREFIX_LENGTHS, alias=PREFIX_SYSTEM // 16)
    q, pk, pv, table, ln = attention_inputs(gen, PREFIX_LENGTHS, 1)
    alias_pages(table, PREFIX_SYSTEM // 16)
    first = pa.paged_decode_attention(q[0], pk[0], pv[0], table, ln)
    if not torch.equal(first, pa.paged_decode_attention(q[0], pk[0], pv[0], table, ln)):
        raise AssertionError("two paged-attention calls over aliased pages differ")
    say("prefix-cache", kernel="paged_attention", case="aliased_pages", lengths=PREFIX_LENGTHS,
        shared_pages=PREFIX_SYSTEM // 16, max_abs_err=kern["max_abs_err"],
        tol=ATTN_ATOL["bfloat16"], bit_identical=True, ms=round(kern["ms"], 5),
        bound_ms=round(kern["bound_ms"], 5), bound_by=kern["bound_by"],
        bound_share=round(kern["bound_ms"] / kern["ms"], 4),
        plain_ms=round(kern["plain_ms"], 5), library_ms=round(kern["library_ms"], 5),
        bytes=kern["bytes"])
    del q, pk, pv, table, ln, first
    # the trace submitted at once, cold then cached: TTFT, hits, forks
    cold_eng = ServingEngine(model, ServeConfig(**PREFIX_CFG))
    cold = serve(cold_eng, prompts, NEW_TOKENS, "prefix-cold")
    hold_captures(cold_eng, "prefix-cold")
    del cold_eng
    engine = ServingEngine(model, ServeConfig(prefix_cache=True, **PREFIX_CFG))
    peak = peak_shared(engine)
    with recording_decode(engine) as decoded:
        hot = serve(engine, prompts, NEW_TOKENS, "prefix-cached")
    time_decode_traffic(gen, "phase15", decoded, engine._kv.num_blocks)
    hold_captures(engine, "prefix-cached")
    st = engine.stats()["prefix_cache"]
    same = sum(a.generated == b.generated for a, b in zip(cold, hot))
    say("prefix-cache", hits=st["hits"], misses=st["misses"], hit_frac=round(st["hit_frac"], 4),
        forks=st["forks"], shared_blocks_peak=peak[0], entries=st["entries"],
        ttft_ms_p50_cached=ttft_p50_ms(hot), ttft_ms_p50_cold=ttft_p50_ms(cold),
        requests_equal_cold_when_served_at_once=f"{same}/{len(hot)}")
    if st["hits"] < 1 or st["forks"] < 1 or peak[0] < 1:
        raise AssertionError(f"the prefix-cache engine saw no hit, fork or shared block: {st}")
    if same != len(hot):
        raise AssertionError(f"served at once, {len(hot) - same} of {len(hot)} requests of the "
                             "prefix-cache engine differ from the cold engine's")
    # a traced window of hits on the cached system prompt (one of them the
    # fork): paged attention once a layer in each decode call
    rng = np.random.RandomState(seed + 18)
    window = [system + rng.randint(1, vocab, 5).tolist() for _ in range(7)] + [list(system)]
    launches = trace_launches(engine, "prefix-cache", seed, prompts=window)["paged"]
    del engine
    torch.cuda.empty_cache()
    # bit for bit against the cold engine, the trace in waves
    want, _ = serve_waves(model, prompts, "prefix-cold-waves")
    got, st = serve_waves(model, prompts, "prefix-cached-waves", prefix_cache=True)
    pc = st["prefix_cache"]
    say("prefix-cache", waves_tokens_equal_cold=got == want, hits=pc["hits"], forks=pc["forks"],
        kv_calls=json.dumps(st["kv_calls"]))
    if got != want or pc["hits"] < 1 or pc["forks"] < 1:
        raise AssertionError("the prefix-cache engine's tokens differ from the cold engine's, "
                             f"or it saw no hit or fork: {pc}")
    # pressure: three system prompts in rotation, a pool that must evict
    rng = np.random.RandomState(seed + 16)
    systems = [rng.randint(1, vocab, PREFIX_SYSTEM).tolist() for _ in range(3)]
    rotation = [systems[i % 3] + rng.randint(1, vocab, int(rng.randint(16, 129))).tolist()
                for i in range(6)]
    cold_r, _ = serve_one_by_one(model, rotation, "pressure-cold", num_blocks=PRESSURE_BLOCKS)
    for host, tier in ((PRESSURE_HOST, "evictions_host"), (0, "evictions_drop")):
        got, st = serve_one_by_one(model, rotation, f"pressure-host{host}", prefix_cache=True,
                                   num_blocks=PRESSURE_BLOCKS, host_kv_blocks=host)
        pc = st["prefix_cache"]
        say("prefix-cache", pressure_host_blocks=host, tokens_equal_cold=got == cold_r,
            evictions_host=pc["evictions_host"], evictions_drop=pc["evictions_drop"],
            restores=pc["restores"], restore_ms=pc["restore_ms"], hits=pc["hits"],
            kv_calls=json.dumps(st["kv_calls"]))
        if got != cold_r or pc[tier] < 1 or (host and pc["restores"] < 1) or \
                st["kv_calls"]["kv_offload"] != pc["evictions_host"] or \
                st["kv_calls"]["kv_restore"] != pc["restores"]:
            raise AssertionError(f"the prefix cache under pressure (host {host}): tokens "
                                 f"equal {got == cold_r}, {pc}, {st['kv_calls']}")
    # int8 weights
    want, _ = serve_waves(model, prompts, "prefix-int8-cold-waves", weight_dtype="int8")
    got, st = serve_waves(model, prompts, "prefix-int8-cached-waves", prefix_cache=True,
                          weight_dtype="int8")
    say("prefix-cache", int8_waves_tokens_equal_cold=got == want,
        hits=st["prefix_cache"]["hits"])
    if got != want or st["prefix_cache"]["hits"] < 1:
        raise AssertionError("the int8 prefix-cache engine's tokens differ from the int8 cold "
                             "engine's")
    return kern, launches


SPEC_K = 4
# 4 of the trace's 8 requests since the context-parallel phase (28) took its
# seconds: the draft takes each prompt token through its decode program
SPEC_REQUESTS = 4
SPEC_CFG = dict(num_lanes=8, block_size=16, max_seq_len=1024, prefill_chunk=16)
SELF_DRAFT_LAYERS = 2
SELF_DRAFT_ACCEPT = 0.95
# the teacher-forced verify (phase 16): the verify's k + 1 logits a lane
# against the decode step's fed the same tokens. The verify attends through
# the composed window attention (probabilities rounded to bf16) at M = 40,
# the decode step through the kernel (f32 probabilities) at M = 8, so every
# layer rounds its outputs at other places: held, as phase 3's check, to
# LOGITS_TOL_FRAC of the logits' largest magnitude.
SPEC_LOGITS_TOL_FRAC = LOGITS_TOL_FRAC


# the draft's depth, cut from Llama-3.2-1B's 16 layers to fit phase 28 in the
# script's time limit: its eager decode calls took 67 of the eager
# speculative engine's 78 s
DRAFT_LAYERS = 4


def draft_config():
    """Meta's Llama-3.2-1B widths (its config.json): vocab 128256, hidden
    2048, FFN 8192, 32 heads, 8 KV heads (head dim 64), tied embeddings,
    rope theta 5e5, RMSNorm eps 1e-5, at DRAFT_LAYERS of its 16 layers. Its
    llama3 rope_scaling is left out: the port, like the reference, has
    none."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                       num_hidden_layers=DRAFT_LAYERS, num_attention_heads=32,
                       num_key_value_heads=8,
                       max_position_embeddings=131072, rms_norm_eps=1e-5,
                       rope_theta=500000.0, tie_word_embeddings=True)


def hold_spec_captures(engine, phase: str):
    caps = engine.stats()["captures"]
    say(phase, captures=json.dumps(caps))
    if caps != {"draft_decode": 1, "verify": 1, "prefill": 1}:
        raise AssertionError(f"{phase}: the speculative engine captured {caps}, not one "
                             "draft-decode, one verify and one prefill program")


def spec_teacher_forced(engine, prompts, seed: int):
    """One round's k + 1 verify logits a lane against the non-speculative
    decode step's logits fed the same tokens (the committed token and k
    seeded ones), each path on its own copy of the page pool, within
    SPEC_LOGITS_TOL_FRAC of the largest magnitude."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import PagedKVView, speculative
    from paddle_tpu_torch.models.llama import decode_step

    L, K = engine.config.num_lanes, engine._spec_k
    # room for every lane to keep running while the others prefill: a
    # round emits up to k + 1 tokens a lane
    reqs = [engine.submit(p[:64], 512) for p in prompts[:L]]
    while not all(r.status == "running" for r in reqs):
        if any(r.finished for r in reqs):
            raise AssertionError("a teacher-forced request finished before all ran")
        engine.step()
    kv, bs, mcfg = engine._kv, engine.config.block_size, engine.model.config
    kv.active[...] = False
    kv.active[[r.lane for r in reqs]] = True
    bt, ln, ac = kv.device_tables()
    rng = np.random.RandomState(seed + 19)
    toks = np.concatenate([engine._lane_tok[:, None],
                           rng.randint(1, mcfg.vocab_size, (L, K))], axis=1)
    toks = torch.tensor(toks, dtype=torch.int64, device=engine.device)
    d = engine._in.dev
    verify = speculative.build_verify_fn(mcfg, K, bs, kv.max_blocks_per_lane)
    accept = speculative.accept
    speculative.accept = lambda lg, *a: (lg, None)      # the logits, not the tokens
    try:
        with torch.no_grad():
            lg_v = verify(engine._w, toks, kv.pages_k.clone(), kv.pages_v.clone(), bt, ln, ac,
                          d["seed_keys"], engine._qbuf, engine._dr.dev["n_draft"], d["temp"],
                          d["topk"], d["topp"], d["do"])[0].float()
    finally:
        speculative.accept = accept
    pk, pv = kv.pages_k.clone(), kv.pages_v.clone()
    with torch.no_grad():
        lg_d = torch.stack([decode_step(mcfg, engine._w, toks[:, c],
                                        PagedKVView(pk, pv, bt, ln + c, ac, bs), ln + c).float()
                            for c in range(K + 1)], dim=1)
    del pk, pv
    for r in reqs:
        engine.cancel(r)
    act = ac.bool()
    diff = (lg_v[act] - lg_d[act]).abs().max().item()
    scale = lg_d[act].abs().max().item()
    tol = SPEC_LOGITS_TOL_FRAC * scale
    top1 = (lg_v[act].argmax(-1) == lg_d[act].argmax(-1)).float().mean().item()
    say("speculative", teacher_forced_max_abs_diff=diff, logits_max_abs=scale, tol=tol,
        top1_agree=top1, columns=K + 1)
    if not diff <= tol:
        raise AssertionError(f"verify logits differ from the decode step's by {diff} > {tol}")


def profile_spec(engine, seed: int, phase: str):
    """Device ms a speculative round by KERNEL_KINDS kind: 8 one-token
    requests (no prefill), 2 rounds of warm-up, then 3 rounds under
    torch.profiler, with each program's calls in that window and the
    busiest kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(seed + 21)
    vocab = engine.model.config.vocab_size
    reqs = [engine.submit([int(rng.randint(1, vocab))], 64)
            for _ in range(engine.config.num_lanes)]
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    rounds, before = 3, engine.stats()["program_calls"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            engine.step()
        torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in engine.stats()["program_calls"].items()}
    for r in reqs:
        engine.cancel(r)
    per_kernel, launches = kernel_times(prof)
    say(phase, profiled_rounds=rounds, program_calls=json.dumps(calls),
        device_ms_per_round=round(sum(per_kernel.values()) / 1e3 / rounds, 3),
        device_ops_per_round=launches / rounds)
    say(phase, device_ms_per_round_by_kind=json.dumps(
        {k: round(v / rounds, 4) for k, v in by_kind(per_kernel).items()}))
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {phase} top kernel: {us / 1e3 / rounds:.4f} ms/round {name[:90]}", flush=True)


def trace_spec_window(engine, phase: str, seed: int) -> int:
    """Under torch.profiler, 8 one-token requests (no prefill) through the
    graphed int8 speculative engine, 8 tokens each: the weight stream runs
    exactly 225 times a verify call (7 a layer and the lm_head; the draft
    stays unquantized), no other int8 kernel and no paged attention.
    Returns the stream's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab, layers = engine.model.config.vocab_size, engine.model.config.num_hidden_layers
    rng = np.random.RandomState(seed + 20)
    before = engine.stats()["program_calls"]
    reqs = [engine.submit([int(rng.randint(1, vocab))], 8)
            for _ in range(engine.config.num_lanes)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run()
        torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in engine.stats()["program_calls"].items()}
    counts: dict = {}
    kernel_times(prof, counts)
    traced = serving_kernels(counts)
    other = sorted(k for k in counts if "finalize" in k or "int8_tc_kernel" in k)
    want = {"paged": 0, "paged_wide": 0, "stream": (7 * layers + 1) * calls["verify"],
            "large_m": 0}
    say(phase, traced_program_calls=json.dumps(calls), traced_launches=json.dumps(traced),
        want=json.dumps(want), stream_per_verify=traced["stream"] / max(calls["verify"], 1))
    if any(r.status != "done" for r in reqs) or traced != want or other or calls["prefill"]:
        raise AssertionError(f"{phase}: the traced speculative programs {calls} launched "
                             f"{traced} and {other} (want {want})")
    return traced["stream"]


def check_speculative(model, seed: int):
    """Phase 16: speculative decoding, the target ``model`` (Llama-3-8B
    widths, bf16) and a draft at Llama-3.2-1B widths (random weights from
    seed 1), DraftConfig(k=SPEC_K). Returns the weight stream's launches in
    the int8 engine's traced window."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.inference.serving.speculative import DraftConfig
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    vocab = model.config.vocab_size
    rng = np.random.RandomState(seed + 17)
    prompts = [rng.randint(1, vocab, int(rng.randint(16, 257))).tolist()
               for _ in range(SPEC_REQUESTS)]
    dcfg = draft_config()
    draft = LlamaForCausalLM(dcfg, device="cuda", dtype=torch.bfloat16, seed=1)
    say("speculative", target_layers=model.config.num_hidden_layers,
        draft_layers=dcfg.num_hidden_layers, draft_hidden=dcfg.hidden_size,
        draft_params=draft.num_params(), k=SPEC_K,
        cut=f"draft at {DRAFT_LAYERS} of Llama-3.2-1B's 16 layers, without its "
            "rope_scaling (the port has none)")
    cfg = dict(draft=DraftConfig(draft, SPEC_K), **SPEC_CFG)
    engine = ServingEngine(model, ServeConfig(**cfg))
    graphed = [r.generated for r in serve(engine, prompts, NEW_TOKENS, "spec")]
    hold_spec_captures(engine, "spec")
    say("spec", **engine.stats()["spec"])
    profile_spec(engine, seed, "spec")
    spec_teacher_forced(engine, prompts, seed)
    del engine
    eager = ServingEngine(model, ServeConfig(**cfg), eager=True)
    want = [r.generated for r in serve(eager, prompts, NEW_TOKENS, "spec-eager")]
    del eager
    plain = ServingEngine(model, ServeConfig(**SPEC_CFG))
    base = [r.generated for r in serve(plain, prompts, NEW_TOKENS, "spec-plain")]
    del plain
    torch.cuda.empty_cache()
    say("speculative", graphed_tokens_equal_eager=graphed == want,
        greedy_equal_plain_engine=json.dumps([a == b for a, b in zip(graphed, base)]),
        token_agreement_with_plain=round(sum(x == y for a, b in zip(graphed, base)
                                              for x, y in zip(a, b)) / sum(map(len, base)), 4))
    if graphed != want:
        raise AssertionError("the graphed speculative engine's tokens differ from eager")
    # sampled: every other request, the trace served twice
    params = sampled_params(len(prompts), seed)
    runs = []
    for run in range(2):
        engine = ServingEngine(model, ServeConfig(**cfg))
        runs.append([r.generated for r in serve(engine, prompts, NEW_TOKENS,
                                                f"spec-sampled-run{run}", params)])
        hold_spec_captures(engine, "spec-sampled")
        del engine
    say("speculative", sampled_replay_bit_identical=runs[0] == runs[1],
        sampled_requests_differing_from_greedy=sum(
            runs[0][i] != graphed[i] for i, p in enumerate(params) if p))
    if runs[0] != runs[1]:
        raise AssertionError("two sampled speculative runs of one trace differ")
    # int8 target: graphed against eager, the stream 225 times a verify call
    cfg8 = dict(weight_dtype="int8", **cfg)
    engine = ServingEngine(model, ServeConfig(**cfg8))
    got = [r.generated for r in serve(engine, prompts, NEW_TOKENS, "spec-int8")]
    hold_spec_captures(engine, "spec-int8")
    say("spec-int8", **engine.stats()["spec"])
    launches = trace_spec_window(engine, "spec-int8", seed)
    del engine
    eager = ServingEngine(model, ServeConfig(**cfg8), eager=True)
    want = [r.generated for r in serve(eager, prompts, NEW_TOKENS, "spec-int8-eager")]
    del eager, draft, cfg, cfg8
    torch.cuda.empty_cache()
    say("spec-int8", graphed_tokens_equal_eager=got == want)
    if got != want:
        raise AssertionError("the graphed int8 speculative engine's tokens differ from eager")
    # the self-draft control: draft = target, f32, TF32 off
    prec = f32_matmuls()
    m32 = LlamaForCausalLM(LlamaConfig.llama3_8b(num_hidden_layers=SELF_DRAFT_LAYERS),
                           device="cuda", dtype=torch.float32, seed=seed)
    plain = ServingEngine(m32, ServeConfig(**SPEC_CFG))
    base = [r.generated for r in serve(plain, prompts, NEW_TOKENS, "self-draft-plain")]
    del plain
    engine = ServingEngine(m32, ServeConfig(draft=DraftConfig(m32, SPEC_K), **SPEC_CFG))
    got = [r.generated for r in serve(engine, prompts, NEW_TOKENS, "self-draft")]
    hold_spec_captures(engine, "self-draft")
    sp = engine.stats()["spec"]
    del engine, m32
    torch.cuda.empty_cache()
    say("self-draft", layers=SELF_DRAFT_LAYERS, precision=prec, tokens_equal_plain=got == base,
        **sp)
    if got != base or sp["accept_rate"] < SELF_DRAFT_ACCEPT:
        raise AssertionError(f"the f32 self-draft: tokens equal {got == base}, accept rate "
                             f"{sp['accept_rate']} (want >= {SELF_DRAFT_ACCEPT})")
    return launches



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
                ("fused optimizer (port)", ("multi_tensor_update_kernel",)),
                ("numerics sentinels (port)", ("sentinel_stats_kernel",
                                               "sentinel_finish_kernel")),
                ("conv forward (cuDNN)", ("fprop",)),
                ("conv dgrad (cuDNN)", ("dgrad",)),
                ("conv wgrad (cuDNN)", ("wgrad",)),
                ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
                ("pools", ("max_pool", "avg_pool", "adaptive")),
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
        # a host range's device-side shadow (a span's gpu_user_annotation
        # while the port's Profiler records) is no device work of its own
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
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
                   "M 1, 8, 16, 40, 64; library: cuBLAS on fp16 weights dequantized before the "
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


def time_flash(gen, f32: bool = False, H: int = 32, Hk: int = 8,
               case: str = "training_shape"):
    """The kernels at the training shape (B 1, S 8192, H 32, Hk 8, hd 128,
    causal) on the card, in bf16 (phase 7's calls) or in f32 (phase 14's:
    the f32 route), the plain versions on the same inputs (one call per
    KV-head group, 4 query heads each, so that the S x S scores fit), the
    kernels held against them (f32 with its TF32 control), and the library
    yardstick: SDPA forward, and its backward alone (``torch.autograd.grad``
    of one forward kept alive); bf16 through ``enable_gqa``, f32 over K/V
    expanded to every head, as phase 5's f32 case (faster in f32 than
    ``enable_gqa`` at S 2048 on the H100). ``H`` / ``Hk``: the heads (phase
    25's rank at tensor 2 computes 16 and 4)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, hd = 1, TRAIN_SEQ, 128
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
    errs = hold_flash(case + ("_f32" if f32 else ""), (out, lse), ref_fwd, grads, ref_grads)
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
    say("train-kernels", kernel="flash_attention", case=case, B=B, S=S, H=H,
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
    rounding mode of its ``by_mode`` and each dtype of its ``by_dtype``, the
    fused optimizer's under each mode of its ``by_mode`` (f32 masters with
    a low-precision copy, or not)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops import ring_flash as rf

    return {**{f"flash_{r}_{d}": (w.by_route, r) for r in fa.ROUTES
               for d, w in (("fwd", fa.flash_attention_fwd), ("bwd", fa.flash_attention_bwd))},
            **{f"{name}_{m}": (w.by_mode, m) for m in fn.MODES.values()
               for name, w in (("rms_norm_fwd", fn.rms_norm_fwd),
                               ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx))},
            **{f"{name}_{d}": (w.by_dtype, d) for d in ("float32", "bfloat16")
               for name, w in (("rms_norm_fwd", fn.rms_norm_fwd),
                               ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx))},
            **{f"multi_tensor_update_{m}": (fo.multi_tensor_update.by_mode, m)
               for m in ("direct", "master")},
            **{name: (vars(w), "launches") for name, w in (
                ("rms_norm_fwd", fn.rms_norm_fwd), ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx),
                ("int8_matmul", qm.int8_matmul), ("int8_matmul_large_m", qm.int8_matmul_large_m),
                ("int8_matmul_dx", qm.int8_matmul_dx), ("int8_prepass", qm.int8_prepass),
                ("ring_merge", rf.ring_merge),
                ("multi_tensor_update", fo.multi_tensor_update))}}


def read_counts(counters: dict) -> dict:
    return {name: d[key] for name, (d, key) in counters.items()}


def zero_counts(counters: dict):
    for d, key in counters.values():
        d[key] = 0


def expected_launches(layers: int, int8: bool = False, ring: int = 0,
                      f32: bool = False, traced: bool = True, amp: str | None = None,
                      moe: bool = False, recompute: bool = False) -> dict:
    """Per training step: flash forward and backward once per layer (with
    a ring of P ranks, P times each and the merge P - 1 times, one ring
    call a layer), all on flash's f32 route in f32, else all on its wgmma
    route (head_dim 128); RMSNorm forward and backward twice per
    layer and once for the final norm; with int8-frozen projections, the
    tensor-core forward and dX once per projection (7 per layer), and never
    the weight stream; a TrainStep's AdamW one fused optimizer launch for
    every MAX_TENSORS trainable tensors (9 a layer, the embedding, the final
    norm and the head; with int8-frozen projections 2 a layer and those 3;
    an MoE decoder 10 a layer: the router and three stacked expert weights
    in place of three projections). ``recompute``: every decoder layer is
    recomputed in the backward (phase 22c's policies), so flash's forward
    and the layers' two RMSNorm forwards run twice.
    ``traced``: the step is a TrainStep (RMSNorm in its round_first mode,
    the optimizer's update), not an eager forward and backward. ``amp``
    ("O1" or "O2"): an eager step of the AMP loop under ``auto_cast``
    (phase 18): RMSNorm in its fused mode in f32 (a black-list op), flash
    on its wgmma route, and ``Optimizer.step``'s update, with f32 masters
    at O2."""
    from paddle_tpu_torch.ops.flash_attention import ROUTES
    from paddle_tpu_torch.ops.fused_optimizer import MAX_TENSORS

    proj = 7 * layers if int8 else 0
    tensors = (2 if int8 else 10 if moe else 9) * layers + 3
    runs = 2 if recompute else 1
    flash = {"fwd": layers * max(ring, 1) * runs, "bwd": layers * max(ring, 1)}
    route = "f32" if f32 else "wgmma"
    norms = {"fwd": 2 * layers * runs + 1, "bwd_dx": 2 * layers + 1}
    norm_dtype = "float32" if f32 or amp else "bfloat16"
    updates = math.ceil(tensors / MAX_TENSORS) if traced or amp else 0
    return {**{f"flash_{r}_{d}": flash[d] if r == route else 0
               for r in ROUTES for d in ("fwd", "bwd")},
            "rms_norm_fwd": norms["fwd"], "rms_norm_bwd_dx": norms["bwd_dx"],
            # a TrainStep runs the composed form's rounding (a traced call);
            # an eager forward and backward the fused one
            **{f"rms_norm_{d}_{mode}": norms[d] * (traced == (mode == "round_first"))
               for d in ("fwd", "bwd_dx") for mode in ("fused", "round_first")},
            **{f"rms_norm_{d}_{dt}": norms[d] * (dt == norm_dtype)
               for d in ("fwd", "bwd_dx") for dt in ("float32", "bfloat16")},
            "int8_matmul": 0, "int8_matmul_large_m": proj, "int8_matmul_dx": proj,
            "int8_prepass": proj, "ring_merge": layers * max(ring - 1, 0),
            "multi_tensor_update": updates,
            "multi_tensor_update_master": updates * (amp == "O2"),
            "multi_tensor_update_direct": updates * (amp != "O2")}


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
    """Route the training ops' autograd functions, and the fused optimizer
    update, to the plain versions for the reference path of phases 6, 9
    and 14. The package has no such
    switch: a CUDA tensor always reaches the kernel. With ``tf32_flash`` the
    plain flash versions take their f32 products in TF32 (phase 14's
    control)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_optimizer as fo
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
             (rf, "ring_merge", rf.ring_merge_plain),
             (fo, "multi_tensor_update", fo.multi_tensor_update_plain))
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


@contextlib.contextmanager
def moe_routing(model, logits: dict, flips: dict | None = None):
    """Record each MoE layer's router logits into ``logits`` (``flips``
    None), or route each layer from the recorded ones: the router's output
    takes the recorded values (exactly: the difference is added in f32) and
    keeps its own gradient; ``flips`` gets, per layer, the tokens whose
    top-k experts from the model's own logits differ from the recorded
    logits' choice."""
    from paddle_tpu_torch.distributed.fleet import moe as M

    def hook(mod, inp, out, i, k):
        if flips is None:
            logits[i] = out.detach()
            return None
        rec = logits[i]
        flips[i] = int((M.topk_routing(out.detach(), k)[0]
                        != M.topk_routing(rec, k)[0]).any(0).sum())
        return (out.float() + (rec.float() - out.detach().float())).to(out.dtype)

    hooks = [lyr.mlp.gate.register_forward_hook(
        lambda mod, inp, out, i=i, k=lyr.mlp.top_k: hook(mod, inp, out, i, k))
        for i, lyr in enumerate(model.llama.layers)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def llama_loss(model, ids, labels, aux: float = 0.0):
    """The model's mean cross entropy, plus ``aux`` times the sum of the
    decoder layers' MoE load-balance losses where ``aux`` is given."""
    loss = model(ids, labels=labels)[0]
    if aux:
        loss = loss + aux * sum(lyr.mlp.aux_loss for lyr in model.llama.layers)
    return loss


def make_train_step(model, aux: float = 0.0, recompute_policy: str | None = None, **kw):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, lambda x, y: llama_loss(model, x, y, aux),
                     recompute_policy=recompute_policy, **kw)


def f32_matmuls() -> str:
    """Raise unless f32 matrix products run in full f32 (torch's default:
    TF32 off, precision "highest"); returns the setting."""
    import torch

    prec = torch.get_float32_matmul_precision()
    if torch.backends.cuda.matmul.allow_tf32 or prec != "highest":
        raise AssertionError(f"f32 matmuls run in TF32 (precision {prec!r})")
    return prec


def check_train_step(seed: int, int8: bool = False, f32: bool = False, moe: bool = False):
    """Phase 6 (phase 9 with ``int8``: every projection int8-frozen; phase 14
    with ``f32``: the model at its default f32, flash on its f32 route;
    phase 22b with ``moe``: Mixtral-8x7B's widths, the loss with the
    routers' aux losses): the same 2-layer model and batch through the
    kernels and through the plain versions. In f32 the plain path runs
    once more with its flash in TF32, a control that the gradient limit
    must fail."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    phase = ("int8-step-check" if int8 else "f32-step-check" if f32 else
             "moe-step-check" if moe else "train-step-check")
    loss_tol, grad_tol = (F32_STEP_LOSS_RTOL, F32_STEP_GRAD_FRAC) if f32 else (
        STEP_LOSS_RTOL, STEP_GRAD_FRAC)
    dtype = torch.float32 if f32 else torch.bfloat16
    extra = {"f32_matmul_precision": f32_matmuls()} if f32 else {}
    aux = MOE_AUX_COEF if moe else 0.0
    cfg = (mixtral_config(CHECK_LAYERS) if moe else
           LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS))
    kern = LlamaForCausalLM(cfg, device="cuda", dtype=dtype, seed=seed)
    plain = LlamaForCausalLM(cfg, device="cuda", dtype=dtype, seed=seed + 1)
    if int8:
        quantize_projections(kern)
        quantize_projections(plain)
    plain.load_state_dict(kern.state_dict())
    ids, labels = token_batch(np.random.RandomState(seed + 2), CHECK_SEQ, cfg.vocab_size)
    counters = training_counters()
    results = {}
    # an MoE model's plain path routes from the kernel path's logits (see
    # moe_routing): rounding would otherwise move a token near a tie to
    # another expert, a discrete change no rounding limit describes
    logits, flips = {"eager": {}, "step": {}}, {"eager": {}, "step": {}}

    def routed(name, model, kind):
        if not moe:
            return contextlib.nullcontext()
        return moe_routing(model, logits[kind], None if name == "kernel" else flips[kind])

    runs = (("kernel", kern), ("plain", plain)) + ((("tf32_control", plain),) if f32 else ())
    for name, model in runs:
        before = read_counts(counters)
        with (plain_kernels(tf32_flash=name == "tf32_control") if name != "kernel"
              else contextlib.nullcontext()), routed(name, model, "eager"):
            loss = llama_loss(model, ids, labels, aux)
            loss.backward()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in read_counts(counters).items()}
        want = (expected_launches(CHECK_LAYERS, int8, f32=f32, traced=False, moe=moe)
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
        steps[name] = make_train_step(model, aux)
        with (plain_kernels() if name == "plain" else contextlib.nullcontext()), \
                routed(name, model, "step"):
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
    if phase == "train-step-check":
        hold_watchdog(steps["kernel"], kern, ids, labels, phase)
    say(phase, layers=CHECK_LAYERS, seq=CHECK_SEQ, trainable=n_trainable, **extra,
        loss_kernel=loss_k, loss_plain=loss_p, loss_rel_diff=loss_rel, loss_tol=loss_tol,
        worst_grad_frac=worst[0], worst_grad=worst[1], grad_tol=grad_tol,
        trainstep_loss_kernel=losses["kernel"], trainstep_loss_plain=losses["plain"],
        worst_m_frac=moment_worst["m"], m_tol=tols["m"], worst_v_frac=moment_worst["v"],
        v_tol=tols["v"], **({"tokens_routed_otherwise_unpinned": flips} if moe else {}))
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
    ``count`` it reads no launch counter and profiles through the bare
    ``torch.profiler``, so that ``tools/train_ab.py`` can time an older
    checkout's package with it. Phase 7 also holds the observability plane
    (:func:`hold_train_observability`)."""
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
    observe = count and phase == "train"
    if count:
        from paddle_tpu_torch.ops import sentinels

    def run(n_steps, step):
        zero_counts(counters)
        if count:
            sentinels.tensor_stats.launches = 0
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
        if count:
            # the sentinels' kernel: once a step at numerics "summary", never at "off"
            want_sent = n_steps if step._numerics_mode != "off" else 0
            if sentinels.tensor_stats.launches != want_sent:
                raise AssertionError(f"{phase}: the sentinels launched "
                                     f"{sentinels.tensor_stats.launches} times in {n_steps} "
                                     f"steps, expected {want_sent}")
            counts = dict(counts, sentinel_stats=sentinels.tensor_stats.launches)
        return losses, times, counts

    warm_losses, warm_times, _ = run(1, step)
    losses, times, counts = run(TRAIN_STEPS, step)
    steps_peak = torch.cuda.max_memory_allocated() / 2**30
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
    if count:
        from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

        profiler = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU])
    else:
        profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profiler as prof, (capture_sentinels() if observe
                            else contextlib.nullcontext({})) as captured:
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    obs = None
    if observe:
        obs = hold_train_observability(step, prof, captured, per_kernel, busy,
                                       model_flops / step_s / BF16_FLOP_PER_S)
        obs["sentinel_launches"] = counts["sentinel_stats"]
        del captured, step
        step = hold_numerics_off(model, step_s, steps_peak, obs, run)
    del step, model
    torch.cuda.empty_cache()
    return {"launches": counts, "step_ms": 1e3 * step_s, "device_ms_by_kind": by_kind(per_kernel),
            "max_memory_allocated_gib": peak,
            "device_busy_share": busy / wall if busy else None, "observability": obs}


# ---------------------------------------------------------------------------
# the observability plane (profiler), held inside phases 3, 6, 7 and 21c
# ---------------------------------------------------------------------------

def reset_observability():
    """Zero the port's registry (and with it the goodput ledger and the
    attribution caches) and empty its span ring."""
    from paddle_tpu_torch.profiler import spans, telemetry

    telemetry.reset()
    spans.clear()


@contextlib.contextmanager
def capture_sentinels():
    """Within: the gradients the TrainStep's sentinels read (``grads``) and
    the host values the step fetched (``host``)."""
    from paddle_tpu_torch.profiler import numerics

    got: dict = {}
    tree, host = numerics.sentinel_tree, numerics.host_sentinels

    def tree_(loss, grads, params, mode, reduce=None):
        got["grads"] = dict(grads)
        return tree(loss, grads, params, mode, reduce=reduce)

    def host_(sent):
        got["host"] = host(sent)
        return got["host"]

    numerics.sentinel_tree, numerics.host_sentinels = tree_, host_
    try:
        yield got
    finally:
        numerics.sentinel_tree, numerics.host_sentinels = tree, host


def host_digest(grads: dict) -> int:
    """The digest of ``grads`` recomputed on the host from copies: the
    wrapping u32 sum of every element's f32 bit pattern (a bf16's bits
    shifted left by 16)."""
    import numpy as np
    import torch

    total = 0
    for g in grads.values():
        a = g.detach().cpu()
        if a.dtype == torch.bfloat16:
            total += int(np.sum(a.view(torch.int16).numpy().view(np.uint16),
                                dtype=np.uint64)) << 16
        else:
            total += int(np.sum(a.float().numpy().view(np.uint32), dtype=np.uint64))
    return total % 2**32


def hold_train_observability(step, prof, captured: dict, per_kernel: dict, busy_s: float,
                             peak_share: float) -> dict:
    """Phase 7's profiled step through the port's Profiler: the sentinels
    against the clip's norm, zero counts and a host digest; the exported
    Chrome trace; the device time under ``jit.dispatch`` against the busy
    time; the MFU gauge against the model-FLOPs share, the MFU and roofline
    fraction before the clamp at most ROOFLINE_CEIL; the goodput fraction;
    then EXPORT_STEPS steps writing one telemetry snapshot each.
    Returns the readings."""
    import tempfile

    import torch

    from paddle_tpu_torch.nn.clip import _norm
    from paddle_tpu_torch.profiler import goodput, telemetry

    host, grads = captured["host"], captured["grads"]
    clip_norm = torch.sqrt(sum(_norm(g).square() for g in grads.values())).item()
    norm_rel = abs(host["grad_norm"] - clip_norm) / clip_norm
    if not norm_rel <= SENTINEL_NORM_RTOL:
        raise AssertionError(f"train: the sentinels' grad_norm {host['grad_norm']} against the "
                             f"clip's {clip_norm} ({norm_rel} relative)")
    counts = {k: host[k] for k in ("loss_nonfinite", "grad_nonfinite", "param_nonfinite")}
    if any(counts.values()):
        raise AssertionError(f"train: nonfinite counts {counts}")
    digest = host_digest(grads)
    if digest != host["digest"]:
        raise AssertionError(f"train: the sentinels' digest {host['digest']}, the host's "
                             f"recomputation {digest}")
    captured.clear()
    del grads
    sentinel_ms = sum(us for name, us in per_kernel.items() if "sentinel_" in name) / 1e3
    with tempfile.TemporaryDirectory() as d:
        path = prof.export(os.path.join(d, "step.json"))
        names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    missing = [k for k in TRACE_KERNELS if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"train: the exported Chrome trace names no {missing}")
    dev = prof.device_trace_summary(("jit.dispatch",))
    under = dev["annotations"]["jit.dispatch"]
    busy_ms = 1e3 * busy_s
    if not abs(under["device_ms"] - busy_ms) <= DEVICE_TRACE_RTOL * busy_ms:
        raise AssertionError(f"train: device time under jit.dispatch {under} against the "
                             f"step's busy {busy_ms} ms")
    mfu = telemetry.gauge("jit.program_mfu", program="step").value
    if not abs(mfu - peak_share) <= MFU_RTOL * peak_share:
        raise AssertionError(f"train: jit.program_mfu {mfu} against the model-FLOPs share "
                             f"{peak_share}")
    raw = step._prog_costs.unclamped["step"]
    if not all(0 < v <= ROOFLINE_CEIL for v in raw.values()):
        raise AssertionError(f"train: the step's MFU and roofline fraction before the clamp "
                             f"{raw}")
    fraction = goodput.fraction()
    if not (fraction is not None and 0 < fraction <= 1):
        raise AssertionError(f"train: goodput fraction {fraction}")
    cost = step._prog_costs.get("step")
    out = {"grad_norm": host["grad_norm"], "clip_norm": clip_norm, "norm_rel_diff": norm_rel,
           "digest": digest, "sentinel_device_ms": sentinel_ms,
           "dispatch_device_ms": under["device_ms"], "dispatch_kernels": under["kernels"],
           "dispatch_linked": under["linked"], "device_busy_ms": busy_ms,
           "program_mfu": mfu, "bf16_peak_share": peak_share,
           "program_roofline_frac": telemetry.gauge("jit.program_roofline_frac",
                                                    program="step").value,
           "program_roofline_frac_unclamped": raw["roofline_frac"],
           "counted_tflop": cost.flops / 1e12, "counted_gb": cost.hbm_bytes / 1e9,
           "goodput_fraction": fraction}
    # the JSONL export: one snapshot a step
    with tempfile.TemporaryDirectory() as d:
        step._tel_every, step._tel_dir = 1, d
        ids = torch.zeros((1, TRAIN_SEQ), dtype=torch.int64,
                          device=step.model.parameters()[0].device)
        for _ in range(EXPORT_STEPS):
            step(ids, ids)
        step._tel_every = 0
        recs = [json.loads(line) for f in os.listdir(d) if f.endswith(".jsonl")
                for line in open(os.path.join(d, f))]
    by_step: dict = {}
    for r in recs:
        by_step[r["step"]] = by_step.get(r["step"], 0) + 1
    if sorted(by_step) != list(range(1, EXPORT_STEPS + 1)) or len(set(by_step.values())) != 1:
        raise AssertionError(f"train: telemetry export records by step {by_step}")
    out["export_records_per_step"] = next(iter(by_step.values()))
    say("train-observability", **{k: (round(v, 6) if isinstance(v, float) else v)
                                  for k, v in out.items()})
    return out


def hold_numerics_off(model, step_s: float, steps_peak: float, obs: dict, run):
    """Phase 7 again with ``TrainStep(numerics="off")`` over the same model
    (a fresh optimizer state, the caller's freed first): one warm-up and
    TRAIN_STEPS timed steps, the sentinels never launched; both step-time
    means, their ratio and both peaks. Returns the new step."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    off = make_train_step(model, numerics="off")
    run(1, off)
    _, times, _ = run(TRAIN_STEPS, off)
    off_s = sum(times) / len(times)
    off_peak = torch.cuda.max_memory_allocated() / 2**30
    obs.update(summary_step_ms=1e3 * step_s, off_step_ms=1e3 * off_s,
               summary_to_off=step_s / off_s, summary_peak_gib=steps_peak,
               off_peak_gib=off_peak, peak_gib_above_off=steps_peak - off_peak)
    say("train-numerics", summary_step_ms=round(1e3 * step_s, 3),
        off_step_ms=round(1e3 * off_s, 3), summary_to_off=round(step_s / off_s, 4),
        sentinel_device_ms=round(obs["sentinel_device_ms"], 5),
        summary_peak_gib=round(steps_peak, 3), off_peak_gib=round(off_peak, 3),
        peak_gib_above_off=round(steps_peak - off_peak, 3))
    return off


def check_sentinels(seed: int) -> dict:
    """Phase 17s: the numerics sentinels' kernel (``ops.sentinels.
    tensor_stats``) over phase 7's gradients and parameters (78 bf16
    tensors, 2 x 1.923e9 elements; a NaN, two Infs and an -Inf put in),
    against its plain version: digests and counts exactly, sums of
    squares within SENTINEL_SQ_RTOL; timed (CUDA events around eager
    calls: its metadata goes through pinned memory each call) beside its
    byte bound and the plain version. No PyTorch call computes the same
    function (library_ms null)."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops import sentinels

    shapes = llama_shapes(LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 29)
    ts = [(0.02 * torch.randn(s, generator=gen, device="cuda")).bfloat16()
          for s in shapes * 2]
    ts[0].view(-1)[12345] = float("nan")
    ts[3].view(-1)[-1] = float("inf")
    ts[len(shapes)].view(-1)[0] = float("-inf")
    ts[-1].view(-1)[0] = float("inf")
    sq, ints = sentinels.tensor_stats(ts)
    psq, pints = sentinels.tensor_stats_plain(ts)
    torch.cuda.synchronize()
    if not torch.equal(ints, pints):
        bad = (ints != pints).nonzero().tolist()[:8]
        raise AssertionError(f"sentinels: digests or counts differ from the plain version at {bad}")
    want = [0] * len(ts)
    for i in (0, 3, len(shapes), len(ts) - 1):
        want[i] = 1
    if ints[1].tolist() != want:
        raise AssertionError(f"sentinels: counts {ints[1].tolist()}, expected {want}")
    fin = torch.isfinite(psq)
    if not torch.equal(fin, torch.isfinite(sq)):
        raise AssertionError("sentinels: the finite sums of squares differ from the plain "
                             "version's")
    rel = ((sq[fin] - psq[fin]).abs() / psq[fin]).max().item()
    if not rel <= SENTINEL_SQ_RTOL:
        raise AssertionError(f"sentinels: sums of squares {rel} relative from the plain version")
    max_err = (sq[fin] - psq[fin]).abs().max().item()
    ms = eager_ms(lambda i: sentinels.tensor_stats(ts), 1, iters=10, warmup=2)
    plain = eager_ms(lambda i: sentinels.tensor_stats_plain(ts), 1, iters=3, warmup=1)
    n = sum(t.numel() for t in ts)
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    bound, bound_by = bound_ms(nbytes, 3 * n)
    out = {"max_abs_err": max_err, "ms": round(ms, 5), "plain_ms": round(plain, 5),
           "bound_ms": round(bound, 5), "bound_by": bound_by, "library_ms": None,
           "at": f"one read of phase 7's {len(shapes)} bf16 gradients and {len(shapes)} "
                 f"parameters ({n} elements): each tensor's sum of squares, digest and "
                 "NaN/Inf count; digests and counts held exactly against the plain "
                 f"version, sums of squares to {SENTINEL_SQ_RTOL} relative; no PyTorch "
                 "call computes the same function"}
    say("sentinels", tensors=len(ts), elements=n, max_abs_err=max_err, sq_max_rel=rel,
        ms=out["ms"], bound_ms=out["bound_ms"], bound_by=bound_by,
        bound_share=round(bound / ms, 4), plain_ms=out["plain_ms"])
    del ts, sq, psq
    torch.cuda.empty_cache()
    return out


def hold_watchdog(step, model, ids, labels, phase: str) -> dict:
    """Phase 6's model after its TrainStep: ``lm_head`` (its own tensor
    group) poisoned with NaN on the card; the next step's watchdog event
    names that group alone among the parameters, counts one nonfinite
    event and dumps the flight ring (into a temporary PADDLE_FLIGHT_DIR)."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.profiler import telemetry

    d = tempfile.mkdtemp(prefix="flight_")
    old = os.environ.get("PADDLE_FLIGHT_DIR")
    os.environ["PADDLE_FLIGHT_DIR"] = d
    try:
        reset_observability()
        with torch.no_grad():
            model.lm_head.weight[0, :4] = float("nan")
        step(ids, labels)
        torch.cuda.synchronize()
        ev = step._num_watchdog.last_event
        named = {g for g, c in ev["groups"].items() if "param" in c}
        events = telemetry.snapshot().get('train.numerics_events{kind="nonfinite"}')
        with open(os.path.join(d, "flight.0.jsonl")) as f:
            header = json.loads(f.readline())
    finally:
        if old is None:
            os.environ.pop("PADDLE_FLIGHT_DIR", None)
        else:
            os.environ["PADDLE_FLIGHT_DIR"] = old
        shutil.rmtree(d, ignore_errors=True)
    if (ev["kind"], named, ev["groups"]["lm_head"].get("param")) != ("nonfinite", {"lm_head"}, 4):
        raise AssertionError(f"{phase}: the watchdog's event {ev}")
    if events != 1 or header["reason"] != "numerics:nonfinite":
        raise AssertionError(f"{phase}: numerics events {events}, flight dump {header}")
    out = {"named": sorted(named), "param_nonfinite": ev["param_nonfinite"],
           "grad_nonfinite": ev["grad_nonfinite"], "numerics_events": events,
           "flight_dump_reason": header["reason"]}
    say(phase, watchdog=json.dumps(out))
    return out


def hold_serving_telemetry(engine, reqs, phase: str) -> dict:
    """Phase 3's served trace against the registry and the span ring:
    ``serve.admitted`` / ``completed`` / ``steps`` equal ``stats()``,
    ``serve.ttft_us`` counts a request each, the ``serve.decode.dispatch``
    spans the decode calls, ``serve.compiles`` the captures, and the decode
    roofline fraction lies in (0, 1], its ratio before the gauge's clamp in
    (0, ROOFLINE_CEIL]."""
    from paddle_tpu_torch.profiler import spans, telemetry

    snap = telemetry.snapshot()
    st = engine.stats()
    done = sum(r.status == "done" for r in reqs)
    dispatch = sum(e["name"] == "serve.decode.dispatch" for e in spans.entries())
    got = {"admitted": snap["serve.admitted"], "completed": snap["serve.completed"],
           "steps": snap["serve.steps"], "ttft_count": snap["serve.ttft_us.count"],
           "decode_dispatch_spans": dispatch,
           "compiles": sum(v for k, v in snap.items() if k.startswith("serve.compiles{"))}
    want = {"admitted": len(reqs), "completed": done, "steps": st["steps"],
            "ttft_count": len(reqs), "decode_dispatch_spans": st["program_calls"]["decode"],
            "compiles": sum(st["captures"].values())}
    frac = snap.get("serve.decode_roofline_frac")
    # the gauge is clamped to 1, so a byte count too low would pass as 1:
    # its ratio before the clamp must lie in (0, ROOFLINE_CEIL]
    raw = engine._prog_costs.unclamped.get("decode_roofline_frac")
    if got != want or not (frac is not None and 0 < frac <= 1) \
            or not (raw is not None and 0 < raw <= ROOFLINE_CEIL):
        raise AssertionError(f"{phase}: telemetry {got}, expected {want}; decode roofline "
                             f"fraction {frac}, {raw} before the clamp")
    out = dict(got, decode_roofline_frac=frac, decode_roofline_frac_unclamped=raw,
               decode_roofline_tok_s=snap.get("serve.decode_roofline_tok_s"),
               decode_mfu=snap.get('jit.program_mfu{program="decode"}'),
               prefill_mfu=snap.get('jit.program_mfu{program="prefill"}'),
               ttft_us_p50=snap.get("serve.ttft_us.p50"),
               inter_token_us_p50=snap.get("serve.inter_token_us.p50"))
    say(phase, telemetry=json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 17: the fused optimizer step at phase 7's tensors
# ---------------------------------------------------------------------------

OPT_STEPS = 3
OPT_WD, OPT_CLIP = 0.1, 1.0
# the seeded gradients' scale: their global norm (~4.4 over phase 7's 1.9e9
# parameters) exceeds OPT_CLIP, so the clip's scale is applied
OPT_GRAD_STD = 1e-4
# f32 operations an element of the AdamW update with the clip: the clip's
# product, the decay's, 3 for m, 4 for v, then v / c2, sqrt, + eps, m / c1,
# * lr, / den and p - step
OPT_FLOPS_PER_ELEMENT = 16


def llama_shapes(cfg) -> list:
    """The trainable tensors' shapes of a Llama of ``cfg`` (untied head),
    in ``named_parameters()`` order."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    layer = [(h, h), (h, kv), (h, kv), (h, h), (h, f), (h, f), (f, h), (h,), (h,)]
    return [(cfg.vocab_size, h)] + layer * cfg.num_hidden_layers + [(h,), (h, cfg.vocab_size)]


@contextlib.contextmanager
def opt_regime(value: str):
    """``PADDLE_OPT_FUSED=value`` inside the block: "1" the fused step,
    "0" the per-parameter loop."""
    import os

    saved = os.environ.get("PADDLE_OPT_FUSED")
    os.environ["PADDLE_OPT_FUSED"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PADDLE_OPT_FUSED", None)
        else:
            os.environ["PADDLE_OPT_FUSED"] = saved


def update_bytes(entries) -> int:
    """Bytes one multi-tensor update must move: every operand read once,
    every result written once (parameter, state, low-precision copy)."""
    total = 0
    for e in entries:
        state = sum(v.element_size() for v in e.state.values())
        low = 0 if e.low is None else e.low.element_size()
        total += e.param.numel() * (2 * e.param.element_size() + e.grad.element_size()
                                    + 2 * state + low)
    return total


def check_fused_optimizer(seed: int, master: bool = False) -> dict:
    """Phase 17: phase 7's AdamW (LR, weight decay OPT_WD, global-norm clip
    OPT_CLIP) over phase 7's trainable tensors in bf16, the same seeded
    gradients to two optimizers: ``Optimizer.step()`` in the fused regime
    (the multi-tensor kernel) against the per-parameter regime
    (``PADDLE_OPT_FUSED=0``, the card's composed update), parameters and
    moments equal bit for bit after each of OPT_STEPS steps, with the
    kernel's launches. Then the update alone is timed (CUDA events around
    eager calls: its metadata goes through pinned memory each call, so it
    is not replayed as a graph) beside its byte bound, its plain version on
    the same entries, the whole fused step and the per-parameter step
    (clip included), and ``torch.optim.AdamW(fused=True)`` on the same
    tensors (timed only: it rounds each element once, not per op).
    With ``master`` (phase 18d) the optimizers keep f32 master weights
    (``multi_precision``, as ``amp.decorate`` sets it): the kernel's master
    mode updates the f32 master, moments and writes the bf16 parameter,
    masters held bit for bit too; ``torch.optim.AdamW(fused=True)`` then
    runs over f32 copies of the masters with f32 gradients, another
    function (no bf16 copy written), timed only."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.clip import global_norm_scale
    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.optimizer import AdamW

    shapes = llama_shapes(LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 17)
    kern = [torch.nn.Parameter((0.02 * torch.randn(s, generator=gen, device="cuda")).bfloat16())
            for s in shapes]
    comp = [torch.nn.Parameter(p.detach().clone()) for p in kern]
    n_params = sum(p.numel() for p in kern)

    def make(ps):
        return AdamW(LR, parameters=ps, weight_decay=OPT_WD,
                     grad_clip=ClipGradByGlobalNorm(OPT_CLIP), multi_precision=master)

    opts = {"kernel": make(kern), "composed": make(comp)}
    launched = []
    for _ in range(OPT_STEPS):
        for pk, pc in zip(kern, comp):
            pk.grad = (OPT_GRAD_STD * torch.randn(pk.shape, generator=gen,
                                                  device="cuda")).bfloat16()
            pc.grad = pk.grad.clone()
        before = fo.multi_tensor_update.launches
        mode_before = fo.multi_tensor_update.by_mode["master" if master else "direct"]
        with opt_regime("1"):
            opts["kernel"].step()
        launched.append(fo.multi_tensor_update.launches - before)
        if fo.multi_tensor_update.by_mode["master" if master else "direct"] - mode_before != \
                launched[-1]:
            raise AssertionError(f"the fused optimizer's launches were not all in the "
                                 f"{'master' if master else 'direct'} mode")
        with opt_regime("0"):
            opts["composed"].step()
        if fo.multi_tensor_update.launches - before != launched[-1]:
            raise AssertionError("the per-parameter regime launched the fused kernel")
        torch.cuda.synchronize()
        for i, (pk, pc) in enumerate(zip(kern, comp)):
            sk, sc = opts["kernel"]._accumulators[id(pk)], opts["composed"]._accumulators[id(pc)]
            held = [("param", pk, pc), ("m", sk["m"], sc["m"]), ("v", sk["v"], sc["v"])]
            if master:
                held.append(("master", opts["kernel"]._master_weights[id(pk)],
                             opts["composed"]._master_weights[id(pc)]))
            for name, a, b in held:
                bits = torch.int16 if a.element_size() == 2 else torch.int32
                if a.dtype != b.dtype or not torch.equal(a.detach().view(bits),
                                                         b.detach().view(bits)):
                    raise AssertionError(f"fused optimizer: {name} of tensor {i} "
                                         f"{tuple(pk.shape)} differs from the composed update "
                                         f"after step {len(launched)}")
    want = math.ceil(len(kern) / fo.MAX_TENSORS)
    if launched != [want] * OPT_STEPS:
        raise AssertionError(f"fused optimizer launched {launched} a step, expected {want}")
    max_err = max((pk.detach().float() - pc.detach().float()).abs().max().item()
                  for pk, pc in zip(kern, comp))

    # timing: the per-parameter and the fused step, then the update alone
    opt = opts["kernel"]
    composed_step = "not measured: two optimizers with masters fill the card"
    if not master:
        with opt_regime("0"):
            composed_step = round(eager_ms(lambda i: opts["composed"].step(), 1, iters=5,
                                           warmup=1), 5)
    for p in comp:
        p.grad = None
    del opts["composed"], comp
    torch.cuda.empty_cache()
    with opt_regime("1"):
        fused_step_ms = eager_ms(lambda i: opt.step(), 1, iters=10, warmup=2)
    scale = global_norm_scale(OPT_CLIP, [p.grad for p in kern], [True] * len(kern))
    entries = [fo.Entry(opt._master_weights[id(p)] if master else p.detach(), p.grad,
                        opt._accumulators[id(p)], LR, opt._hyper(), scale,
                        low=p.detach() if master else None)
               for p in kern]
    lay = fo.layout(AdamW, entries)
    t = opt._step_count + 1
    ms = eager_ms(lambda i: fo.multi_tensor_update(AdamW, entries, t, lay), 1, iters=10,
                  warmup=2)
    plain = eager_ms(lambda i: fo.multi_tensor_update_plain(AdamW, entries, t), 1, iters=5,
                     warmup=1)
    nbytes = update_bytes(entries)
    bound, bound_by = bound_ms(nbytes, OPT_FLOPS_PER_ELEMENT * n_params, F32_FLOP_PER_S)
    if master:  # f32 copies of the masters, f32 gradients: the library's own function
        lib_params = [torch.nn.Parameter(opt._master_weights[id(p)].clone()) for p in kern]
    del entries, lay, opt, opts
    if master:
        for lp, p in zip(lib_params, kern):
            lp.grad = p.grad.float()
            p.grad = None
        kern = lib_params
    lib = torch.optim.AdamW(kern, lr=LR, weight_decay=OPT_WD, fused=True)
    library = eager_ms(lambda i: lib.step(), 1, iters=10, warmup=2)
    what = ("bf16 tensors with f32 masters (the kernel's master mode: master, m and v f32, "
            "the bf16 parameter written)") if master else "bf16 tensors"
    out = {"max_abs_err": max_err, "ms": round(ms, 5), "plain_ms": round(plain, 5),
           "bound_ms": round(bound, 5), "bound_by": bound_by, "library_ms": round(library, 5),
           "at": f"one AdamW update (lr {LR}, weight decay {OPT_WD}, the global-norm clip's "
                 f"scale applied) of phase 7's {len(kern)} {what} ({n_params} "
                 f"parameters, {TRAIN_LAYERS} layers at Llama-3-8B widths); held bit for bit "
                 f"against the composed per-parameter update over {OPT_STEPS} steps; "
                 + ("library_ms is torch.optim.AdamW(fused=True) over f32 copies of the "
                    "masters with f32 gradients, another function (no bf16 copy written)"
                    if master else
                    "library_ms is torch.optim.AdamW(fused=True) on the same tensors")}
    say("fused-optimizer-master" if master else "fused-optimizer", tensors=len(kern),
        params=n_params, steps_held_bit_for_bit=OPT_STEPS,
        launches_per_step=json.dumps(launched), max_abs_err=max_err, ms=out["ms"],
        bound_ms=out["bound_ms"], bound_by=bound_by, bound_share=round(bound / ms, 4),
        update_gb=round(nbytes / 1e9, 3), plain_ms=out["plain_ms"],
        fused_step_ms=round(fused_step_ms, 5), composed_step_ms=composed_step,
        library_ms=out["library_ms"], library_ratio=round(ms / library, 4))
    del lib, kern
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: mixed-precision training (amp)
# ---------------------------------------------------------------------------

# the O1 run's depth: the f32 model, its f32 gradients and moments and the
# bf16 casts its products save (about 48 GiB at 4 layers) fit the card
AMP_O1_LAYERS = TRAIN_LAYERS
# the fp16 check's loss scale: not a power of two, so 1/scale rounds in the
# unscale (to each gradient's dtype first, as the reference does)
AMP_FP16_SCALE = 1000.0
AMP_CHECK_STEPS = 3
# - the 2-layer AMP steps (18c), kernels against plain: every op but flash
#   and RMSNorm is the same arithmetic on the same inputs, and the fused
#   optimizer's kernel equals its plain version bit for bit (phase 17), so
#   the paths part only by those kernels' rounding. Held where a wrong
#   kernel shows, a leaf (parameter) at a time: step 1's unscaled gradient,
#   ||g_kernel - g_plain|| / ||g_plain||, within AMP_GRAD_RTOL; the f32
#   master's change (O1: the f32 parameter's) over AMP_CHECK_STEPS steps,
#   ||d_kernel - d_plain|| / ||d_plain||, within AMP_MASTER_RTOL. Each limit
#   lies between the sound runs' largest reading and a control: step 2's
#   gradient against step 1's (another batch, what a kernel that read the
#   wrong rows would give), read in every run and held above AMP_GRAD_RTOL;
#   a master left unchanged reads 1. AdamW moves a weight by about lr a
#   step whatever its gradient's size, so a gradient near 0 that the paths
#   round apart flips its weight's step: the masters' limit sits well above
#   the gradients'. On an H100, sound runs read at most 0.009 (gradients)
#   and 0.063 (masters; the card test's small width), the control 1.37 to
#   1.44. Each step's loss within STEP_LOSS_RTOL and the scalers' states
#   equal.
AMP_GRAD_RTOL = 0.05
AMP_MASTER_RTOL = 0.2


def make_amp(model, level: str, dtype: str = "bfloat16", scale: float | None = None):
    """(model, optimizer, scaler) of the AMP loop: phase 7's AdamW (LR, weight
    decay 0.1, global-norm clip 1.0); at O2 ``amp.decorate`` casts the model
    to ``dtype`` and keeps f32 masters; a ``GradScaler`` with its defaults
    or ``init_loss_scaling=scale``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    if level == "O2":
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    scaler = amp.GradScaler() if scale is None else amp.GradScaler(init_loss_scaling=scale)
    return model, opt, scaler


def amp_step(model, opt, scaler, level: str, dtype: str, ids, labels, poison=None,
             unscale_ms=None, inspect=None):
    """One step of Paddle's AMP loop: forward and loss under
    ``auto_cast(level, dtype)``, ``scaler.scale(loss).backward()``,
    ``scaler.step``, ``scaler.update``, ``clear_grad``. ``poison(model)``
    runs after the backward (a gradient made infinite); ``unscale_ms``, a
    list, gets the unscale's device ms (CUDA events around it);
    ``inspect(model)`` runs after the unscale, on the unscaled gradients.
    Returns the f32 loss."""
    import torch

    from paddle_tpu_torch import amp

    with amp.auto_cast(level=level, dtype=dtype):
        loss, _ = model(ids, labels=labels)
    scaler.scale(loss).backward()
    if poison is not None:
        poison(model)
    if unscale_ms is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        scaler.unscale_(opt)
        ev[1].record()
        torch.cuda.synchronize()
        unscale_ms.append(ev[0].elapsed_time(ev[1]))
    if inspect is not None:
        scaler.unscale_(opt)
        inspect(model)
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return loss.detach()


def hold_amp_state(model, opt, level: str, phase: str):
    """At O2 every parameter low precision with an f32 master in the
    optimizer; at O1 every parameter f32 and no master."""
    import torch

    params = list(model.parameters())
    masters = [opt._master_weights.get(id(p)) for p in params]
    if level == "O2":
        ok = all(p.dtype in (torch.bfloat16, torch.float16) for p in params) and all(
            m is not None and m.dtype == torch.float32 for m in masters)
    else:
        ok = all(p.dtype == torch.float32 for p in params) and not opt._master_weights
    if not ok:
        raise AssertionError(f"{phase}: parameters {sorted({str(p.dtype) for p in params})}, "
                             f"{len(opt._master_weights)} masters")


def train_amp(seed: int, level: str, layers: int) -> dict:
    """Phase 18a (``level`` O2) and 18b (O1): the training cell (Llama-3-8B
    widths, ``layers`` layers, batch 1 x TRAIN_SEQ, phase 7's AdamW and
    clip) through Paddle's eager AMP loop in bf16: the model built in f32,
    at O2 ``decorate``-d to bf16 with f32 masters. One warm-up step and
    TRAIN_STEPS timed ones (host clock, synchronised), exact launches a
    step, then one profiled step's device ms by kind with the unscale's
    device ms on its own. Returns the launches, step ms and peak memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    phase = f"amp-{level}"
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=seed)
    model, opt, scaler = make_amp(model, level)
    torch.cuda.synchronize()
    n_params = model.num_params()
    n_embed = model.llama.embed_tokens.weight.numel()
    say(phase, layers=layers, hidden=cfg.hidden_size, vocab=cfg.vocab_size, seq=TRAIN_SEQ,
        trainable_params=n_params, level=level, amp_dtype="bfloat16",
        param_dtype=str(model.parameters()[0].dtype),
        model_init_s=round(time.perf_counter() - t0, 2))
    rng = np.random.RandomState(seed + 18)
    counters = training_counters()
    per_step = expected_launches(layers, traced=False, amp=level)

    def run(n_steps):
        zero_counts(counters)
        losses, times = [], []
        for _ in range(n_steps):
            ids, labels = token_batch(rng, TRAIN_SEQ, cfg.vocab_size)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = amp_step(model, opt, scaler, level, "bfloat16", ids, labels)
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
    hold_amp_state(model, opt, level, phase)
    if opt._step_count != 1 + TRAIN_STEPS:
        raise AssertionError(f"{phase}: {opt._step_count} optimizer steps (the scaler skipped "
                             "one: a gradient overflowed at the default scale)")
    step_s = sum(times) / len(times)
    attn_flops = layers * 3.5 * flash_counts(True, 1, TRAIN_SEQ, cfg.num_attention_heads,
                                             cfg.num_key_value_heads, 128)[2]
    model_flops = 6 * (n_params - n_embed) * TRAIN_SEQ + attn_flops
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(phase, warmup_step_ms=round(1e3 * warm_times[0], 3), warmup_loss=warm_losses[0],
        step_ms=[round(1e3 * t, 3) for t in times], step_ms_mean=round(1e3 * step_s, 3),
        losses=losses, tokens_per_s=round(TRAIN_SEQ / step_s, 1),
        model_tflop_per_step=round(model_flops / 1e12, 3),
        bf16_peak_share=round(model_flops / step_s / BF16_FLOP_PER_S, 4),
        max_memory_allocated_gib=round(peak, 3), scale=scaler.get_scale_ratio(),
        launches=json.dumps(counts))
    ids, labels = token_batch(rng, TRAIN_SEQ, cfg.vocab_size)
    unscale = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        amp_step(model, opt, scaler, level, "bfloat16", ids, labels, unscale_ms=unscale)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    per_kernel, ops = kernel_times(prof)
    busy = sum(per_kernel.values()) / 1e6
    say(phase, profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
        device_busy_share=round(busy / wall, 4) if busy else "not measured", device_ops=ops)
    say(phase, device_ms_by_kind=json.dumps(by_kind(per_kernel)))
    say(phase, unscale_device_ms=round(unscale[0], 4),
        unscale_note="CUDA events around scaler.unscale_ in the profiled step: a multiply "
                     "and a min/max a gradient, one host read")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {phase} top kernel: {us / 1e3:.4f} ms/step {name[:90]}", flush=True)
    del model, opt, scaler
    torch.cuda.empty_cache()
    return {"launches": counts, "step_ms": 1e3 * step_s, "max_memory_allocated_gib": peak}


def amp_paths(runs: dict, level: str, dtype: str, batches, counters=None,
              per_step=None, phase: str = "amp") -> dict:
    """``len(batches)`` steps of the AMP loop on each of ``runs``
    ({"kernel": (model, opt, scaler), "plain": ...}, built from the same
    weights), the plain one under ``plain_kernels()``. With ``counters``,
    the kernel path's launches must be ``per_step`` a step and the plain
    path's none. Returns each path's losses and, by leaf (parameter name),
    ``grad_gap`` (step 1's unscaled gradients, ||kernel - plain|| /
    ||plain||), ``grad_control`` (the kernel path's step-2 gradient against
    its step-1 one, the same norm) and ``master_gap`` (the masters' change,
    O1: the parameters', ||d_kernel - d_plain|| / ||d_plain||)."""
    import torch

    (mk, ok, _), (mp, op, _) = runs["kernel"], runs["plain"]
    names = [n for n, _ in mk.named_parameters()]
    init = [p.detach().clone() for p in mp.parameters()]
    first, gaps, control = [], {}, {}

    def rel(a, b) -> float:
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    def inspect(name, step):
        def read(model):
            grads = [p.grad for p in model.parameters()]
            if name == "kernel" and step == 0:
                first.extend(g.clone() for g in grads)
            elif name == "kernel" and step == 1:
                control.update((n, rel(g, f)) for n, g, f in zip(names, grads, first))
            elif name == "plain" and step == 0:
                gaps.update((n, rel(f, g)) for n, f, g in zip(names, first, grads))
                first.clear()
        return read

    losses = {}
    for name, (model, opt, scaler) in runs.items():
        before = read_counts(counters) if counters else None
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            losses[name] = [amp_step(model, opt, scaler, level, dtype, ids, labels,
                                     inspect=inspect(name, i)).item()
                            for i, (ids, labels) in enumerate(batches)]
        torch.cuda.synchronize()
        if counters:
            launched = {k: n - before[k] for k, n in read_counts(counters).items()}
            want = ({k: len(batches) * v for k, v in per_step.items()} if name == "kernel"
                    else dict.fromkeys(counters, 0))
            if launched != want:
                raise AssertionError(f"{phase}: the {name} path launched {launched}, "
                                     f"expected {want}")
        hold_amp_state(model, opt, level, phase)
    masters = {}
    for n, pk, pp, p0 in zip(names, mk.parameters(), mp.parameters(), init):
        a = ok._master_weights.get(id(pk), pk.detach()).float()
        b = op._master_weights.get(id(pp), pp.detach()).float()
        masters[n] = rel(a - p0.float(), b - p0.float())
    del init
    return {"losses": losses, "grad_gap": gaps, "grad_control": control, "master_gap": masters}


def hold_amp_paths(got: dict, phase: str) -> dict:
    """:func:`amp_paths`' readings within their limits: each loss within
    STEP_LOSS_RTOL, every leaf's gradient within AMP_GRAD_RTOL and its
    master's change within AMP_MASTER_RTOL, and every leaf's control
    reading above AMP_GRAD_RTOL (the limit tells a wrong gradient apart).
    Returns the readings' extremes."""
    losses = got["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["plain"]))
    worst = {k: max(got[k].items(), key=lambda kv: kv[1]) for k in ("grad_gap", "master_gap")}
    least = min(got["grad_control"].items(), key=lambda kv: kv[1])
    out = {"loss_rel_diff": loss_rel, "grad_gap_max": worst["grad_gap"][1],
           "grad_gap_leaf": worst["grad_gap"][0], "grad_control_min": least[1],
           "grad_control_leaf": least[0], "master_gap_max": worst["master_gap"][1],
           "master_gap_leaf": worst["master_gap"][0]}
    if not (loss_rel <= STEP_LOSS_RTOL and worst["grad_gap"][1] <= AMP_GRAD_RTOL
            and worst["master_gap"][1] <= AMP_MASTER_RTOL and least[1] > AMP_GRAD_RTOL):
        raise AssertionError(f"{phase}: kernels against plain {out} (limits: loss "
                             f"{STEP_LOSS_RTOL}, gradients {AMP_GRAD_RTOL}, masters "
                             f"{AMP_MASTER_RTOL}; the control must exceed {AMP_GRAD_RTOL}); "
                             f"losses {losses}")
    return out


def check_amp(seed: int):
    """Phase 18c: 2 layers at seq CHECK_SEQ, AMP_CHECK_STEPS steps of the AMP
    loop through the kernels and through the plain versions
    (``plain_kernels()``, the fused optimizer's too), the same weights and
    batches: O2 bf16, O1 bf16, and O2 fp16 with
    ``GradScaler(init_loss_scaling=AMP_FP16_SCALE)``, held by
    :func:`hold_amp_paths` (losses, each leaf's gradient and master
    change, the control), the scalers' state dicts and step counts equal,
    the kernel path's launches exact and the plain path's none. Then one
    more fp16 step on both, one gradient made infinite after the backward:
    it must be skipped, parameters, masters and moments bit for bit as they
    were, the step count unmoved, the scale halved."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=CHECK_LAYERS)
    rng = np.random.RandomState(seed + 19)
    batches = [token_batch(rng, CHECK_SEQ, cfg.vocab_size) for _ in range(AMP_CHECK_STEPS + 1)]
    counters = training_counters()
    for level, dtype, scale in (("O2", "bfloat16", None), ("O1", "bfloat16", None),
                                ("O2", "float16", AMP_FP16_SCALE)):
        phase = f"amp-check-{level}-{dtype}"
        kern = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=seed)
        plain = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=seed + 1)
        plain.load_state_dict(kern.state_dict())
        runs = {"kernel": make_amp(kern, level, dtype, scale),
                "plain": make_amp(plain, level, dtype, scale)}
        del kern, plain
        got = amp_paths(runs, level, dtype, batches[:AMP_CHECK_STEPS], counters,
                        expected_launches(CHECK_LAYERS, traced=False, amp=level), phase)
        held = hold_amp_paths(got, phase)
        (_, ok, sk), (_, op, sp) = runs["kernel"], runs["plain"]
        if sk.state_dict() != sp.state_dict() or ok._step_count != op._step_count:
            raise AssertionError(f"{phase}: scalers {sk.state_dict()} / {sp.state_dict()}, "
                                 f"steps {ok._step_count} / {op._step_count}")
        extra = {}
        if dtype == "float16":
            extra = hold_skip(runs, level, dtype, batches[-1], phase)
        say(phase, layers=CHECK_LAYERS, seq=CHECK_SEQ, steps=AMP_CHECK_STEPS,
            losses_kernel=got["losses"]["kernel"], losses_plain=got["losses"]["plain"],
            loss_tol=STEP_LOSS_RTOL, **held, grad_rtol=AMP_GRAD_RTOL,
            master_rtol=AMP_MASTER_RTOL, scaler_state=json.dumps(sk.state_dict()),
            scaler_state_equal=True, **extra)
        del runs, ok, sk, op, sp, got
        torch.cuda.empty_cache()


def hold_skip(runs: dict, level: str, dtype: str, batch, phase: str) -> dict:
    """One more step on each run, the first parameter's gradient made
    infinite after the backward: skipped (parameters, masters and moments
    bit for bit, the step count unmoved), the scale halved, the scalers
    equal."""
    import torch

    def poison(model):
        g = model.parameters()[0].grad
        g.view(-1)[0] = float("inf")

    def state(model, opt):  # every tensor the step may touch, in a fixed order
        return ([p.detach() for p in model.parameters()] + list(opt._master_weights.values())
                + [x for s in opt._accumulators.values() for x in s.values()])

    out = {}
    for name, (model, opt, scaler) in runs.items():
        snap = [t.cpu() for t in state(model, opt)]   # host copies: both runs fill the card
        count, scale = opt._step_count, scaler.get_scale_ratio()
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            amp_step(model, opt, scaler, level, dtype, *batch, poison=poison)
        torch.cuda.synchronize()
        after = state(model, opt)
        same = len(after) == len(snap) and all(torch.equal(a, b.cpu())
                                               for a, b in zip(snap, after))
        del snap, after
        if not same or opt._step_count != count or scaler.get_scale_ratio() != scale / 2:
            raise AssertionError(f"{phase}: the {name} path's step with an infinite gradient "
                                 f"was not skipped: state kept {same}, steps {count} -> "
                                 f"{opt._step_count}, scale {scale} -> "
                                 f"{scaler.get_scale_ratio()}")
        out[f"skip_{name}_scale"] = f"{scale} -> {scaler.get_scale_ratio()}"
    if runs["kernel"][2].state_dict() != runs["plain"][2].state_dict():
        raise AssertionError(f"{phase}: the scalers differ after the skipped step")
    return {**out, "skipped_step_state_bit_for_bit": True}


# ---------------------------------------------------------------------------
# phase 19: ERNIE-3.0 base, finetune and inference
# ---------------------------------------------------------------------------

# bench.py's ERNIE headline (ernie_finetune_bench): ErnieConfig.base() in
# bf16, batch 32 x 128, AdamW 5e-5 through TrainStep, 2 warm-up and 6
# timed steps; here every row's real length is drawn from
# ERNIE_MIN_LEN..seq and the rest is pad id 0, so the mask has work to do
ERNIE_BATCH, ERNIE_SEQ = 32, 128
ERNIE_MIN_LEN = 16
ERNIE_LR = 5e-5
ERNIE_WARMUP, ERNIE_STEPS = 2, 6
# the sequence classifier's trainable tensors: 5 in the embeddings, 16 a
# layer, 2 in the pooler, 2 in the classifier
ERNIE_TENSORS = 5 + 16 * 12 + 2 + 2
ERNIE_CHECK_STEPS = 3
ERNIE_EVAL = ((32, 128), (8, 512))
ERNIE_EVAL_CALLS = 10
# 19e: the reference's separable task (tests/test_ernie.py: the class is
# whether token 1 leads the text) under amp O2 for ERNIE_LEARN_STEPS steps;
# the mean of the last 5 losses must end below ERNIE_LEARN_RATIO of the
# first 5's (the test's criterion). At full width and the test's depth
# (ErnieConfig.tiny()'s 2 layers): from random weights at lr 5e-5 the
# 12-layer encoder does not learn the task in 200 steps on an H100 (its
# loss stays near 0.73, above ln 2, while the first 5 losses' mean of
# about 1.2 lets the criterion hold by chance at times), so at 12 layers
# the phase could not tell a sound step from a broken one
ERNIE_LEARN_STEPS = 200
ERNIE_LEARN_RATIO = 0.6
ERNIE_LEARN_LAYERS = 2


def ernie_batch(rng, batch: int, seq: int, vocab: int, task: bool = False):
    """(ids [batch, seq] int64, labels [batch], real tokens) on the card:
    seeded ids from 1 (2 with ``task``) up, each row's real length drawn
    from ERNIE_MIN_LEN..seq and the rest pad id 0; random labels, and with
    ``task`` token 1 first exactly in the rows labelled 1."""
    import numpy as np
    import torch

    ids = rng.randint(2 if task else 1, vocab, (batch, seq)).astype("int64")
    lengths = rng.randint(ERNIE_MIN_LEN, seq + 1, batch)
    ids[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    labels = rng.randint(0, 2, batch).astype("int64")
    if task:
        ids[labels == 1, 0] = 1
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda(),
            int(lengths.sum()))


def ernie_model(seed: int, dropout: bool, dtype, **widths):
    """ErnieForSequenceClassification (2 classes) at ErnieConfig.base()
    widths (or ``widths`` over them) on the card, weights from ``seed``;
    without ``dropout`` the bench's 0 / 0, else the config's 0.1 / 0.1."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForSequenceClassification

    if not dropout:
        widths.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return ErnieForSequenceClassification(ErnieConfig.base(**widths), num_classes=2,
                                          device="cuda", dtype=dtype, seed=seed)


def ernie_train_step(model):
    """bench.py's step: AdamW(5e-5) (its default weight decay) and the
    cross entropy of the classifier's logits, through TrainStep."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(ERNIE_LR, parameters=model.parameters())
    return TrainStep(model, opt, lambda ids, y: F.cross_entropy(model(ids), y))


def optimizer_launches(steps: int, master: bool = False, tensors: int | None = None) -> dict:
    """Launches of ``steps`` steps whose only hand-written kernel is the
    fused optimizer: once for every MAX_TENSORS trainable tensors
    (``tensors``, ERNIE_TENSORS = 201 at 12 layers by default: 2 a step),
    in master mode under amp O2; no flash (ERNIE's mask sends attention to
    the composed path; the vision models have none) and no RMSNorm, int8
    or ring kernel."""
    from paddle_tpu_torch.ops.fused_optimizer import MAX_TENSORS

    updates = steps * math.ceil((tensors or ERNIE_TENSORS) / MAX_TENSORS)
    want = {k: 0 for k in training_counters()}
    want.update({"multi_tensor_update": updates,
                 f"multi_tensor_update_{'master' if master else 'direct'}": updates})
    return want


def ernie_attention_ms(model, ids, calls: int = 5) -> float:
    """Device ms of one layer's masked attention, forward and backward
    (the composed ``sdpa_ref``), at this batch's shapes and mask: the sum
    of the kernels of ``calls`` calls in a profiler trace, a call (host
    issue gaps left out, as in the step's device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.nn import functional as F

    cfg = model.ernie.config
    b, s = ids.shape
    h, d = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    dtype = model.parameters()[0].dtype
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
               .requires_grad_(True) for _ in range(3))
    mask = model.ernie._additive_mask(ids, None)
    do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)

    def call():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        torch.autograd.grad(out, (q, k, v), do)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    per_kernel, _ = kernel_times(prof)
    return sum(per_kernel.values()) / 1e3 / calls


def ernie_flops(model, tokens: int, b: int, s: int) -> float:
    """A training step's model FLOPs: 6 x non-embedding parameters x
    tokens, plus the masked attention's products over every (query, key)
    of the padded batch, 4 b h s^2 d forward and twice that backward."""
    from paddle_tpu_torch.nn import Embedding

    cfg = model.ernie.config
    n_embed = sum(m.weight.numel() for m in model.modules() if isinstance(m, Embedding))
    n = sum(p.numel() for p in model.parameters()) - n_embed
    attn = 3 * 4 * b * s * s * cfg.hidden_size * cfg.num_hidden_layers
    return 6 * n * tokens + attn


# 19a's A/B of the observability plane: ERNIE_AB_ROUNDS rounds of turns
# summary, off, bare, bare, off, summary of ERNIE_STEPS steps each (bare:
# numerics off and PADDLE_TELEMETRY=0, so no spans and no attribution)
ERNIE_AB_ROUNDS = 2
ERNIE_AB_ORDER = ("summary", "off", "bare", "bare", "off", "summary")


def hold_ernie_numerics(model, step, rng, busy_ms: float) -> dict:
    """Phase 19a's observability A/B on the host-bound ERNIE step: ``step``
    (numerics at the default ``summary``) against a ``TrainStep(numerics=
    "off")`` over the same model and that one with telemetry off ("bare":
    no spans, no attribution, the nearest to the step before the plane),
    in ERNIE_AB_ORDER turns. Each step is timed as 19a's (synchronised
    before and after) and split on the host: the time until the step
    returns, and the wait for the device after it. In ``summary`` turns
    the step's numerics are split too: the sentinels' enqueue, the wait
    for the device before their one copy (made explicit, so that the copy
    itself waits for nothing) and the host fold (the copy, ``publish`` and
    the watchdog). Prints every turn and the means by mode; the device's
    idle share is 1 - ``busy_ms`` (the profiled step's) over the step."""
    import statistics

    import torch

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import spans

    phase = "ernie-numerics"
    cfg = model.ernie.config
    off = TrainStep(model, AdamW(ERNIE_LR, parameters=model.parameters()),
                    lambda ids, y: F.cross_entropy(model(ids), y), numerics="off")
    split = {"sentinels_enqueue": [], "wait": [], "fold": []}
    enqueue, handle = step._sentinels, step._handle_numerics

    def timed_sentinels(*a, **k):
        t0 = time.perf_counter()
        out = enqueue(*a, **k)
        split["sentinels_enqueue"].append(time.perf_counter() - t0)
        return out

    def timed_handle(loss, sent):
        t0 = time.perf_counter()
        torch.cuda.current_stream().synchronize()
        t1 = time.perf_counter()
        handle(loss, sent)
        split["wait"].append(t1 - t0)
        split["fold"].append(time.perf_counter() - t1)

    step._sentinels, step._handle_numerics = timed_sentinels, timed_handle

    def turn(mode, n):
        which = step if mode == "summary" else off
        env = os.environ.get("PADDLE_TELEMETRY")
        if mode == "bare":
            os.environ["PADDLE_TELEMETRY"] = "0"
        spans.enabled(refresh=True)
        host, tail = [], []
        try:
            for _ in range(n):
                ids, labels, _ = ernie_batch(rng, ERNIE_BATCH, ERNIE_SEQ, cfg.vocab_size)
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                loss = which(ids, labels)
                s1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append(s1 - s0)
                tail.append(time.perf_counter() - s1)
                if not math.isfinite(loss.item()):
                    raise AssertionError(f"{phase}: a {mode} step's loss {loss.item()}")
        finally:
            if env is None:
                os.environ.pop("PADDLE_TELEMETRY", None)
            else:
                os.environ["PADDLE_TELEMETRY"] = env
            spans.enabled(refresh=True)
        return host, tail

    try:
        for mode in ("off", "bare"):
            turn(mode, ERNIE_WARMUP)
        for v in split.values():
            v.clear()
        turns = []
        for _ in range(ERNIE_AB_ROUNDS):
            for mode in ERNIE_AB_ORDER:
                host, tail = turn(mode, ERNIE_STEPS)
                steps = [h + t for h, t in zip(host, tail)]
                turns.append({"mode": mode, "step_ms": 1e3 * statistics.mean(steps),
                              "host_ms": 1e3 * statistics.mean(host),
                              "tail_wait_ms": 1e3 * statistics.mean(tail)})
                say(phase, turn=len(turns), mode=mode,
                    steps_ms=[round(1e3 * t, 3) for t in steps],
                    **{k: round(v, 3) for k, v in turns[-1].items() if k != "mode"})
    finally:
        del step._sentinels, step._handle_numerics
    out = {}
    for mode in ("summary", "off", "bare"):
        ms = [t["step_ms"] for t in turns if t["mode"] == mode]
        out[mode] = {"step_ms": statistics.mean(ms), "turn_spread": max(ms) / min(ms) - 1,
                     "host_ms": statistics.mean(t["host_ms"] for t in turns
                                                if t["mode"] == mode),
                     "tail_wait_ms": statistics.mean(t["tail_wait_ms"] for t in turns
                                                     if t["mode"] == mode),
                     "device_idle_share": 1 - busy_ms / statistics.mean(ms)}
    out["summary_split_ms"] = {k: 1e3 * statistics.mean(v) for k, v in split.items()}
    out["summary_to_off"] = out["summary"]["step_ms"] / out["off"]["step_ms"]
    out["off_to_bare"] = out["off"]["step_ms"] / out["bare"]["step_ms"]
    say(phase, summary_to_off=round(out["summary_to_off"], 4),
        off_to_bare=round(out["off_to_bare"], 4), busy_ms=round(busy_ms, 3),
        by_mode=json.dumps({m: {k: round(v, 4) for k, v in out[m].items()}
                            for m in ("summary", "off", "bare")}),
        summary_split_ms=json.dumps({k: round(v, 4) for k, v in
                                     out["summary_split_ms"].items()}))
    del off
    return out


def ernie_finetune(seed: int, smi: str) -> dict:
    """Phase 19a: bench.py's ERNIE finetune on the card with ragged rows:
    ERNIE_WARMUP and ERNIE_STEPS timed steps (host clock, synchronised):
    step ms, tokens/s (padded and real), model FLOPs share of the bf16
    peak, peak memory, exact launches (the fused optimizer twice a step);
    then one profiled step's device ms by kind and top kernels, the masked
    attention's share (its own device ms a layer, forward and backward, x
    layers, over the profiled step's device time) and the optimizer
    kernel's. Returns the model, its launches and numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    phase = "ernie-finetune"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ernie_model(seed, dropout=False, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    cfg = model.ernie.config
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    if n_tensors != ERNIE_TENSORS:
        raise AssertionError(f"{phase}: {n_tensors} trainable tensors, not {ERNIE_TENSORS}")
    say(phase, card=repr(smi), layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads, ffn=cfg.intermediate_size, vocab=cfg.vocab_size,
        params=n_params, tensors=n_tensors, batch=ERNIE_BATCH, seq=ERNIE_SEQ,
        model_init_s=round(time.perf_counter() - t0, 2))
    step = ernie_train_step(model)
    rng = np.random.RandomState(seed + 19)
    counters = training_counters()

    def run(n_steps):
        zero_counts(counters)
        losses, times, real = [], [], 0
        for _ in range(n_steps):
            ids, labels, n_real = ernie_batch(rng, ERNIE_BATCH, ERNIE_SEQ, cfg.vocab_size)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
            real += n_real
        counts = read_counts(counters)
        want = optimizer_launches(n_steps)
        if counts != want:
            raise AssertionError(f"{phase} launched {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase} losses are not finite: {losses}")
        return losses, times, counts, real

    warm_losses, warm_times, _, _ = run(ERNIE_WARMUP)
    losses, times, counts, real = run(ERNIE_STEPS)
    step_s = sum(times) / len(times)
    padded = ERNIE_BATCH * ERNIE_SEQ
    flops = ernie_flops(model, padded, ERNIE_BATCH, ERNIE_SEQ)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(phase, warmup_step_ms=[round(1e3 * t, 3) for t in warm_times],
        step_ms=[round(1e3 * t, 3) for t in times], step_ms_mean=round(1e3 * step_s, 3),
        losses=losses, tokens_per_s_padded=round(padded / step_s, 1),
        tokens_per_s_real=round(real / ERNIE_STEPS / step_s, 1),
        real_token_share=round(real / ERNIE_STEPS / padded, 4),
        model_tflop_per_step=round(flops / 1e12, 4),
        bf16_peak_share=round(flops / step_s / BF16_FLOP_PER_S, 4),
        max_memory_allocated_gib=round(peak, 3),
        fused_optimizer_launches_per_step=counts["multi_tensor_update"] / ERNIE_STEPS,
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    ids, labels, _ = ernie_batch(rng, ERNIE_BATCH, ERNIE_SEQ, cfg.vocab_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    per_kernel, ops = kernel_times(prof)
    busy = sum(per_kernel.values()) / 1e3
    kinds = by_kind(per_kernel)
    attn_ms = ernie_attention_ms(model, ids)
    say(phase, profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(busy, 3),
        device_busy_share=round(busy / 1e3 / wall, 4) if busy else "not measured",
        device_ops=ops, device_ms_by_kind=json.dumps(kinds))
    opt_ms = kinds.get("fused optimizer (port)", 0.0)
    say(phase, masked_attention_ms_per_layer=round(attn_ms, 4),
        masked_attention_share=(round(cfg.num_hidden_layers * attn_ms / busy, 4) if busy
                                else "not measured"),
        fused_optimizer_device_ms=opt_ms,
        fused_optimizer_share=round(opt_ms / busy, 4) if busy else "not measured",
        note="attention: the kernels of forward+backward calls of the composed masked "
             "attention alone at this batch's shapes (profiler), x layers, over the "
             "profiled step's device ms")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {phase} top kernel: {us / 1e3:.4f} ms/step {name[:90]}", flush=True)
    hold_ernie_numerics(model, step, rng, busy)
    del step
    return {"model": model, "launches": counts, "step_ms": 1e3 * step_s, "peak_gib": peak}


def ernie_dropout(seed: int):
    """Phase 19b: the same steps with the config's 0.1 / 0.1 dropout (the
    model's one generator draws every mask): step ms; then from one set of
    weights and one batch, two steps from the same generator state give
    the same loss and a third from another state a different one."""
    import numpy as np
    import torch

    phase = "ernie-dropout"
    model = ernie_model(seed, dropout=True, dtype=torch.bfloat16)
    cfg = model.ernie.config
    step = ernie_train_step(model)
    rng = np.random.RandomState(seed + 19)
    counters = training_counters()
    zero_counts(counters)
    times = []
    for i in range(ERNIE_WARMUP + ERNIE_STEPS):
        ids, labels, _ = ernie_batch(rng, ERNIE_BATCH, ERNIE_SEQ, cfg.vocab_size)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        if i >= ERNIE_WARMUP:
            times.append(time.perf_counter() - s0)
    counts = read_counts(counters)
    if counts != optimizer_launches(ERNIE_WARMUP + ERNIE_STEPS) or not math.isfinite(loss.item()):
        raise AssertionError(f"{phase} launched {counts}, loss {loss.item()}")
    start = [p.detach().clone() for p in model.parameters()]
    state = model.generator.get_state()

    def loss_from(gen_state):
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        model.generator.set_state(gen_state)
        return step(ids, labels).item()

    same = [loss_from(state), loss_from(state)]
    other_gen = torch.Generator(device="cuda")
    other_gen.manual_seed(seed + 1)
    other = loss_from(other_gen.get_state())
    say(phase, dropout=cfg.hidden_dropout_prob,
        attention_dropout=cfg.attention_probs_dropout_prob,
        step_ms=[round(1e3 * t, 3) for t in times],
        step_ms_mean=round(1e3 * sum(times) / len(times), 3),
        same_state_losses=same, other_state_loss=other)
    if same[0] != same[1] or other == same[0]:
        raise AssertionError(f"{phase}: losses from one generator state {same}, from another "
                             f"{other}")
    del step, model
    torch.cuda.empty_cache()
    return 1e3 * sum(times) / len(times)


def ernie_check(seed: int, batch: int = ERNIE_BATCH, seq: int = ERNIE_SEQ,
                phase: str = "ernie-check", **widths) -> dict:
    """Phase 19c: ERNIE_CHECK_STEPS steps of 19a from one state twice, once
    as it runs and once with the fused optimizer's plain version (the same
    forward and backward code): every parameter and optimizer moment bit
    for bit. Prints and returns the largest difference, the losses and the
    share of weight elements the steps moved. ``widths`` override
    ErnieConfig.base()'s (the card test's small model)."""
    import numpy as np
    import torch

    runs = {}
    for name in ("kernel", "plain"):
        model = ernie_model(seed, dropout=False, dtype=torch.bfloat16, **widths)
        n_tensors = len(list(model.parameters()))
        start = [p.detach().clone() for p in model.parameters()]
        step = ernie_train_step(model)
        rng = np.random.RandomState(seed + 190)
        counters = training_counters()
        zero_counts(counters)
        losses = []
        with plain_kernels() if name == "plain" else contextlib.nullcontext():
            for _ in range(ERNIE_CHECK_STEPS):
                ids, labels, _ = ernie_batch(rng, batch, seq, model.ernie.config.vocab_size)
                losses.append(step(ids, labels).item())
        launched = read_counts(counters)["multi_tensor_update"]
        want = optimizer_launches(ERNIE_CHECK_STEPS, tensors=n_tensors)["multi_tensor_update"]
        if launched != (want if name == "kernel" else 0):
            raise AssertionError(f"{phase}: the {name} path launched the optimizer kernel "
                                 f"{launched} times")
        params = [p.detach().clone() for p in model.parameters()]
        moved = sum(int((p != p0).sum()) for p, p0 in zip(params, start))
        moments = [t.clone() for state in step._opt_state for t in state.values()
                   if torch.is_tensor(t)]
        runs[name] = (losses, params, moments, moved)
        del step, model
        torch.cuda.empty_cache()
    (lk, pk, mk, moved), (lp, pp, mp, _) = runs["kernel"], runs["plain"]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(pk + mk, pp + mp))
    same = all(torch.equal(a, b) for a, b in zip(pk + mk, pp + mp)) and lk == lp
    out = dict(steps=ERNIE_CHECK_STEPS, kernel_losses=lk, plain_losses=lp, max_abs_diff=diff,
               bit_for_bit=same, tensors=len(pk), moment_tensors=len(mk), moved_elements=moved,
               moved_share=round(moved / sum(p.numel() for p in pk), 5))
    say(phase, **out)
    if not same or not mk:
        raise AssertionError(f"{phase}: the kernel path differs from the plain path "
                             f"(max abs {diff}, losses {lk} / {lp})")
    return out


def ernie_inference(model, seed: int) -> dict:
    """Phase 19d: EvalStep forwards of the classifier at each ERNIE_EVAL
    shape with ragged rows: ms a batch (host clock over ERNIE_EVAL_CALLS
    synchronised calls after 2 warm-up calls) and sequences/s."""
    import numpy as np
    import torch

    from paddle_tpu_torch.jit import EvalStep

    model.eval()
    run = EvalStep(model, lambda ids: model(ids))
    rng = np.random.RandomState(seed + 191)
    out = {}
    for b, s in ERNIE_EVAL:
        ids, _, real = ernie_batch(rng, b, s, model.ernie.config.vocab_size)
        for _ in range(2):
            logits = run(ids)[0]
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(ERNIE_EVAL_CALLS):
            logits = run(ids)[0]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - s0) / ERNIE_EVAL_CALLS
        if tuple(logits.shape) != (b, 2) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"ernie-eval: logits {tuple(logits.shape)} at {b} x {s}")
        say("ernie-eval", batch=b, seq=s, ms_per_batch=round(ms, 3),
            sequences_per_s=round(b / ms * 1e3, 1), real_token_share=round(real / (b * s), 4))
        out[f"{b}x{s}"] = ms
    model.train()
    return out


def ernie_learns(seed: int) -> dict:
    """Phase 19e: the reference's separable task (the class is whether
    token 1 leads the text) at full width and ERNIE_LEARN_LAYERS layers,
    batch ERNIE_BATCH x ERNIE_SEQ with ragged rows, AdamW 5e-5, the way a
    finetune recipe runs: built in
    f32, ``amp.decorate``-d at O2 (bf16 weights, f32 masters), the config's
    dropout, the eager AMP loop (``auto_cast`` O2, ``GradScaler``), for
    ERNIE_LEARN_STEPS steps: prints the first step at which the mean of
    the last 5 losses fell below ERNIE_LEARN_RATIO of the first 5's and
    fails unless it is below at the end. The fused optimizer runs in its
    master mode."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    phase = "ernie-learns"
    model = ernie_model(seed, dropout=True, dtype=torch.float32,
                        num_hidden_layers=ERNIE_LEARN_LAYERS)
    n_tensors = len(list(model.parameters()))
    opt = AdamW(ERNIE_LR, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler()
    rng = np.random.RandomState(seed + 192)
    counters = training_counters()
    zero_counts(counters)
    losses, times, first_held = [], [], None
    while len(losses) < ERNIE_LEARN_STEPS:
        ids, labels, _ = ernie_batch(rng, ERNIE_BATCH, ERNIE_SEQ, model.ernie.config.vocab_size,
                                     task=True)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = F.cross_entropy(model(ids), labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
        times.append(time.perf_counter() - s0)
        if (first_held is None and len(losses) >= 10
                and np.mean(losses[-5:]) < ERNIE_LEARN_RATIO * np.mean(losses[:5])):
            first_held = len(losses)
    counts = read_counts(counters)
    steps = len(losses)
    hold_amp_state(model, opt, "O2", phase)
    ratio = float(np.mean(losses[-5:]) / np.mean(losses[:5]))
    say(phase, layers=ERNIE_LEARN_LAYERS, steps=steps, criterion_first_held_at_step=first_held,
        first_losses=[round(x, 5) for x in losses[:5]],
        last_losses=[round(x, 5) for x in losses[-5:]], ratio=round(ratio, 4),
        mean_loss_by_20_steps=[round(float(np.mean(losses[i:i + 20])), 4)
                               for i in range(0, steps, 20)],
        limit=ERNIE_LEARN_RATIO, step_ms_mean=round(1e3 * sum(times[1:]) / (steps - 1), 3),
        optimizer_steps=opt._step_count, scale=scaler.get_scale_ratio(),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    if ratio >= ERNIE_LEARN_RATIO:
        raise AssertionError(f"{phase}: after {steps} steps the last 5 losses average "
                             f"{ratio:.4f} of the first 5 (limit {ERNIE_LEARN_RATIO}; first "
                             f"below it at step {first_held})")
    want = optimizer_launches(opt._step_count, master=True, tensors=n_tensors)
    if counts != want:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    del model, opt, scaler
    torch.cuda.empty_cache()
    return {"launches": counts, "steps": first_held}


def ernie(seed: int, smi: str) -> dict:
    """Phase 19: ERNIE-3.0 base (ErnieConfig.base(): vocab 40000, hidden 768,
    12 layers, 12 heads, FFN 3072) in bf16 on the card: 19a finetune,
    19b dropout, 19c kernel against plain, 19d inference, 19e learns under
    amp O2 (at 2 layers). Returns the fused optimizer's launches of 19a (direct mode) and
    19e (master mode)."""
    import torch

    tuned = ernie_finetune(seed, smi)
    ernie_inference(tuned.pop("model"), seed)
    torch.cuda.empty_cache()
    ernie_dropout(seed)
    ernie_check(seed)
    learned = ernie_learns(seed)
    say("ernie", card=repr(smi), finetune_step_ms=round(tuned["step_ms"], 3),
        learn_criterion_first_held_at_step=learned["steps"])
    return {"direct": tuned["launches"]["multi_tensor_update_direct"],
            "master": learned["launches"]["multi_tensor_update_master"]}


# ---------------------------------------------------------------------------
# phase 20: the vision path, ResNet-50 and LeNet
# ---------------------------------------------------------------------------

# bench.py's ResNet-50 headline (resnet50_bench, its TPU branch):
# resnet50(num_classes=1000), model.bfloat16(), Momentum(0.1, momentum=0.9)
# through TrainStep, batch 64 x 3 x 224 x 224 seeded from
# np.random.RandomState, 2 warm-up and 6 timed steps
VISION_BATCH, VISION_HW, VISION_CLASSES = 64, 224, 1000
VISION_LR, VISION_MOMENTUM = 0.1, 0.9
VISION_WARMUP, VISION_STEPS = 2, 6
# resnet50's trainable tensors: 53 convolutions (none with a bias), 53
# batch norms (weight and bias), the classifier's weight and bias
RESNET50_TENSORS = 53 + 2 * 53 + 2
VISION_EVAL_CALLS = 10
# 20b: f32 on the card (TF32 off) against the same model on the CPU, at
# (model, batch, side). From random weights these networks amplify f32
# rounding through their batch norms (ResNet-50's gradients move by about
# 1% of their norm on the CPU when only the batch's order changes), so the
# card is held to that yardstick, measured in the run: its logits' largest
# difference and its gradients' relative norm (over every tensor) within
# VISION_F32_FACTOR times the CPU's against itself with the batch
# reversed (at least one f32 ulp of the largest logit, and 2^-23). A TF32
# control (cuDNN's convolutions in TF32, 10 mantissa bits) must exceed
# both limits.
VISION_F32 = (("resnet18", 4, 64), ("resnet50", 4, 64))
VISION_F32_FACTOR = 16
# 20c: 3 steps of 20a at batch 16, the update kernel against its plain
# version on the same gradients
VISION_CHECK_BATCH, VISION_CHECK_STEPS = 16, 3
# 20e: tests/test_train_lenet.py's jitted test (Adam 3e-3, batch 64, 50
# steps: last loss < 0.8 x first, accuracy on 256 training images > 0.5),
# the weights drawn on the CPU from the seed as the CPU test draws them
# (whether 50 steps meet the criteria depends on the draw, for the
# reference too: the plateau at ln 10 lasts longer from some draws), then
# a LENET_INFO_STEPS-step run for the accuracy beside BASELINE's MNIST
# target (>98%), here on the synthetic surrogate, and the criteria over
# LENET_SEEDS as information
LENET_LR, LENET_BATCH, LENET_STEPS, LENET_INFO_STEPS = 3e-3, 64, 50, 200
LENET_RATIO, LENET_ACCURACY = 0.8, 0.5
LENET_SEEDS = range(8)


def resnet50_train_step(seed: int, dtype=None):
    """bench.py's ResNet-50 step on the card: weights from ``seed``, the
    model cast to bf16 (``dtype`` None) as ``model.bfloat16()`` casts it,
    Momentum through TrainStep."""
    import torch

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import resnet50

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = resnet50(num_classes=VISION_CLASSES, device="cuda", generator=gen)
    model = model.bfloat16() if dtype is None else model.to(dtype)
    opt = Momentum(VISION_LR, parameters=model.parameters(), momentum=VISION_MOMENTUM)
    return model, TrainStep(model, opt, lambda x, y: F.cross_entropy(model(x), y))


def vision_batch(seed: int, batch: int, dtype=None):
    """bench.py's inputs: ``randn`` images and ``randint`` labels from
    ``np.random.RandomState(seed)``, on the card, images in bf16."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, 3, VISION_HW, VISION_HW).astype("float32"))
    y = torch.from_numpy(rng.randint(0, VISION_CLASSES, (batch,)).astype("int64"))
    return x.cuda().to(dtype or torch.bfloat16), y.cuda()


def conv_flops(model, x) -> float:
    """Forward FLOPs of the convolutions and linear layers on ``x``: 2 x
    each output element x its reduction (in_channels / groups x kernel
    area; in_features), from one forward without gradients."""
    import torch

    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def count(mod, args, out):
        red = (mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
               if isinstance(mod, Conv2D) else mod.weight.shape[0])
        total[0] += 2 * out.numel() * red

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2D, Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return float(total[0])


def bn_buffers(model) -> list:
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase

    return [t for m in model.modules() if isinstance(m, _BatchNormBase)
            for t in (m._mean, m._variance)]


def vision_train(seed: int, smi: str) -> dict:
    """Phase 20a: bench.py's ResNet-50 step on the card, VISION_WARMUP and
    VISION_STEPS timed steps (host clock, synchronised): step ms, images/s,
    the conv and fc FLOPs' share of the bf16 peak (forward counted from the
    shapes, the backward twice that), peak memory, exact launches (the
    fused optimizer twice a step for 161 tensors, nothing else); then one
    profiled step's device ms by kind and top kernels; the running
    statistics moved and finite. Returns the model, launches and numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phase = "resnet50-train"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step = resnet50_train_step(seed)
    torch.cuda.synchronize()
    n_tensors = len(list(model.parameters()))
    if n_tensors != RESNET50_TENSORS:
        raise AssertionError(f"{phase}: {n_tensors} trainable tensors, not {RESNET50_TENSORS}")
    x, y = vision_batch(seed, VISION_BATCH)
    flops = 3 * conv_flops(model, x)
    say(phase, card=repr(smi), params=sum(p.numel() for p in model.parameters()),
        tensors=n_tensors, batch=VISION_BATCH, image=VISION_HW, dtype="bfloat16",
        optimizer=f"Momentum({VISION_LR}, momentum={VISION_MOMENTUM})",
        model_init_s=round(time.perf_counter() - t0, 2),
        step_tflop=round(flops / 1e12, 4))
    counters = training_counters()

    def run(n_steps):
        zero_counts(counters)
        losses, times = [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = step(x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
        counts = read_counts(counters)
        want = optimizer_launches(n_steps, tensors=RESNET50_TENSORS)
        if counts != want:
            raise AssertionError(f"{phase} launched {counts}, expected {want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase} losses are not finite: {losses}")
        return losses, times, counts

    _, warm_times, _ = run(VISION_WARMUP)
    losses, times, counts = run(VISION_STEPS)
    step_s = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(phase, warmup_step_ms=[round(1e3 * t, 3) for t in warm_times],
        step_ms=[round(1e3 * t, 3) for t in times], step_ms_mean=round(1e3 * step_s, 3),
        images_per_s=round(VISION_BATCH / step_s, 1), losses=losses,
        bf16_peak_share=round(flops / step_s / BF16_FLOP_PER_S, 4),
        max_memory_allocated_gib=round(peak, 3),
        fused_optimizer_launches_per_step=counts["multi_tensor_update"] / VISION_STEPS,
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    per_kernel, ops = kernel_times(prof)
    busy = sum(per_kernel.values()) / 1e3
    kinds = by_kind(per_kernel)
    say(phase, profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(busy, 3),
        device_busy_share=round(busy / 1e3 / wall, 4) if busy else "not measured",
        device_ops=ops, device_ms_by_kind=json.dumps(kinds))
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {phase} top kernel: {us / 1e3:.4f} ms/step {name[:110]}", flush=True)
    stats = bn_buffers(model)
    moved = sum(int((m != 0).sum()) + int((v != 1).sum())
                for m, v in zip(stats[0::2], stats[1::2]))
    finite = all(bool(torch.isfinite(t).all()) for t in stats)
    say(phase, bn_buffers=len(stats), buffer_dtype=str(stats[0].dtype),
        running_elements_moved=moved, running_stats_finite=finite)
    if not finite or moved == 0:
        raise AssertionError(f"{phase}: running statistics finite={finite}, moved {moved}")
    del step
    return {"model": model, "launches": counts, "step_ms": 1e3 * step_s, "peak_gib": peak,
            "x": x}


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| over every tensor of two lists."""
    num = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    return (num / sum(float(w.double().square().sum()) for w in want)) ** 0.5


def vision_grads(model, x, y):
    """(logits, every parameter's gradient) of one training-mode forward
    and backward, as f32 CPU tensors."""
    from paddle_tpu_torch.nn import functional as F

    model.zero_grad(set_to_none=True)
    out = model(x)
    F.cross_entropy(out, y).backward()
    return out.detach().float().cpu(), [p.grad.detach().float().cpu()
                                        for p in model.parameters()]


@contextlib.contextmanager
def tf32_convs():
    """The port's convolutions with cuDNN in TF32 (the control of 20b)."""
    import torch

    from paddle_tpu_torch.nn.functional import conv

    @contextlib.contextmanager
    def allow():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    saved = conv.full_f32
    conv.full_f32 = allow
    try:
        yield
    finally:
        conv.full_f32 = saved


def vision_f32_check(seed: int) -> dict:
    """Phase 20b: VISION_F32's models in f32 (cuDNN without TF32) on the
    card against the same weights on the CPU: logits and every gradient,
    held within VISION_F32_FACTOR times the CPU's own difference when the
    batch is reversed; a TF32 control must exceed both limits."""
    import numpy as np
    import torch

    from paddle_tpu_torch import vision

    out = {}
    for name, batch, side in VISION_F32:
        phase = f"vision-f32-{name}"
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        model = getattr(vision, name)(device="cuda", generator=gen)
        cpu = getattr(vision, name)(device="cpu")
        cpu.load_state_dict(model.state_dict())
        rng = np.random.RandomState(seed + 20)
        x = torch.from_numpy(rng.randn(batch, 3, side, side).astype("float32"))
        y = torch.from_numpy(rng.randint(0, VISION_CLASSES, (batch,)).astype("int64"))
        rev = torch.arange(batch - 1, -1, -1)
        want, want_g = vision_grads(cpu, x, y)
        again, again_g = vision_grads(cpu, x[rev], y[rev])
        # a floor of one f32 ulp: a reversed batch may happen to sum alike
        ulp = 2.0 ** -23
        noise = (max(float((again[rev] - want).abs().max()), ulp * float(want.abs().max())),
                 max(rel_norm(again_g, want_g), ulp))
        got, got_g = vision_grads(model, x.cuda(), y.cuda())
        err = (float((got - want).abs().max()), rel_norm(got_g, want_g))
        with tf32_convs():
            tf, tf_g = vision_grads(model, x.cuda(), y.cuda())
        control = (float((tf - want).abs().max()), rel_norm(tf_g, want_g))
        limits = tuple(VISION_F32_FACTOR * n for n in noise)
        row = dict(batch=batch, side=side, logits_max_abs=err[0], grads_rel_norm=err[1],
                   cpu_reversed_logits=noise[0], cpu_reversed_grads=noise[1],
                   limits=list(limits), tf32_logits=control[0], tf32_grads=control[1],
                   cudnn_allow_tf32_outside=torch.backends.cudnn.allow_tf32,
                   f32_matmuls=f32_matmuls())
        say(phase, **row)
        if not all(0 < e <= lim for e, lim in zip(err, limits)):
            raise AssertionError(f"{phase}: card against CPU {err}, limits {limits}")
        if not all(c > lim for c, lim in zip(control, limits)):
            raise AssertionError(f"{phase}: the TF32 control {control} does not exceed the "
                                 f"limits {limits}")
        out[name] = row
        del model, cpu
    torch.cuda.empty_cache()
    return out


def vision_check(seed: int) -> dict:
    """Phase 20c: VISION_CHECK_STEPS steps of 20a at VISION_CHECK_BATCH,
    twice from one state: once through the fused optimizer's kernel, once
    (a second model) through its plain version. Each step's gradients are
    taken once, by the kernel side, and fed to both updates, so the
    comparison does not see cuDNN's nondeterministic backward: parameters,
    velocities and batch-norm buffers (each side's own forward) bit for
    bit. Prints, as information, the largest difference between the plain
    side's own gradients and the fed ones (two backward passes from one
    state)."""
    import torch

    phase = "resnet50-check"
    x, y = vision_batch(seed + 1, VISION_CHECK_BATCH)
    (mk, sk), (mp, sp) = resnet50_train_step(seed), resnet50_train_step(seed)
    fed, backward_diff = [], []
    take_k, take_p = sk._loss_and_grads, sp._loss_and_grads

    def recording(params, batch):
        loss, grads = take_k(params, batch)
        fed[:] = [loss, [g.clone() for g in grads]]
        return loss, grads

    def feeding(params, batch):
        _, own = take_p(params, batch)
        backward_diff.append(max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(own, fed[1])))
        return fed[0], [g.clone() for g in fed[1]]

    sk._loss_and_grads, sp._loss_and_grads = recording, feeding
    counters = training_counters()
    launched, losses = {"kernel": 0, "plain": 0}, []
    for _ in range(VISION_CHECK_STEPS):
        zero_counts(counters)
        losses.append(sk(x, y).item())
        launched["kernel"] += read_counts(counters)["multi_tensor_update"]
        zero_counts(counters)
        with plain_kernels():
            sp(x, y)
        launched["plain"] += read_counts(counters)["multi_tensor_update"]
    want = optimizer_launches(VISION_CHECK_STEPS, tensors=RESNET50_TENSORS)
    if launched != {"kernel": want["multi_tensor_update"], "plain": 0}:
        raise AssertionError(f"{phase}: optimizer launches {launched}")
    pk, pp = [p.detach() for p in mk.parameters()], [p.detach() for p in mp.parameters()]
    vk = [st["velocity"] for st in sk._opt_state]
    vp = [st["velocity"] for st in sp._opt_state]
    bk, bp = bn_buffers(mk), bn_buffers(mp)
    held = {what: all(torch.equal(a, b) for a, b in zip(ka, pa))
            for what, ka, pa in (("parameters", pk, pp), ("velocities", vk, vp),
                                 ("bn_buffers", bk, bp))}
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(pk + vk, pp + vp))
    out = dict(steps=VISION_CHECK_STEPS, batch=VISION_CHECK_BATCH, losses=losses,
               max_abs_diff=diff, **{f"{k}_bit_for_bit": v for k, v in held.items()},
               tensors=len(pk), velocities=len(vk), bn_buffers=len(bk),
               moved_share=round(sum(int((v != 0).sum()) for v in vk)
                                 / sum(v.numel() for v in vk), 5),
               backward_nondeterminism_max_abs=backward_diff)
    say(phase, **out)
    if not all(held.values()) or not vk:
        raise AssertionError(f"{phase}: the kernel path differs from the plain path {held} "
                             f"(max abs {diff})")
    del sk, sp, mk, mp
    torch.cuda.empty_cache()
    return out


def vision_eval(model, x) -> dict:
    """Phase 20d: EvalStep forwards of the trained ResNet-50 in eval mode
    (the running statistics) at 20a's batch: ms a batch (host clock over
    VISION_EVAL_CALLS synchronised calls after 2 warm-up calls) and
    images/s."""
    import torch

    from paddle_tpu_torch.jit import EvalStep

    model.eval()
    run = EvalStep(model, lambda a: model(a))
    for _ in range(2):
        logits = run(x)[0]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for _ in range(VISION_EVAL_CALLS):
        logits = run(x)[0]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - s0) / VISION_EVAL_CALLS
    if tuple(logits.shape) != (x.shape[0], VISION_CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"resnet50-eval: logits {tuple(logits.shape)}")
    say("resnet50-eval", batch=x.shape[0], ms_per_batch=round(ms, 3),
        images_per_s=round(x.shape[0] / ms * 1e3, 1))
    model.train()
    return {"ms": ms}


def lenet_run(seed: int, steps: int, train):
    """(model, step, losses) of ``steps`` LeNet TrainStep calls with Adam
    on the card: the initial weights drawn on the CPU from ``seed`` (the
    CPU test's draw), the batches from the port's shuffling loader on the
    card, seeded alike."""
    import torch

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision import LeNet

    gen = torch.Generator()
    gen.manual_seed(seed)
    model = LeNet(device="cpu", generator=gen).cuda()
    step = TrainStep(model, Adam(LENET_LR, parameters=model.parameters()),
                     lambda x, y: F.cross_entropy(model(x), y))
    shuffle = torch.Generator()
    shuffle.manual_seed(seed)
    loader = DataLoader(train, batch_size=LENET_BATCH, shuffle=True, generator=shuffle,
                        drop_last=True, device="cuda")
    losses, batches = [], iter(loader)
    while len(losses) < steps:
        try:
            x, y = next(batches)
        except StopIteration:
            batches = iter(loader)
            continue
        losses.append(step(x, y).item())
    return model, step, losses


def lenet_accuracy(model, ds, n=None) -> float:
    import numpy as np
    import torch

    from paddle_tpu_torch.jit import EvalStep

    n = n or len(ds)
    xs = torch.from_numpy(np.stack([ds[i][0] for i in range(n)])).cuda()
    ys = torch.from_numpy(np.asarray([ds[i][1] for i in range(n)])).cuda()
    return float((EvalStep(model, lambda a: model(a).argmax(1))(xs)[0] == ys).float().mean())


def lenet_learns(seed: int) -> dict:
    """Phase 20e: LeNet on the port's synthetic ``MNIST(mode="train")``
    through TrainStep with Adam on the card (``lenet_run``): after
    LENET_STEPS steps the last loss must be below LENET_RATIO of the first
    and the accuracy on 256 training images above LENET_ACCURACY
    (tests/test_train_lenet.py's criteria, which depend on the draw: the
    reference meets them for most seeds, not all); then on to
    LENET_INFO_STEPS steps, with the accuracy on the whole training split
    printed as information (the surrogate's test split draws other class
    templates, so no model learns it), and the criteria over the seeds
    LENET_SEEDS as information. Adam on 10 tensors: the fused optimizer
    once a step."""
    from paddle_tpu_torch.vision.datasets import MNIST

    phase = "lenet-learns"
    train = MNIST(mode="train")
    counters = training_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    model, _, losses = lenet_run(seed, LENET_STEPS, train)
    at_criterion = lenet_accuracy(model, train, 256)
    first, last = losses[0], losses[-1]
    counts = read_counts(counters)
    want = optimizer_launches(LENET_STEPS, tensors=len(list(model.parameters())))
    model, _, more = lenet_run(seed, LENET_INFO_STEPS, train)
    wall = time.perf_counter() - t0
    held = []
    for s in LENET_SEEDS:
        m, _, ls = lenet_run(s, LENET_STEPS, train)
        held.append(ls[-1] < LENET_RATIO * ls[0] and lenet_accuracy(m, train, 256)
                    > LENET_ACCURACY)
    out = dict(seed=seed, steps=LENET_STEPS, first_loss=first, last_loss=last,
               accuracy_256=at_criterion, criteria=f"last < {LENET_RATIO} x first, "
               f"accuracy > {LENET_ACCURACY}", info_steps=LENET_INFO_STEPS,
               info_last_loss=more[-1], info_train_accuracy=lenet_accuracy(model, train),
               baseline_target="MNIST > 0.98 (real MNIST; this is the synthetic "
               "surrogate, whose test split draws other class templates)",
               info_criteria_held_over_seeds=f"{sum(held)} of {len(held)}",
               ms_per_step=round(1e3 * wall / (LENET_STEPS + LENET_INFO_STEPS), 3),
               launches=json.dumps({k: v for k, v in counts.items() if v}))
    say(phase, **out)
    if counts != want:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    if not (last < LENET_RATIO * first and at_criterion > LENET_ACCURACY):
        raise AssertionError(f"{phase}: losses {first} -> {last}, accuracy {at_criterion}")
    return {"launches": counts["multi_tensor_update"]}


def vision(seed: int, smi: str) -> dict:
    """Phase 20: ResNet-50 (bench.py's step) and LeNet on the card: 20a
    training, 20d eval, 20b f32 against the CPU, 20c the update kernel
    against its plain version, 20e LeNet learns. Returns the fused
    optimizer's launches of 20a's timed steps and of 20e."""
    import torch

    trained = vision_train(seed, smi)
    ev = vision_eval(trained.pop("model"), trained.pop("x"))
    torch.cuda.empty_cache()
    vision_f32_check(seed)
    vision_check(seed)
    lenet = lenet_learns(seed)
    say("vision", card=repr(smi), resnet50_step_ms=round(trained["step_ms"], 3),
        resnet50_images_per_s=round(VISION_BATCH / trained["step_ms"] * 1e3, 1),
        resnet50_eval_ms=round(ev["ms"], 3))
    return {"resnet50": trained["launches"]["multi_tensor_update"], "lenet": lenet["launches"]}


# ---------------------------------------------------------------------------
# phase 21: paddle.Model on the card (hapi, io, transforms, metric, save/load)
# ---------------------------------------------------------------------------

# 21a: Paddle's quick start, as tests/test_train_lenet.py's test_hapi_model_fit
# runs it: Model(LeNet()), Adam(1e-3), CrossEntropyLoss, Accuracy, one epoch
# of the synthetic MNIST at batch 64 normalised by mean 127.5, std 127.5
QUICKSTART_LR, QUICKSTART_BATCH = 1e-3, 64
# 21b: that fit on the card and on the CPU from one initial state over a
# shuffle=False loader, HAPI_CHECK_STEPS steps; each step's loss held to
# VISION_F32_FACTOR times the CPU's own difference when every batch is
# reversed (the same sums in another order), at least one f32 ulp
HAPI_CHECK_STEPS = 20
# 21c: ResNet-50 at the published widths on Flowers-102 (the synthetic
# surrogate: 1000 training images of 3 x 64 x 64), f32 (a paddle.Model
# user's default: fit takes no amp configuration), the reference's image
# pipeline on 4 worker processes, Momentum(0.01, momentum=0.9), one epoch
# (15 steps), the first FLOWERS_WARMUP of them outside the timing
FLOWERS_BATCH, FLOWERS_HW, FLOWERS_CLASSES, FLOWERS_WORKERS = 64, 224, 102, 4
FLOWERS_LR, FLOWERS_MOMENTUM, FLOWERS_WARMUP = 0.01, 0.9, 2
FLOWERS_MEAN, FLOWERS_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def flowers_transform(train: bool):
    """The ImageNet-style pipeline on the host: to f32 in [0, 1], resized
    to 224 x 224, flipped at random (training only), normalised."""
    from paddle_tpu_torch.vision import transforms as T

    flip = [T.RandomHorizontalFlip()] if train else []
    return T.Compose([T.ToTensor(), T.Resize(FLOWERS_HW), *flip,
                      T.Normalize(FLOWERS_MEAN, FLOWERS_STD)])


def lenet_model(seed: int, device: str):
    """``paddle.Model(LeNet())`` prepared as Paddle's quick start prepares
    it, the weights drawn on the CPU from ``seed`` (phase 20e's draw)."""
    import torch

    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision import LeNet

    gen = torch.Generator()
    gen.manual_seed(seed)
    net = LeNet(device="cpu", generator=gen).to(device)
    return Model(net).prepare(Adam(QUICKSTART_LR, parameters=net.parameters()),
                              nn.CrossEntropyLoss(), metric.Accuracy())


def quickstart_mnist():
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.transforms import Normalize

    return MNIST(mode="train", transform=Normalize(mean=[127.5], std=[127.5]))


def hapi_quickstart(seed: int) -> dict:
    """Phase 21a: Paddle's quick start on the card. ``fit`` one epoch of
    the synthetic MNIST (the model's own shuffling loader on the card),
    then a second epoch timed alone, ``evaluate`` on the training split,
    ``predict(stack_outputs=True)``;
    ``test_hapi_model_fit``'s criteria (the last loss below the first,
    ``acc`` among the results), predict's argmax accuracy equal to
    evaluate's, and the fused optimizer once a step (10 tensors)."""
    import numpy as np
    import torch

    phase = "hapi-quickstart"
    model = lenet_model(seed, "cuda")
    train = quickstart_mnist()
    counters = training_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    hist = model.fit(train, batch_size=QUICKSTART_BATCH, epochs=1, verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()        # a second epoch: no first call's set-up
    again = model.fit(train, batch_size=QUICKSTART_BATCH, epochs=1, verbose=0)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    counts = read_counts(counters)
    steps = len(hist["loss"])
    t0 = time.perf_counter()
    res = model.evaluate(train, batch_size=QUICKSTART_BATCH, verbose=0)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (logits,) = model.predict(train, batch_size=QUICKSTART_BATCH, stack_outputs=True)
    predict_s = time.perf_counter() - t0
    labels = np.asarray(train.labels)
    predicted_acc = float((logits.argmax(1) == labels).mean())
    say(phase, steps=steps, first_loss=hist["loss"][0], last_loss=hist["loss"][-1],
        fit_ms_per_step=round(1e3 * fit_s / steps, 3),
        second_epoch_ms_per_step=round(1e3 * again_s / len(again["loss"]), 3),
        second_epoch_last_loss=again["loss"][-1], eval_loss=res["loss"],
        eval_acc=res["acc"], predict_acc=predicted_acc, eval_s=round(eval_s, 3),
        predict_s=round(predict_s, 3), predict_shape=list(logits.shape),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    want = optimizer_launches(2 * steps, tensors=len(list(model.parameters())))
    if counts != want or len(again["loss"]) != steps:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    if steps != -(-len(train) // QUICKSTART_BATCH) or not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError(f"{phase}: {steps} steps, losses {hist['loss'][0]} -> "
                             f"{hist['loss'][-1]}")
    if "acc" not in res or logits.shape != (len(train), 10) or not np.isfinite(logits).all():
        raise AssertionError(f"{phase}: evaluate gave {res}, predict {logits.shape}")
    if abs(predicted_acc - res["acc"]) > 1e-9:
        raise AssertionError(f"{phase}: predict's accuracy {predicted_acc} != evaluate's "
                             f"{res['acc']}")
    return {"launches": counts["multi_tensor_update"], "acc": res["acc"],
            "fit_ms_per_step": 1e3 * fit_s / steps}


def hapi_card_vs_cpu(seed: int) -> dict:
    """Phase 21b: 21a's fit for HAPI_CHECK_STEPS steps over a
    ``shuffle=False`` loader, on the card and on the CPU from one initial
    state; each step's loss on the card within VISION_F32_FACTOR times the
    CPU's own largest relative difference when every batch is reversed
    (at least 2^-23); the fused optimizer once a step on the card."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader, default_collate_fn

    phase = "hapi-card-vs-cpu"
    train = quickstart_mnist()

    def losses(device, collate=None):
        model = lenet_model(seed, device)
        loader = DataLoader(train, batch_size=QUICKSTART_BATCH, shuffle=False,
                            collate_fn=collate, device=device)
        return np.asarray(model.fit(loader, num_iters=HAPI_CHECK_STEPS, verbose=0)["loss"])

    cpu = losses("cpu")
    reversed_ = losses("cpu", lambda batch: default_collate_fn(batch[::-1]))
    counters = training_counters()
    zero_counts(counters)
    card = losses("cuda")
    counts = read_counts(counters)
    noise = float(np.max(np.abs(reversed_ - cpu) / np.abs(cpu)))
    diff = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    limit = VISION_F32_FACTOR * max(noise, 2.0 ** -23)
    say(phase, steps=HAPI_CHECK_STEPS, card_losses=[round(float(v), 6) for v in card],
        max_rel_diff=diff, cpu_batch_reversal_rel_diff=noise, limit=limit,
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    want = optimizer_launches(HAPI_CHECK_STEPS, tensors=10)
    if counts != want:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    if not diff <= limit:
        raise AssertionError(f"{phase}: the card's losses differ by {diff} of the CPU's, "
                             f"limit {limit}")
    return {"launches": counts["multi_tensor_update"], "max_rel_diff": diff, "limit": limit}


def make_timed_loader(*args, warmup: int, **kwargs):
    """A port ``DataLoader`` whose epoch records each batch's arrival at
    the consumer and the time the consumer waited for it (``waits``), and
    profiles the device from batch ``warmup`` to the epoch's end (``prof``,
    over ``window_s``), the profiler started after the workers were
    forked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.io import DataLoader

    class TimedLoader(DataLoader):
        def __iter__(self):
            it = super().__iter__()
            self.waits, self.prof = [], profile(activities=[ProfilerActivity.CUDA])
            started = None
            try:
                while True:
                    if len(self.waits) == warmup:
                        torch.cuda.synchronize()
                        self.prof.start()
                        started = time.perf_counter()
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    self.waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                if started is not None:
                    torch.cuda.synchronize()
                    self.window_s = time.perf_counter() - started
                    self.prof.stop()

    return TimedLoader(*args, **kwargs)


def loader_observability() -> tuple:
    """(dataload.fetch spans in the ring, the goodput stall booked for the
    loader in microseconds)."""
    from paddle_tpu_torch.profiler import spans, telemetry

    fetches = sum(e["name"] == "dataload.fetch" for e in spans.entries())
    stall = telemetry.snapshot().get('goodput.lost_us{reason="stall",site="dataload"}', 0)
    return fetches, stall


def host_rss_gib() -> float:
    """This process's resident host memory (``VmRSS``), GiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def flowers_epoch(seed: int, workers: int = FLOWERS_WORKERS) -> dict:
    """One epoch of ResNet-50 (f32, weights from ``seed``) on the Flowers
    surrogate through ``Model.fit`` on the card, its loader
    (``make_timed_loader``) on ``workers`` worker processes: the model,
    the network, a copy of its initial state (``twin``), the training
    split, the loader's arguments, the history and launches, and over the
    steps after FLOWERS_WARMUP the seconds a step, the consumer's wait for
    the loader, the device's busy seconds and kernel times; peak memory;
    the step's convolution and fc FLOPs."""
    import torch

    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import resnet50
    from paddle_tpu_torch.vision.datasets import Flowers

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    net = resnet50(num_classes=FLOWERS_CLASSES, device="cuda", generator=gen)
    model = Model(net).prepare(
        Momentum(FLOWERS_LR, momentum=FLOWERS_MOMENTUM, parameters=net.parameters()),
        nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 5)))
    train = Flowers(mode="train", transform=flowers_transform(True))
    loader_kw = dict(batch_size=FLOWERS_BATCH, shuffle=True, drop_last=True,
                     num_workers=workers)
    loader = make_timed_loader(train, warmup=FLOWERS_WARMUP, **loader_kw)
    twin = copy.deepcopy(net)
    net.eval()      # the running statistics stay as they are
    x1 = torch.zeros((1, 3, FLOWERS_HW, FLOWERS_HW), device=net.parameters()[0].device)
    flops = 3 * FLOWERS_BATCH * conv_flops(net, x1)
    counters = training_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    reset_observability()
    hist = model.fit(loader, epochs=1, verbose=0)
    counts = read_counts(counters)
    fetch_spans, stall_us = loader_observability()
    timed = len(hist["loss"]) - FLOWERS_WARMUP
    per_kernel, ops = kernel_times(loader.prof)
    return {"model": model, "net": net, "twin": twin, "train": train, "loader_kw": loader_kw,
            "hist": hist, "counts": counts, "timed": timed, "flops": flops,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_s": loader.window_s / timed, "window_s": loader.window_s,
            "first_wait_s": loader.waits[0], "wait_s": sum(loader.waits[FLOWERS_WARMUP:]),
            "busy_s": sum(per_kernel.values()) / 1e6, "per_kernel": per_kernel, "ops": ops,
            "fetch_spans": fetch_spans, "stall_us": stall_us}


def flowers_fit(seed: int, smi: str) -> dict:
    """Phase 21c: ResNet-50 on Flowers-102 through ``Model.fit`` on the
    card: one epoch from a ``DataLoader`` with 4 worker processes (the
    reference's pipeline, shuffled, last batch dropped:
    ``flowers_epoch``), then ``evaluate`` and ``predict`` on the test
    split (predict's top-1 accuracy equal to evaluate's). Prints ms a step
    and images/s over the epoch's steps after FLOWERS_WARMUP, the
    consumer's wait for the loader, the device's busy share and ms by kind
    over those steps, peak memory, the f32 FLOPs' share of the f32 peak
    and the launches (the fused optimizer twice a step, nothing else);
    then the loader alone (an epoch with no model) and the same steps
    through ``TrainStep`` over batches already on the card (from the
    fit's initial state), the cost of the loader and of ``Model`` beside
    the step. Returns the model, its test split and the numbers."""
    import numpy as np
    import torch

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.datasets import Flowers

    phase = "flowers-fit"
    ep = flowers_epoch(seed)
    model, net, twin, train, hist, counts = (ep[k] for k in ("model", "net", "twin", "train",
                                                             "hist", "counts"))
    test = Flowers(mode="test", transform=flowers_transform(False))
    steps, timed, step_s, busy = len(hist["loss"]), ep["timed"], ep["step_s"], ep["busy_s"]
    say(phase, card=repr(smi), params=sum(p.numel() for p in net.parameters()),
        dtype="float32", batch=FLOWERS_BATCH, image=FLOWERS_HW, workers=FLOWERS_WORKERS,
        steps=steps, timed_steps=timed, losses=[round(v, 5) for v in hist["loss"]],
        first_step_wait_ms=round(1e3 * ep["first_wait_s"], 3),
        step_ms=round(1e3 * step_s, 3), images_per_s=round(FLOWERS_BATCH / step_s, 1),
        loader_wait_ms_per_step=round(1e3 * ep["wait_s"] / timed, 3),
        loader_wait_share=round(ep["wait_s"] / ep["window_s"], 4),
        device_busy_share=round(busy / ep["window_s"], 4) if busy else "not measured",
        device_ms_per_step=round(1e3 * busy / timed, 3), device_ops_per_step=ep["ops"] // timed,
        f32_peak_share=round(ep["flops"] / step_s / F32_FLOP_PER_S, 4),
        max_memory_allocated_gib=round(ep["peak_gib"], 3), host_rss_gib=round(host_rss_gib(), 3),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    kinds = {k: round(v / timed, 3) for k, v in by_kind(ep["per_kernel"]).items()}
    say(phase, device_ms_per_step_by_kind=json.dumps(kinds))
    want = optimizer_launches(steps, tensors=RESNET50_TENSORS)
    if counts != want:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    if steps != len(train) // FLOWERS_BATCH or not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"{phase}: {steps} steps, losses {hist['loss']}")
    # the loader's dataload.fetch spans: one a batch and the epoch's end
    # (the fetch that finds it), as the reference's; its waits booked as
    # goodput stall
    say(phase, dataload_fetch_spans=ep["fetch_spans"], batches=steps,
        stall_ms=round(ep["stall_us"] / 1e3, 3))
    if ep["fetch_spans"] != steps + 1 or not ep["stall_us"] > 0:
        raise AssertionError(f"{phase}: {ep['fetch_spans']} dataload.fetch spans for {steps} "
                             f"batches, stall {ep['stall_us']} us")

    t0 = time.perf_counter()
    res = model.evaluate(test, batch_size=FLOWERS_BATCH, verbose=0)
    eval_s = time.perf_counter() - t0
    (logits,) = model.predict(test, batch_size=FLOWERS_BATCH, stack_outputs=True)
    top1 = float((logits.argmax(1) == np.asarray(test.labels)).mean())
    say(phase, eval=json.dumps(res), eval_s=round(eval_s, 3), predict_top1=top1,
        predict_shape=list(logits.shape))
    if sorted(res) != ["acc_top1", "acc_top5", "loss"] or not math.isfinite(res["loss"]):
        raise AssertionError(f"{phase}: evaluate gave {res}")
    if logits.shape != (len(test), FLOWERS_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"{phase}: predict gave {logits.shape}")
    if abs(top1 - res["acc_top1"]) > 1e-9:
        raise AssertionError(f"{phase}: predict's top-1 {top1} != evaluate's "
                             f"{res['acc_top1']}")

    # the loader alone, then TrainStep over its batches already on the card
    torch.cuda.synchronize()
    t_alone = time.perf_counter()
    batches, arrivals = [], []
    for batch in DataLoader(train, **ep["loader_kw"]):
        batches.append(batch)
        arrivals.append(time.perf_counter())
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t_alone
    steady = (len(batches) - 1) / (arrivals[-1] - arrivals[0])
    step = TrainStep(twin, Momentum(FLOWERS_LR, momentum=FLOWERS_MOMENTUM,
                                    parameters=twin.parameters()),
                     lambda x, y: F.cross_entropy(twin(x), y))
    for x, y in batches[:FLOWERS_WARMUP]:
        step(x, y).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in batches[FLOWERS_WARMUP:]:
        step(x, y).item()
    torch.cuda.synchronize()
    direct_s = (time.perf_counter() - t0) / timed
    say(phase, loader_alone_batches_per_s=round(len(batches) / alone_s, 3),
        loader_alone_first_batch_s=round(arrivals[0] - t_alone, 3),
        loader_alone_steady_batches_per_s=round(steady, 3),
        trainstep_on_card_batches_step_ms=round(1e3 * direct_s, 3),
        fit_step_ms=round(1e3 * step_s, 3),
        fit_minus_trainstep_ms=round(1e3 * (step_s - direct_s), 3))
    del batches, step, twin, ep
    return {"model": model, "net": net, "test": test, "launches": counts["multi_tensor_update"],
            "step_ms": 1e3 * step_s, "direct_ms": 1e3 * direct_s}


class FailingItems:
    """Items 0, 1, ... as f32 scalars; item ``bad`` raises ValueError."""

    def __init__(self, n: int, bad: int):
        self.n, self.bad = n, bad

    def __getitem__(self, i):
        import numpy as np

        if i == self.bad:
            raise ValueError(f"item {i} is unreadable")
        return np.float32(i)

    def __len__(self):
        return self.n


def loader_bits(seed: int) -> dict:
    """Phase 21d: an epoch of Flowers (21c's pipeline without the random
    flip, shuffled from a seeded generator) through ``DataLoader`` on the
    card with 0 and FLOWERS_WORKERS workers equals the CPU loader's, bit
    for bit, dtype and shape too. The consumer copies each batch on its
    own stream the moment it arrives and drops it, so a copy that it did
    not wait for, or memory reused under its pending reads, would show.
    Then an exception in a worker (and in the thread) reaches the
    consumer."""
    import torch

    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import Flowers

    phase = "loader-bits"
    ds = Flowers(mode="train", transform=flowers_transform(False))

    def epoch(device, workers):
        gen = torch.Generator()
        gen.manual_seed(seed)
        out = []
        t0 = time.perf_counter()
        for batch in DataLoader(ds, batch_size=FLOWERS_BATCH, shuffle=True, generator=gen,
                                num_workers=workers, device=device):
            if device == "cuda" and not all(t.is_cuda for t in batch):
                raise AssertionError(f"{phase}: a batch left the card")
            out.append([t.clone() for t in batch])
        torch.cuda.synchronize()
        return [[t.cpu() for t in b] for b in out], time.perf_counter() - t0

    want, cpu_s = epoch("cpu", 0)
    seconds = {"cpu_workers_0": round(cpu_s, 3)}
    for workers in (0, FLOWERS_WORKERS):
        got, s = epoch("cuda", workers)
        seconds[f"cuda_workers_{workers}"] = round(s, 3)
        same = len(got) == len(want) and all(
            g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
            for gb, wb in zip(got, want) for g, w in zip(gb, wb))
        if not same:
            raise AssertionError(f"{phase}: {workers} workers on the card gave other batches "
                                 "than the CPU loader")
    failures = {}
    for workers in (0, 2):
        seen = 0
        try:
            for _ in DataLoader(FailingItems(20, 13), batch_size=4, num_workers=workers,
                                device="cuda"):
                seen += 1
        except ValueError as e:
            failures[workers] = (seen, "item 13 is unreadable" in str(e))
        if failures.get(workers) != (3, True):
            raise AssertionError(f"{phase}: the failing item with {workers} workers gave "
                                 f"{failures.get(workers)} after {seen} batches")
    say(phase, batches=len(want), batch_shapes=[list(t.shape) for t in want[0]],
        dtypes=[str(t.dtype) for t in want[0]], bit_equal="cuda workers 0 and "
        f"{FLOWERS_WORKERS} against the CPU", epoch_s=json.dumps(seconds),
        worker_error_reached_the_consumer=True)
    return seconds


def hapi_save_load(fitted: dict, seed: int) -> dict:
    """Phase 21e: ``Model.save`` of 21c's model on the card, then
    ``Model.load`` into a fresh ResNet-50 on the card (other weights):
    equal logits in eval mode, bit for bit, where the fresh model's
    differed before the load."""
    import tempfile

    import torch

    from paddle_tpu_torch import Model, load
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import EvalStep
    from paddle_tpu_torch.vision import resnet50

    phase = "hapi-save-load"
    x, _ = next(iter(DataLoader(fitted["test"], batch_size=FLOWERS_BATCH)))

    def logits(net):
        net.eval()
        return EvalStep(net, lambda a: net(a))(x)[0]

    want = logits(fitted["net"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    fresh = Model(resnet50(num_classes=FLOWERS_CLASSES, device="cuda", generator=gen))
    before = logits(fresh.network)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fitted["model"].save(f"{d}/resnet50")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.load(f"{d}/resnet50")
        load_s = time.perf_counter() - t0
        opt = load(f"{d}/resnet50.pdopt")
        nbytes = Path(f"{d}/resnet50.pdparams").stat().st_size
    got = logits(fresh.network)
    say(phase, pdparams_bytes=nbytes, save_s=round(save_s, 3), load_s=round(load_s, 3),
        pdopt_keys=sorted(opt), equal_logits=bool(torch.equal(got, want)),
        before_load_equal=bool(torch.equal(before, want)))
    if not bool(torch.isfinite(want).all()):
        raise AssertionError(f"{phase}: the saved model's logits are not finite")
    if not torch.equal(got, want) or torch.equal(before, want):
        raise AssertionError(f"{phase}: logits after the load differ from the saved model's")
    return {"save_s": save_s, "load_s": load_s}


def hapi(seed: int, smi: str) -> dict:
    """Phase 21: ``paddle.Model`` on the card: 21a Paddle's quick start,
    21b the same fit on the card against the CPU, 21c ResNet-50 on
    Flowers-102 through ``fit`` with 4 worker processes, 21d the device
    loader's bits, 21e save and load. Returns the fused optimizer's
    launches of 21a, 21b and 21c's fits."""
    import torch

    quick = hapi_quickstart(seed)
    check = hapi_card_vs_cpu(seed)
    fitted = flowers_fit(seed, smi)
    loader_bits(seed)
    hapi_save_load(fitted, seed)
    say("hapi", card=repr(smi), quickstart_acc=quick["acc"],
        quickstart_ms_per_step=round(quick["fit_ms_per_step"], 3),
        lenet_card_vs_cpu_max_rel_diff=check["max_rel_diff"],
        resnet50_flowers_step_ms=round(fitted["step_ms"], 3),
        resnet50_flowers_images_per_s=round(FLOWERS_BATCH / fitted["step_ms"] * 1e3, 1),
        resnet50_trainstep_step_ms=round(fitted["direct_ms"], 3))
    launches = {"quickstart": quick["launches"], "check": check["launches"],
                "flowers": fitted["launches"]}
    del fitted
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 22: a Mixture-of-Experts Llama at Mixtral-8x7B's widths
# ---------------------------------------------------------------------------

# Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1 config.json,
# arXiv 2401.04088): 8 experts, top-2. The router is GShard's top-2 (a
# softmax over every expert, the pair renormalised), Mixtral's router, but
# each expert's buffer is bounded at capacity factor 1.5 (the reference's
# default) where Mixtral drops no token. Depth is cut from 32 to MOE_LAYERS
# (6.07e9 parameters: bf16 parameters, gradients and AdamW moments fit one
# card), batch 1 x MOE_SEQ.
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768,
               rms_norm_eps=1e-5, rope_theta=1e6, tie_word_embeddings=False,
               moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.5)
MOE_LAYERS = 4
MOE_SEQ = 4096
MOE_WARMUP, MOE_STEPS = 2, 6
# 22c: one warm-up and MOE_POLICY_STEPS timed steps under each other policy
MOE_POLICY_STEPS = 3
MOE_POLICIES = ("none", "every_layer", "selective")
# Mixtral's router_aux_loss_coef: the loss is the cross entropy plus this
# times the sum of the layers' load-balance losses
MOE_AUX_COEF = 0.02
# 22b, dense against sort dispatch: each MoE layer of a 2-layer model on
# its own input from one forward, with one seeded gradient of its output.
# Both formulations route from the same f32 logits by the same argmax and
# cumulative sums, so their truncation decisions, combine weights and aux
# losses are held bit for bit, in bf16; two bf16 sort runs too (each
# token's two bf16 addends onto zero commute, whatever order the
# scatter-add takes). Their values differ by rounding: in bf16 the
# combine's (dense sums a token's two products in f32 and rounds once, sort
# rounds each product and adds them) and the router gradient's (dense
# reduces over the hidden axis in f32 inside a GEMM, sort rounds each
# product to bf16 first, and the pair's renormalisation subtracts two such
# sums), so bf16 is printed, not held. The layer cast to f32 (TF32 off)
# differs by summation order alone: its output and the gradients of x, the
# router and the three expert weights are held within MOE_PATH_F32_FRAC of
# each tensor's largest magnitude, the limit phase 14 holds f32 gradients to.
MOE_PATH_F32_FRAC = F32_STEP_GRAD_FRAC
# 22b, the card against the CPU in f32 (TF32 off), 1 layer at small widths
# (head_dim 64): step 1's loss and every gradient within phase 14's
# F32_STEP_LOSS_RTOL and F32_STEP_GRAD_FRAC (flash's f32 route, ~1e-5 of a
# tile's norm, and RMSNorm's summation order are the only differences),
# then MOE_F32_STEPS TrainStep losses within MOE_F32_TRAJ_RTOL: AdamW turns
# a gradient difference near zero into up to a whole step (lr 3e-4) on the
# few elements that have one
MOE_F32_CFG = dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                   moe_num_experts=4)
MOE_F32_SEQ, MOE_F32_STEPS = 256, 3
MOE_F32_TRAJ_RTOL = 1e-4
# 22d, bench.py's moe_bench on the card: MoELayer alone (capacity factor
# 1.25, its default), top-2, bf16, SGD(1e-3) through TrainStep, loss
# mean(out) + aux_loss; T tokens, widths d / dh, E experts, steps a timed pass
MOE_BENCH = dict(T=16384, d=1024, dh=2816, E=8, steps=8)
MOE_BENCH_TENSORS = 4


def mixtral_config(layers: int):
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(num_hidden_layers=layers, **MIXTRAL)


def moe_active_params(cfg) -> int:
    """Parameters a token runs through, the embedding left out: attention,
    the router, top_k of the E experts and the head."""
    h = cfg.hidden_size
    kv = cfg.num_key_value_heads * (h // cfg.num_attention_heads)
    layer = (2 * h * h + 2 * h * kv + h * cfg.moe_num_experts
             + 3 * h * cfg.intermediate_size * cfg.moe_top_k)
    return cfg.num_hidden_layers * layer + h * cfg.vocab_size


def moe_key(mlp, tokens: int, dtype) -> tuple:
    """The dispatch policy's cache key of an MoE layer's call on ``tokens``."""
    from paddle_tpu_torch.dtype import dtype_name

    return (tokens, mlp.num_experts, mlp.capacity(tokens), mlp.d_model, dtype_name(dtype),
            mlp.d_hidden, mlp.top_k)


def moe_policy_line(key: tuple) -> dict:
    """The policy's choice for ``key`` and its probe's times."""
    from paddle_tpu_torch.distributed.fleet import moe as M

    times = M._PROBE_TIMES.get(key, {})
    return {"dispatch": M._DISPATCH_CHOICE.get(key, "not chosen"),
            "probe_dense_ms": round(1e3 * times["dense_s"], 3) if "dense_s" in times else
            "not measured", "probe_sort_ms": round(1e3 * times["sort_s"], 3)
            if "sort_s" in times else "not measured"}


def moe_decisions(mlp, x) -> dict:
    """The dense and the sort formulations' truncation decisions and
    combine weights from one MoE layer's logits on its input ``x``, held
    bit for bit; returns the share of choices dropped."""
    import torch

    from paddle_tpu_torch.distributed.fleet import moe as M

    with torch.no_grad():
        x2 = x.reshape(-1, x.shape[-1])
        logits = mlp.gate(x2)
        T, E, C = x2.shape[0], mlp.num_experts, mlp.capacity(x2.shape[0])
        combine, dispatch, _ = (M.top1_gating if mlp.top_k == 1 else M.top2_gating)(logits, C)
        ids, gates, _ = M.topk_routing(logits, mlp.top_k)
        order, se, stok, cpos, valid = M.sort_slots(ids, E, C)
        kept = torch.zeros_like(dispatch)
        kept[stok[valid], se[valid], cpos[valid]] = True
        if not torch.equal(kept, dispatch):
            raise AssertionError(f"dense and sort dispatch keep different slots: "
                                 f"{int((kept != dispatch).sum())} of {dispatch.numel()}")
        sg = M.sort_gates(gates, order, valid)
        if not torch.equal(combine[stok[valid], se[valid], cpos[valid]], sg[valid]):
            raise AssertionError("dense and sort dispatch combine with different weights")
    return {"dropped_share": round(1.0 - valid.float().mean().item(), 5), "capacity": C}


# the tensors held in 22b: the layer's input and its four parameters
MOE_GRADS = ("x", "gate.gate.weight", "w_up", "w_gate", "w_down")


def moe_paths(mlp, x, g_out) -> dict:
    """One MoE layer on ``x`` with the output's gradient ``g_out`` (and 1
    for its aux loss) through dense dispatch and twice through sort:
    ``{path: (out, aux, [grad of x, router, w_up, w_gate, w_down])}``."""
    import torch

    params = dict(mlp.named_parameters())
    runs = {}
    for name in ("dense", "sort", "sort_again"):
        mlp.dispatch = name.removesuffix("_again")
        xi = x.clone().requires_grad_(True)
        out = mlp(xi)
        torch.autograd.backward([out, mlp.aux_loss], [g_out, torch.ones_like(mlp.aux_loss)])
        runs[name] = (out.detach(), mlp.aux_loss.detach(),
                      [xi.grad] + [params[n].grad for n in MOE_GRADS[1:]])
        mlp.zero_grad(set_to_none=True)
    mlp.dispatch = None
    torch.cuda.synchronize()
    return runs


def path_fracs(runs) -> dict:
    """Sort against dense: each tensor's largest difference over its
    largest magnitude."""
    (out_d, _, grads_d), (out_s, _, grads_s) = runs["dense"], runs["sort"]
    return {n: ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()
            for n, got, want in zip(("out",) + MOE_GRADS, [out_s] + grads_s, [out_d] + grads_d)}


def moe_dispatch_check(seed: int, cfg=None, seq: int = CHECK_SEQ,
                       phase: str = "moe-dispatch-check") -> dict:
    """Phase 22b: a model at Mixtral's widths (CHECK_LAYERS layers by
    default) runs one forward on seeded tokens; each MoE layer then runs on
    its own input through :func:`moe_paths`, in bf16 and cast to f32:
    decisions and combine weights from one set of logits
    (:func:`moe_decisions`), the aux losses and the two sort runs bit for
    bit in bf16, the f32 outputs and gradients within MOE_PATH_F32_FRAC."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    precision = f32_matmuls()
    cfg = cfg or mixtral_config(CHECK_LAYERS)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    ids, _ = token_batch(np.random.RandomState(seed + 2), seq, cfg.vocab_size)
    mlps = [lyr.mlp for lyr in model.llama.layers]
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, inp, i=i: inputs.__setitem__(i, inp[0]))
             for i, m in enumerate(mlps)]
    for m in mlps:
        m.dispatch = "dense"
    try:
        with torch.no_grad():
            model(ids)
    finally:
        for h in hooks:
            h.remove()
        for m in mlps:
            m.dispatch = None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)
    worst = {"bf16": (0.0, ""), "f32": (0.0, "")}
    decisions = []
    for i, mlp in enumerate(mlps):
        x = inputs[i]
        decisions.append(moe_decisions(mlp, x))
        g_out = torch.randn(x.shape, generator=gen, device="cuda")
        runs = moe_paths(mlp, x, g_out.to(x.dtype))
        (_, aux_d, _), (out_s, aux_s, grads_s) = runs["dense"], runs["sort"]
        out_a, _, grads_a = runs["sort_again"]
        if not torch.equal(aux_d, aux_s):
            raise AssertionError(f"layer {i}: aux losses differ: dense {aux_d}, sort {aux_s}")
        if not (torch.equal(out_a, out_s) and all(map(torch.equal, grads_a, grads_s))):
            raise AssertionError(f"layer {i}: two sort-dispatch runs differ")
        worst["bf16"] = max([worst["bf16"]] + [(f, f"layer {i} {n}")
                                               for n, f in path_fracs(runs).items()])
        del runs
        mlp.aux_loss = None
        m32 = copy.deepcopy(mlp).float()
        for n, f in path_fracs(moe_paths(m32, x.float(), g_out)).items():
            worst["f32"] = max(worst["f32"], (f, f"layer {i} {n}"))
            if not (math.isfinite(f) and f <= MOE_PATH_F32_FRAC):
                raise AssertionError(f"layer {i} {n} in f32: sort and dense differ by {f} of "
                                     f"its largest magnitude (tol {MOE_PATH_F32_FRAC})")
        del m32
    out = {"layers": cfg.num_hidden_layers, "seq": seq, "f32_matmul_precision": precision,
           "decisions_bit_for_bit": True, "aux_bit_for_bit": True,
           "sort_twice_bit_for_bit": True,
           "dropped_share": [d["dropped_share"] for d in decisions],
           "capacity": decisions[0]["capacity"], "f32_worst_frac": worst["f32"][0],
           "f32_worst": worst["f32"][1], "f32_tol": MOE_PATH_F32_FRAC,
           "bf16_worst_frac": worst["bf16"][0], "bf16_worst": worst["bf16"][1]}
    say(phase, **out)
    del model, inputs
    torch.cuda.empty_cache()
    return out


def moe_card_vs_cpu(seed: int, phase: str = "moe-card-vs-cpu") -> dict:
    """Phase 22b: a 1-layer MoE Llama at MOE_F32_CFG's widths in f32 (TF32
    off) on the card and on the CPU from one state: step 1's loss and every
    gradient, then MOE_F32_STEPS TrainStep losses, within the limits above;
    the card's launches exact (flash on its f32 route, RMSNorm, the
    optimizer once a step)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    precision = f32_matmuls()
    cfg = LlamaConfig.tiny(**MOE_F32_CFG)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    card = LlamaForCausalLM(cfg, device="cuda", seed=seed + 1)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(seed + 2)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, MOE_F32_SEQ + 1)))
            for _ in range(MOE_F32_STEPS)]
    counters = training_counters()
    per_call = expected_launches(cfg.num_hidden_layers, f32=True, moe=True)
    runs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        batches = [(t[:, :-1].to(dev), t[:, 1:].to(dev)) for t in toks]
        step = make_train_step(model, MOE_AUX_COEF)
        zero_counts(counters)
        loss1, grads = step._loss_and_grads(step._params(), batches[0])
        losses = [step(*b).item() for b in batches]
        counts = read_counts(counters)
        calls = MOE_F32_STEPS + 1
        want = ({k: v * (MOE_F32_STEPS if k.startswith("multi_tensor") else calls)
                 for k, v in per_call.items()} if dev == "cuda"
                else dict.fromkeys(counters, 0))
        if counts != want:
            raise AssertionError(f"{phase} on the {name} launched {counts}, expected {want}")
        runs[name] = (loss1.item(), {n: g.cpu() for (n, _), g in zip(step._params(), grads)},
                      losses)
    (loss_c, grads_c, traj_c), (loss_g, grads_g, traj_g) = runs["cpu"], runs["card"]
    worst = max((((grads_g[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in grads_c.items())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(traj_g, traj_c))
    if not (loss_rel <= F32_STEP_LOSS_RTOL and worst[0] <= F32_STEP_GRAD_FRAC
            and traj_rel <= MOE_F32_TRAJ_RTOL):
        raise AssertionError(f"{phase}: loss {loss_rel} (tol {F32_STEP_LOSS_RTOL}), gradient "
                             f"{worst} (tol {F32_STEP_GRAD_FRAC}), trajectory {traj_rel} "
                             f"(tol {MOE_F32_TRAJ_RTOL})")
    out = {"f32_matmul_precision": precision, "loss_rel_diff": loss_rel,
           "loss_tol": F32_STEP_LOSS_RTOL, "worst_grad_frac": worst[0], "worst_grad": worst[1],
           "grad_tol": F32_STEP_GRAD_FRAC, "trajectory_card": traj_g, "trajectory_cpu": traj_c,
           "trajectory_rel_diff": traj_rel, "trajectory_tol": MOE_F32_TRAJ_RTOL}
    say(phase, **out)
    return out


# the device ms of an MoE step by kind: the hand-written kernels by name,
# the others by the aten operation that launched them
MOE_KINDS = (("flash attention (port)", ("flash_", "split_kernel")),
             ("rms norm (port)", ("rms_fwd_kernel", "rms_bwd_dx_kernel")),
             ("fused optimizer (port)", ("multi_tensor_update_kernel",)))
MOE_SCATTER_OPS = ("aten::index", "aten::index_put_", "aten::_index_put_impl_",
                   "aten::index_add", "aten::index_add_", "aten::index_select", "aten::gather")
MOE_ROUTING_OPS = ("aten::sort", "aten::bincount", "aten::cumsum", "aten::argmax",
                   "aten::_softmax", "aten::_softmax_backward_data")
MOE_CLIP_OPS = ("aten::linalg_vector_norm", "aten::norm")


def moe_kind(op: str, shapes, kernel: str, E: int, C: int) -> str:
    low = kernel.lower()
    for kind, subs in MOE_KINDS:
        if any(sub in low for sub in subs):
            return kind
    shapes = [s for s in shapes or () if isinstance(s, (list, tuple)) and s]
    dims = {d for s in shapes for d in s}
    if op in ("aten::bmm", "aten::baddbmm"):
        return "expert GEMMs (cuBLAS)"
    if op in ("aten::mm", "aten::addmm"):
        return ("dispatch and combine products (cuBLAS)" if E * C in dims
                else "projection and head GEMMs (cuBLAS)")
    if "log_softmax" in op or "nll_loss" in op or "cross_entropy" in op:
        return "cross entropy"
    if op in MOE_CLIP_OPS:
        return "global-norm clip (norms)"
    if op in MOE_SCATTER_OPS:
        return "dispatch and combine scatters (sort)"
    if op in MOE_ROUTING_OPS or any(s[-1] in (E, C) for s in shapes) or E * C in dims:
        return "routing elementwise"
    return "other"


def moe_device_ms(prof, E: int, C: int) -> tuple[dict, dict]:
    """Device ms by kind (:func:`moe_kind`) of a profiled MoE step
    (``record_shapes=True``): each kernel under the operation whose
    correlation launched it; kernels no operation launched (the hand
    kernels' ctypes launches) by their names. Also the device ms of the
    kind "other" by operation, the largest first."""
    import torch

    out: dict = {}
    attached: dict = {}
    other: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in ev.kernels:
            attached[k.name] = attached.get(k.name, 0.0) + k.duration
            kind = moe_kind(ev.name, ev.input_shapes, k.name, E, C)
            out[kind] = out.get(kind, 0.0) + k.duration
            if kind == "other":
                other[ev.name] = other.get(ev.name, 0.0) + k.duration
    per_kernel, _ = kernel_times(prof)
    for name, us in per_kernel.items():
        rest = us - attached.get(name, 0.0)
        if rest > 0.0:
            kind = moe_kind("", (), name, E, C)
            out[kind] = out.get(kind, 0.0) + rest

    def ms(d):
        return {k: round(v / 1e3, 3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    return ms(out), dict(list(ms(other).items())[:8])


def moe_recompute_grads(model, batch) -> dict:
    """Phase 22c's first part: step 1's loss and gradients under each
    policy of MOE_POLICIES from one state and batch, each call's launches
    exact (a recomputed layer runs flash's forward and its two RMSNorm
    forwards twice), the memory its forward keeps for the backward, and
    its peak above what was held before it (the gradients and what is
    kept at once); each policy's against "none":
    bit for bit, or the largest difference, held to phase 6's limits."""
    import torch

    counters = training_counters()
    base, out = None, {}
    for policy in MOE_POLICIES:
        step = make_train_step(model, MOE_AUX_COEF, policy)
        forward = step.loss_fn
        kept = {}

        def loss_fn(*b, forward=forward, kept=kept):
            loss = forward(*b)
            torch.cuda.synchronize()
            kept["gib"] = (torch.cuda.memory_allocated() - held) / 2**30
            return loss

        step.loss_fn = loss_fn
        zero_counts(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        loss, grads = step._loss_and_grads(step._params(), batch)
        torch.cuda.synchronize()
        above = (torch.cuda.max_memory_allocated() - held) / 2**30
        mem = {"kept_for_backward_gib": round(kept["gib"], 3),
               "peak_above_weights_gib": round(above, 3)}
        want = expected_launches(len(model.llama.layers), moe=True, recompute=policy != "none")
        want.update({k: 0 for k in want if k.startswith("multi_tensor_update")})
        if read_counts(counters) != want:
            raise AssertionError(f"policy {policy} launched {read_counts(counters)}, "
                                 f"expected {want}")
        if base is None:
            base = (loss.item(), grads)
            out[policy] = mem
            continue
        worst = (0.0, 0.0, "")
        for (n, _), g, g0 in zip(step._params(), grads, base[1]):
            d = (g.float() - g0.float()).abs().max().item()
            worst = max(worst, (d / g0.float().abs().max().clamp_min(1e-30).item(), d, n))
        bits = loss.item() == base[0] and all(torch.equal(g, g0) for g, g0 in
                                              zip(grads, base[1]))
        loss_rel = abs(loss.item() - base[0]) / abs(base[0])
        if not (loss_rel <= STEP_LOSS_RTOL and worst[0] <= STEP_GRAD_FRAC):
            raise AssertionError(f"policy {policy}: loss {loss_rel} from none's, gradient "
                                 f"{worst}")
        out[policy] = {**mem, "bit_for_bit": bits, "loss_rel_diff": loss_rel,
                       "max_abs_grad_diff": worst[1], "worst_grad_frac": worst[0],
                       "worst_grad": worst[2]}
        del grads
    del base
    return out


def moe_train(seed: int, smi: str) -> dict:
    """Phases 22a and 22c: the Mixtral cell (MOE_LAYERS layers, batch 1 x
    MOE_SEQ, bf16, AdamW with phase 7's clip in TrainStep): step 1's
    gradients under each policy (:func:`moe_recompute_grads`), then
    MOE_WARMUP warm-up and MOE_STEPS timed steps with no recompute (step ms,
    tokens/s, the active-parameter FLOPs share of the bf16 peak, peak
    memory, exact launches, one profiled step's busy share and device ms by
    kind, the dispatch the policy chose with its probe's times), then one
    warm-up and MOE_POLICY_STEPS timed steps under each other policy."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = mixtral_config(MOE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    active = moe_active_params(cfg)
    mlp = model.llama.layers[0].mlp
    say("moe-train", card=repr(smi), layers=MOE_LAYERS, hidden=cfg.hidden_size,
        ffn=cfg.intermediate_size, experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor, capacity=mlp.capacity(MOE_SEQ), seq=MOE_SEQ,
        params=model.num_params(), active_params=active,
        model_init_s=round(time.perf_counter() - t0, 2))
    rng = np.random.RandomState(seed + 3)
    bits = moe_recompute_grads(model, token_batch(rng, MOE_SEQ, cfg.vocab_size))
    policy = moe_policy_line(moe_key(mlp, MOE_SEQ, torch.bfloat16))
    say("moe-dispatch", **policy)
    for name, b in bits.items():
        say("moe-recompute-grads", policy=name, **b)
    counters = training_counters()
    attn_flops = MOE_LAYERS * 3.5 * flash_counts(True, 1, MOE_SEQ, cfg.num_attention_heads,
                                                 cfg.num_key_value_heads, 128)[2]
    model_flops = 6 * active * MOE_SEQ + attn_flops
    runs = {}
    for name in MOE_POLICIES:
        step = make_train_step(model, MOE_AUX_COEF, name)
        warm, timed = (MOE_WARMUP, MOE_STEPS) if name == "none" else (1, MOE_POLICY_STEPS)
        for _ in range(warm):
            step(*token_batch(rng, MOE_SEQ, cfg.vocab_size))
        per_step = expected_launches(MOE_LAYERS, moe=True, recompute=name != "none")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        losses, times = [], []
        for _ in range(timed):
            batch = token_batch(rng, MOE_SEQ, cfg.vocab_size)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(loss.item())
        counts = read_counts(counters)
        want = {k: timed * v for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"moe-train ({name}) launched {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"moe-train ({name}) losses are not finite: {losses}")
        step_s = sum(times) / len(times)
        runs[name] = {"step_ms": 1e3 * step_s, "launches": counts,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        say("moe-train", policy=name, step_ms=[round(1e3 * t, 3) for t in times],
            step_ms_mean=round(1e3 * step_s, 3), losses=losses,
            tokens_per_s=round(MOE_SEQ / step_s, 1),
            model_tflop_per_step=round(model_flops / 1e12, 3),
            bf16_peak_share=round(model_flops / step_s / BF16_FLOP_PER_S, 4),
            max_memory_allocated_gib=round(runs[name]["peak_gib"], 3), launches=counts)
        batch = token_batch(rng, MOE_SEQ, cfg.vocab_size)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            s0 = time.perf_counter()
            step(*batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - s0
        per_kernel, ops = kernel_times(prof)
        busy = sum(per_kernel.values()) / 1e6
        kinds, other = moe_device_ms(prof, cfg.moe_num_experts, mlp.capacity(MOE_SEQ))
        runs[name].update(device_busy_share=busy / wall if busy else None,
                          device_ms_by_kind=kinds)
        say("moe-train", policy=name, profiled_step_ms=round(1e3 * wall, 3),
            device_busy_ms=round(1e3 * busy, 3),
            device_busy_share=round(busy / wall, 4) if busy else "not measured",
            device_ops=ops)
        say("moe-train", policy=name, device_ms_by_kind=json.dumps(kinds),
            other_ms_by_op=json.dumps(other))
        if name == "none":
            for kname, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]:
                print(f"  moe-train top kernel: {us / 1e3:.4f} ms/step {kname[:90]}", flush=True)
        del step
        torch.cuda.empty_cache()
    none = runs["none"]
    for name in MOE_POLICIES[1:]:
        say("moe-recompute", policy=name, step_ms=round(runs[name]["step_ms"], 3),
            step_ms_ratio_to_none=round(runs[name]["step_ms"] / none["step_ms"], 4),
            peak_gib=round(runs[name]["peak_gib"], 3), none_peak_gib=round(none["peak_gib"], 3),
            kept_for_backward_gib=bits[name]["kept_for_backward_gib"],
            none_kept_for_backward_gib=bits["none"]["kept_for_backward_gib"],
            peak_above_weights_gib=bits[name]["peak_above_weights_gib"],
            none_peak_above_weights_gib=bits["none"]["peak_above_weights_gib"],
            busy_share=round(runs[name]["device_busy_share"] or 0.0, 4),
            none_busy_share=round(none["device_busy_share"] or 0.0, 4))
    del model
    torch.cuda.empty_cache()
    return {"runs": runs, "policy": policy, "recompute_grads": bits,
            "bf16_peak_share": model_flops / (none["step_ms"] / 1e3) / BF16_FLOP_PER_S}


def moe_bench(seed: int) -> dict:
    """Phase 22d, ``bench.py``'s MoE step on the card: ``MoELayer`` alone at
    MOE_BENCH's shape under the measured policy, sort and dense, each
    warmed by 2 steps, then timed round-robin, best of 2 passes of
    ``steps`` steps (a pass ends with a host read of the loss): tokens/s
    under the policy, dense time over sort time, and the policy's
    efficiency ``min(sort, dense) / auto``; the fused optimizer's SGD once
    a step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    T, d, dh, E, steps = (MOE_BENCH[k] for k in ("T", "d", "dh", "E", "steps"))
    x = torch.from_numpy(np.random.RandomState(0).randn(T, d).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    counters = training_counters()
    zero_counts(counters)
    layers = {}

    def run(dispatch):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        moe = MoELayer(d, dh, E, top_k=2, dispatch=dispatch, device="cuda",
                       dtype=torch.bfloat16, generator=gen)
        layers[dispatch] = moe
        step = TrainStep(moe, SGD(1e-3, parameters=moe.parameters()),
                         lambda a: moe(a).float().mean() + moe.aux_loss)
        for _ in range(2):
            loss = step(x)
        loss.item()

        def timed_pass():
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = step(x)
            loss.item()
            return (time.perf_counter() - t0) / steps

        return timed_pass

    modes = (None, "sort", "dense")
    passes = {m: run(m) for m in modes}
    times = dict.fromkeys(modes, float("inf"))
    for _ in range(2):
        for m in modes:
            times[m] = min(times[m], passes[m]())
    want = optimizer_launches(len(modes) * (2 + 2 * steps), tensors=MOE_BENCH_TENSORS)
    counts = read_counts(counters)
    if counts != want:
        raise AssertionError(f"moe-bench launched {counts}, expected {want}")
    t_auto, t_sort, t_dense = times[None], times["sort"], times["dense"]
    policy = moe_policy_line(moe_key(layers[None], T, torch.bfloat16))
    out = {"tokens": T, "d": d, "dh": dh, "experts": E, "capacity": layers[None].capacity(T),
           **policy, "auto_ms": round(1e3 * t_auto, 3), "sort_ms": round(1e3 * t_sort, 3),
           "dense_ms": round(1e3 * t_dense, 3), "tokens_per_s": round(T / t_auto, 1),
           "dense_over_sort": round(t_dense / t_sort, 4),
           "policy_efficiency": round(min(t_sort, t_dense) / t_auto, 4),
           "launches": counts["multi_tensor_update"]}
    say("moe-bench", **out)
    del layers, passes
    torch.cuda.empty_cache()
    return out


def moe(seed: int, smi: str) -> dict:
    """Phase 22: 22b the checks (dense against sort, kernels against plain,
    the card against the CPU), 22a and 22c the Mixtral cell with and
    without recompute, 22d bench.py's MoE step. Returns the launches of
    22a's timed steps, 22d's optimizer launches and 22a's step ms."""
    moe_dispatch_check(seed)
    check_train_step(seed, moe=True)
    moe_card_vs_cpu(seed)
    trained = moe_train(seed, smi)
    bench = moe_bench(seed)
    none = trained["runs"]["none"]
    say("moe", card=repr(smi), step_ms=round(none["step_ms"], 3),
        tokens_per_s=round(MOE_SEQ / none["step_ms"] * 1e3, 1),
        bf16_peak_share=round(trained["bf16_peak_share"], 4),
        peak_gib=round(none["peak_gib"], 3), dispatch=trained["policy"]["dispatch"],
        bench_tokens_per_s=bench["tokens_per_s"],
        bench_policy_efficiency=bench["policy_efficiency"])
    return {"train": none["launches"], "bench": bench["launches"], "step_ms": none["step_ms"]}


# ---------------------------------------------------------------------------
# phase 23: the op surface and nn.Layer
# ---------------------------------------------------------------------------

OPS_INIT_STD = 0.02
# step 1 of OpsLlama against LlamaForCausalLM, bf16: the same kernels in the
# same order give the same bits; the limits allow an op of another rounding
OPS_LOSS_RTOL = 1e-3
OPS_GRAD_FRAC = 2e-2          # a gradient's largest difference / its largest entry
OPS_DISPATCH_CALLS = 2000
_OPS_LLAMA: dict = {}


def ops_llama_class():
    """``OpsLlama``: Llama written the way a Paddle user writes it, as a
    user script and not a package feature: ``nn.Layer`` subclasses, every
    weight from ``create_parameter`` with ``ParamAttr(name=...,
    initializer=nn.initializer.Normal(0.0, 0.02))``, and a forward of public
    functions only (``matmul``, ``reshape``, ``split``, ``concat``,
    ``multiply``, ``add``, ``subtract``, ``cast``, ``nn.functional``'s
    ``embedding``, ``rms_norm``, ``scaled_dot_product_attention`` with
    ``is_causal=True`` and the op's own GQA broadcast, ``silu`` and
    ``cross_entropy``), with neox-half RoPE from ``split`` / ``concat``.
    Its parameter names are ``LlamaForCausalLM``'s, so ``set_state_dict``
    carries weights between the two. Built on the default device
    (``paddle_tpu_torch.set_device``)."""
    if _OPS_LLAMA:
        return _OPS_LLAMA["cls"]
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    F = nn.functional

    def attr(name):
        return paddle.ParamAttr(name=name,
                                initializer=nn.initializer.Normal(0.0, OPS_INIT_STD))

    class Weight(nn.Layer):
        def __init__(self, shape, name, dtype):
            super().__init__(dtype=dtype)
            self.weight = self.create_parameter(shape, attr=attr(name + ".weight"))

    class Proj(Weight):
        def forward(self, x):
            return paddle.matmul(x, self.weight)

    class Norm(Weight):
        def __init__(self, hidden, eps, name, dtype):
            super().__init__([hidden], name, dtype)
            self.eps = eps

        def forward(self, x):
            return F.rms_norm(x, self.weight, self.eps)

    class Embed(Weight):
        def forward(self, ids):
            return F.embedding(ids, self.weight)

    def rope_tables(seq, dim, theta, dtype):
        exps = paddle.divide(paddle.arange(0, dim, 2, dtype="float32"), float(dim))
        inv = paddle.reciprocal(paddle.pow(theta, exps))
        freqs = paddle.outer(paddle.arange(seq, dtype="float32"), inv)
        return tuple(paddle.cast(paddle.reshape(t, [1, seq, 1, dim // 2]), dtype)
                     for t in (paddle.sin(freqs), paddle.cos(freqs)))

    def rope(x, sin, cos):
        x1, x2 = paddle.split(x, 2, axis=-1)
        return paddle.concat([paddle.subtract(paddle.multiply(x1, cos), paddle.multiply(x2, sin)),
                              paddle.add(paddle.multiply(x2, cos), paddle.multiply(x1, sin))],
                             axis=-1)

    class Attention(nn.Layer):
        def __init__(self, cfg, name, dtype):
            super().__init__(dtype=dtype)
            h = cfg.hidden_size
            self.heads, self.kv_heads = cfg.num_attention_heads, cfg.num_key_value_heads
            self.head_dim, self.theta = h // self.heads, cfg.rope_theta
            kv = self.kv_heads * self.head_dim
            for proj, n_out in (("q_proj", h), ("k_proj", kv), ("v_proj", kv), ("o_proj", h)):
                setattr(self, proj, Proj([h, n_out], f"{name}.{proj}", dtype))

        def forward(self, x):
            b, s, h = x.shape
            q = paddle.reshape(self.q_proj(x), [b, s, self.heads, self.head_dim])
            k = paddle.reshape(self.k_proj(x), [b, s, self.kv_heads, self.head_dim])
            v = paddle.reshape(self.v_proj(x), [b, s, self.kv_heads, self.head_dim])
            sin, cos = rope_tables(s, self.head_dim, self.theta, q.dtype)
            out = F.scaled_dot_product_attention(rope(q, sin, cos), rope(k, sin, cos), v,
                                                 is_causal=True)
            return self.o_proj(paddle.reshape(out, [b, s, h]))

    class MLP(nn.Layer):
        def __init__(self, cfg, name, dtype):
            super().__init__(dtype=dtype)
            h, f = cfg.hidden_size, cfg.intermediate_size
            self.gate_proj = Proj([h, f], f"{name}.gate_proj", dtype)
            self.up_proj = Proj([h, f], f"{name}.up_proj", dtype)
            self.down_proj = Proj([f, h], f"{name}.down_proj", dtype)

        def forward(self, x):
            return self.down_proj(paddle.multiply(F.silu(self.gate_proj(x)), self.up_proj(x)))

    class Decoder(nn.Layer):
        def __init__(self, cfg, name, dtype):
            super().__init__(dtype=dtype)
            self.self_attn = Attention(cfg, f"{name}.self_attn", dtype)
            self.mlp = MLP(cfg, f"{name}.mlp", dtype)
            self.input_layernorm = Norm(cfg.hidden_size, cfg.rms_norm_eps,
                                        f"{name}.input_layernorm", dtype)
            self.post_attention_layernorm = Norm(cfg.hidden_size, cfg.rms_norm_eps,
                                                 f"{name}.post_attention_layernorm", dtype)

        def forward(self, x):
            x = paddle.add(x, self.self_attn(self.input_layernorm(x)))
            return paddle.add(x, self.mlp(self.post_attention_layernorm(x)))

    class Body(nn.Layer):
        def __init__(self, cfg, dtype):
            super().__init__(dtype=dtype)
            self.embed_tokens = Embed([cfg.vocab_size, cfg.hidden_size], "llama.embed_tokens",
                                      dtype)
            self.layers = nn.LayerList([Decoder(cfg, f"llama.layers.{i}", dtype)
                                        for i in range(cfg.num_hidden_layers)])
            self.norm = Norm(cfg.hidden_size, cfg.rms_norm_eps, "llama.norm", dtype)

        def forward(self, ids):
            x = self.embed_tokens(ids)
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)

    class OpsLlama(nn.Layer):
        def __init__(self, cfg, dtype="float32"):
            super().__init__(dtype=dtype)
            self.vocab = cfg.vocab_size
            self.llama = Body(cfg, dtype)
            self.lm_head = Proj([cfg.hidden_size, cfg.vocab_size], "lm_head", dtype)

        def forward(self, input_ids, labels=None):
            logits = self.lm_head(self.llama(input_ids))
            if labels is None:
                return logits
            loss = F.cross_entropy(paddle.reshape(logits, [-1, self.vocab]),
                                   paddle.reshape(labels, [-1]))
            return loss, logits

    _OPS_LLAMA["cls"] = OpsLlama
    return OpsLlama


def grad_fracs(got: dict, want: dict) -> dict:
    """Each gradient's largest difference over its largest entry."""
    out = {}
    for name, w in want.items():
        g = got[name]
        out[name] = float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(
            1e-30))
    return out


def ops_llama_train(seed: int, train_step_ms: float) -> dict:
    """Phase 23a: OpsLlama at phase 7's cell (Llama-3-8B widths, 4 layers,
    bf16, batch 1 x 8192) with LlamaForCausalLM's weights carried by
    ``set_state_dict``; step 1's loss and every gradient against that
    model's eager forward and backward; then Paddle's eager loop (``loss.
    backward(); opt.step(); opt.clear_grad()``) with phase 7's AdamW and
    clip, 3 timed steps after step 1 on one batch: finite, falling losses,
    exact launches, step ms, tokens/s, peak memory, one profiled step's
    busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    phase = "ops-llama"
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paddle.seed(seed)
    model = ops_llama_class()(cfg, dtype="bfloat16")
    ref = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    missing, unexpected = model.set_state_dict(ref.state_dict())
    if missing or unexpected or len(model.state_dict()) != len(ref.state_dict()):
        raise AssertionError(f"{phase}: set_state_dict missing {missing}, unexpected "
                             f"{unexpected}")
    torch.cuda.synchronize()
    say(phase, layers=TRAIN_LAYERS, hidden=cfg.hidden_size, vocab=cfg.vocab_size, seq=TRAIN_SEQ,
        tensors=len(model.parameters()), params=sum(p.numel() for p in model.parameters()),
        is_layer=isinstance(model, paddle.nn.Layer), model_init_s=round(time.perf_counter() - t0,
                                                                        2))
    ids, labels = token_batch(np.random.RandomState(seed + 23), TRAIN_SEQ, cfg.vocab_size)
    loss_ref = ref(ids, labels=labels)[0]
    loss_ref.backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref
    counters = training_counters()
    per_step = expected_launches(TRAIN_LAYERS, traced=False)
    per_step.update(multi_tensor_update=1, multi_tensor_update_direct=1)
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))

    def step():
        loss = model(ids, labels=labels)[0]
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    zero_counts(counters)
    loss = model(ids, labels=labels)[0]
    loss.backward()
    fracs = grad_fracs({n: p.grad for n, p in model.named_parameters()}, ref_grads)
    worst = max(fracs, key=fracs.get)
    loss_err = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    say(phase, step1_loss=loss.item(), step1_ref_loss=loss_ref.item(), loss_rel_err=loss_err,
        loss_rtol=OPS_LOSS_RTOL, grads=len(fracs), worst_grad=worst,
        worst_grad_frac=fracs[worst], grad_frac_limit=OPS_GRAD_FRAC,
        bit_identical=sum(v == 0.0 for v in fracs.values()))
    if loss_err > OPS_LOSS_RTOL or fracs[worst] > OPS_GRAD_FRAC or len(fracs) != len(ref_grads):
        raise AssertionError(f"{phase}: step 1 against LlamaForCausalLM: loss {loss_err}, "
                             f"{worst} {fracs[worst]}")
    del ref_grads, loss_ref
    opt.step()
    opt.clear_grad()
    counts = read_counts(counters)
    if counts != per_step:
        raise AssertionError(f"{phase} step 1 launched {counts}, expected {per_step}")
    losses, times = [loss.item()], []
    zero_counts(counters)
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
        losses.append(loss.item())
    counts = read_counts(counters)
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{phase} launched {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{phase}: losses not finite and falling: {losses}")
    step_s = sum(times) / len(times)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
    per_kernel, ops = kernel_times(prof)
    busy = sum(per_kernel.values()) / 1e6
    say(phase, losses=losses, step_ms=[round(1e3 * t, 3) for t in times],
        step_ms_mean=round(1e3 * step_s, 3), tokens_per_s=round(TRAIN_SEQ / step_s, 1),
        train_step_ms=round(train_step_ms, 3),
        step_ms_ratio_to_train=round(1e3 * step_s / train_step_ms, 4),
        max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
        device_busy_share=round(busy / wall, 4) if busy else "not measured",
        device_ops=ops, launches=json.dumps(counts))
    say(phase, device_ms_by_kind=json.dumps(by_kind(per_kernel)))
    del model, opt
    torch.cuda.empty_cache()
    return counts


def ops_surface(seed: int) -> dict:
    """Phase 23b: every case of ``paddle_tpu_torch.tools.op_cases`` (every
    op of the registry at small shapes) through the port on the card and on
    the CPU, within each dtype class's tolerance (integer and boolean
    results exactly; a drawing op by shape, dtype, its check of values and
    replay from one generator state on the card); then the host
    microseconds a call of the registry's ``add`` beside ``torch.add`` on
    the card."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import op_cases

    phase = "ops-surface"
    t0 = time.perf_counter()
    res = op_cases.card_vs_cpu(seed)
    say(phase, cases_run=res["run"], cases_held=res["held"], ops=res["ops"],
        tolerance=json.dumps(op_cases.TOLERANCE),
        worst_error_in_tolerances=json.dumps({k: round(v, 4) for k, v in res["worst"].items()}),
        worst_cases=json.dumps(res["worst_case"]),
        seconds=round(time.perf_counter() - t0, 2))
    if res["failures"]:
        for line in res["failures"]:
            print(f"  {phase} FAILED {line}", flush=True)
        raise AssertionError(f"{phase}: {len(res['failures'])} cases failed on the card")
    x = torch.randn(1024, device="cuda")
    y = torch.randn(1024, device="cuda")
    per_call = {}
    for label, fn in (("registry_add", paddle.add), ("torch_add", torch.add),
                      ("registry_add", paddle.add), ("torch_add", torch.add)):
        for _ in range(100):
            fn(x, y)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(OPS_DISPATCH_CALLS):
            fn(x, y)
        torch.cuda.synchronize()
        per_call[label] = 1e6 * (time.perf_counter() - s0) / OPS_DISPATCH_CALLS
    say(phase, add_host_us=round(per_call["registry_add"], 3),
        torch_add_host_us=round(per_call["torch_add"], 3),
        dispatch_overhead_us=round(per_call["registry_add"] - per_call["torch_add"], 3),
        calls=OPS_DISPATCH_CALLS, shape="[1024] f32")
    return {"dispatch_us": per_call["registry_add"] - per_call["torch_add"], **res}


def ops_seeds() -> None:
    """Phase 23c: ``seed(0)`` twice gives bit-identical ``create_parameter``
    draws, layers' default draws and dropout masks on the card; ``get_cuda_rng_state`` /
    ``set_cuda_rng_state`` replay; a ``PyLayer``'s gradient equals the
    plain composition's."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    def draws():
        paddle.seed(0)
        w = paddle.create_parameter([512, 512], attr=paddle.ParamAttr(
            initializer=nn.initializer.Normal(0.0, 0.02)))
        mask = nn.functional.dropout(paddle.ones([4096]), 0.5)
        defaults = [t.detach() for m in (nn.Linear(512, 256), nn.Conv2D(16, 32, 3))
                    for t in m.state_dict().values()]
        return w.detach(), mask, defaults

    (w1, m1, d1), (w2, m2, d2) = draws(), draws()
    state = paddle.get_cuda_rng_state()
    a = paddle.randn([4096])
    paddle.set_cuda_rng_state(state)
    b = paddle.randn([4096])

    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return 3.0 * x * x * dy

    x = paddle.to_tensor(torch.randn(1000), stop_gradient=False)
    (g_layer,) = paddle.grad(paddle.sum(Cube.apply(x)), x)
    (g_plain,) = paddle.grad(paddle.sum(x * x * x), x)
    held = dict(params_bit_identical=bool(torch.equal(w1, w2)),
                masks_bit_identical=bool(torch.equal(m1, m2)),
                layer_defaults_bit_identical=all(map(torch.equal, d1, d2)),
                mask_keep=round(float(m1.mean()) / 2, 4),
                rng_state_replays=bool(torch.equal(a, b)),
                pylayer_grad_max_err=float((g_layer - g_plain).abs().max()),
                device=str(w1.device))
    say("ops-seeds", **held)
    if not (held["params_bit_identical"] and held["masks_bit_identical"]
            and held["layer_defaults_bit_identical"] and held["rng_state_replays"]
            and held["pylayer_grad_max_err"] <= 1e-5 and w1.is_cuda):
        raise AssertionError(f"ops-seeds: {held}")


def ops_phase(seed: int, train_step_ms: float) -> dict:
    """Phase 23 (23a, b, c): returns 23a's launches."""
    launches = ops_llama_train(seed, train_step_ms)
    ops_surface(seed)
    ops_seeds()
    return launches


# ---------------------------------------------------------------------------
# phase 24: multi-process training through the launcher
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 400
DIST_COMM_BUFFER_MB = 25


def run_ranks(phase: str, nproc: int, seed: int, env: dict | None = None,
              steps: int = TRAIN_STEPS) -> list:
    """Launch ``nproc`` ranks of ``tools/dist_train.py --phase <phase>``
    through the port's launcher (``steps`` timed steps); print their
    ``[dist-...]`` lines and return each rank's results. A non-zero exit,
    or the time limit (every rank is then stopped), raises."""
    import os
    import shutil
    import signal
    import tempfile

    out = tempfile.mkdtemp(prefix=f"dist_{phase}_")
    log = os.path.join(out, "log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
           str(nproc), "--log_dir", log, "paddle_tpu_torch/tools/dist_train.py", "--phase",
           phase, "--out", out, "--seed", str(seed), "--comm-buffer-size",
           str(DIST_COMM_BUFFER_MB), "--layers", str(TRAIN_LAYERS), "--seq", str(TRAIN_SEQ),
           "--steps", str(steps), "--check-layers", str(CHECK_LAYERS), "--check-seq",
           str(CHECK_SEQ)]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=dict(os.environ, **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=60)
        text = f"timed out after {DIST_TIMEOUT_S} s\n{text}"
    logs = []
    for r in range(nproc):
        path = os.path.join(log, f"workerlog.{r}")
        logs.append(open(path).read() if os.path.exists(path) else "")
        for line in logs[-1].splitlines():
            if line.startswith("[dist-"):
                print(line, flush=True)
    if proc.returncode != 0:
        tails = "\n".join(f"--- rank {r} ---\n" + "\n".join(lg.splitlines()[-40:])
                          for r, lg in enumerate(logs))
        raise AssertionError(f"dist phase {phase}: the launch exited with {proc.returncode}\n"
                             f"{text[-3000:]}\n{tails}")
    res = [json.load(open(os.path.join(out, f"dist_{phase}.{r}.json"))) for r in range(nproc)]
    shutil.rmtree(out, ignore_errors=True)
    return res


def dist_phase(seed: int, train_step_ms: float) -> dict:
    """Phase 24 (24a, 24b): returns the launches of each."""
    import torch

    torch.cuda.empty_cache()
    (a,) = run_ranks("a", 1, seed)
    per_step = expected_launches(TRAIN_LAYERS)
    want = {"flash_wgmma_fwd": per_step["flash_wgmma_fwd"] * TRAIN_STEPS,
            "flash_wgmma_bwd": per_step["flash_wgmma_bwd"] * TRAIN_STEPS,
            "rms_norm_fwd_round_first": per_step["rms_norm_fwd_round_first"] * TRAIN_STEPS,
            "rms_norm_bwd_dx_round_first": per_step["rms_norm_bwd_dx_round_first"] * TRAIN_STEPS,
            "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
            "multi_tensor_update": per_step["multi_tensor_update"] * TRAIN_STEPS}
    if a["launches"] != want:
        raise AssertionError(f"phase 24a launched {a['launches']}, expected {want}")
    if a["backend"] != "nccl" or a["world"] != 1:
        raise AssertionError(f"phase 24a ran on {a['backend']} at world {a['world']}")
    say("dist-a", step_ms_mean=a["step_ms_mean"], train_step_ms=round(train_step_ms, 3),
        step_ms_ratio_to_train=round(a["step_ms_mean"] / train_step_ms, 4),
        collectives_per_step=json.dumps(a["collectives_per_step"]),
        check_params_equal=f"{a['check_params_equal']}/{a['check_params']}")
    ranks = run_ranks("b", 2, seed, {"PADDLE_DISTRI_BACKEND": "gloo"})
    b0, b1 = ranks
    for key in ("grad_checksums", "param_checksums"):
        if b0[key] != b1[key]:
            bad = [n for n in b0[key] if b0[key][n] != b1[key][n]]
            raise AssertionError(f"phase 24b: the ranks' {key} differ at {bad}")
    per_rank = expected_launches(CHECK_LAYERS, traced=False)
    want_b = {"flash_wgmma_fwd": per_rank["flash_wgmma_fwd"],
              "flash_wgmma_bwd": per_rank["flash_wgmma_bwd"],
              "rms_norm_fwd_round_first": 0, "rms_norm_bwd_dx_round_first": 0,
              "rms_norm_fwd_fused": per_rank["rms_norm_fwd_fused"],
              "rms_norm_bwd_dx_fused": per_rank["rms_norm_bwd_dx_fused"],
              "multi_tensor_update": 1}
    for r in ranks:
        if r["launches"] != want_b or r["backend"] != "gloo":
            raise AssertionError(f"phase 24b rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']}, expected {want_b} on gloo")
    say("dist-b", ranks=len(ranks), devices=json.dumps([r["device"] for r in ranks]),
        grads_bit_identical=True, params_bit_identical=True,
        buckets=json.dumps(b0["buckets"]), comm_buffer_size_mb=b0["comm_buffer_size_mb"],
        grad_vs_ref_max_rel=b0["grad_vs_ref_max_rel"],
        grad_vs_ref_worst_leaf=b0["grad_vs_ref_worst_leaf"],
        grad_vs_ref_tol=b0["grad_vs_ref_tol"],
        planted_faults_max_rel=json.dumps(b0["planted_faults_max_rel"]),
        vs_trainstep_max_abs_diff=b0["vs_trainstep_max_abs_diff"],
        vs_trainstep_tol=b0["vs_trainstep_tol"])
    launches = {k: a["launches"][k] + sum(r["launches"][k] for r in ranks)
                for k in a["launches"]}
    return {"a": a["launches"], "b": {k: sum(r["launches"][k] for r in ranks)
                                      for k in want_b}, "all": launches}


# ---------------------------------------------------------------------------
# phase 25: tensor parallelism over two ranks sharing the card
# ---------------------------------------------------------------------------

TP = 2


def tensor_phase(seed: int, train_step_ms: float) -> dict:
    """Phase 25 (25a-c): returns the launches of 25a's timed steps over
    both ranks."""
    import torch

    torch.cuda.empty_cache()
    ranks = run_ranks("t", TP, seed, {"PADDLE_DISTRI_BACKEND": "gloo"})
    per_step = expected_launches(TRAIN_LAYERS)
    want = {k: per_step[k] * TRAIN_STEPS for k in (
        "flash_wgmma_fwd", "flash_wgmma_bwd", "rms_norm_fwd_round_first",
        "rms_norm_bwd_dx_round_first", "multi_tensor_update")}
    want.update(rms_norm_fwd_fused=0, rms_norm_bwd_dx_fused=0)
    for r in ranks:
        if r["launches"] != want or r["backend"] != "gloo" or r["world"] != TP:
            raise AssertionError(f"phase 25a rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']} at world {r['world']}, expected {want}")
    for key in ("check", "check_sp"):
        sums = [r[key]["uncut_checksums"] for r in ranks]
        if any(s != sums[0] for s in sums) or not sums[0]:
            bad = [n for n in sums[0] if any(s.get(n) != sums[0][n] for s in sums)]
            raise AssertionError(f"phase 25b ({key}): the ranks' uncut parameters differ at "
                                 f"{bad}")
    r0 = ranks[0]
    for key in ("check", "check_sp"):
        c = r0[key]
        say("tensor-b", case=key, loss=c["loss"], loss_plain=c["loss_plain"],
            grad_vs_ref_max_rel=c["grad_vs_ref_max_rel"],
            grad_vs_ref_worst_leaf=c["grad_vs_ref_worst_leaf"],
            grad_vs_ref_tol=c["grad_vs_ref_tol"],
            leaves=c["leaves"], cut_on_rank=c["cut"],
            uncut_bit_identical=f"{len(c['uncut_checksums'])}/{len(c['uncut_checksums'])}",
            planted_faults_max_rel=json.dumps(c.get("planted_faults_max_rel", {})),
            sentinel_grad_norm=c["sentinel_grad_norm"],
            sentinel_plain_norm=c["sentinel_plain_norm"],
            sentinel_norm_rel=c["sentinel_norm_rel"],
            sentinel_ranks_agree=c["sentinel_ranks_agree"])
    say("tensor-c", **r0["semi_auto"])
    say("tensor-a", ranks=TP, step_ms_mean=json.dumps([r["step_ms_mean"] for r in ranks]),
        train_step_ms=round(train_step_ms, 3),
        step_ms_ratio_to_train=round(max(r["step_ms_mean"] for r in ranks) / train_step_ms, 4),
        max_memory_allocated_gib=json.dumps([r["max_memory_allocated_gib"] for r in ranks]),
        device_busy_share=json.dumps([r["device_busy_share"] for r in ranks]),
        params_on_rank=r0["params_on_rank"],
        collectives_per_step=json.dumps(r0["collectives_per_step"]),
        collective_bytes_per_step=json.dumps(r0["collective_bytes_per_step"]),
        launches_per_rank=json.dumps(r0["launches"]))
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 26: the pipeline over two ranks sharing the card
# ---------------------------------------------------------------------------


def pipe_expected(rank: int, steps: int = TRAIN_STEPS) -> dict:
    """Launches on stage ``rank`` of phase 26a's timed steps: per microbatch
    flash once each way a layer of the stage and RMSNorm (``round_first``:
    a pipeline stage runs traced) twice each way a layer, plus the final
    norm on the last stage; one fused update a step (a stage's tensors fit
    one launch)."""
    from paddle_tpu_torch.tools.dist_train import PIPE, PIPE_M

    layers = TRAIN_LAYERS // PIPE
    norms = 2 * layers + (rank == PIPE - 1)
    return {"flash_wgmma_fwd": PIPE_M * layers * steps, "flash_wgmma_bwd": PIPE_M * layers * steps,
            "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
            "rms_norm_fwd_round_first": PIPE_M * norms * steps,
            "rms_norm_bwd_dx_round_first": PIPE_M * norms * steps,
            "multi_tensor_update": steps}


def pipe_phase(seed: int, train_step_ms: float) -> dict:
    """Phase 26 (26a-c): returns the launches of 26a's timed steps over
    both ranks."""
    import torch

    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, PIPE, PIPE_M, PIPE_STYLES

    torch.cuda.empty_cache()
    ranks = run_ranks("p", PIPE, seed, {"PADDLE_DISTRI_BACKEND": "gloo"})
    for r in ranks:
        want = pipe_expected(r["rank"])
        if r["launches"] != want or r["backend"] != "gloo" or r["world"] != PIPE:
            raise AssertionError(f"phase 26a rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']} at world {r['world']}, expected {want}")
    r0 = ranks[0]
    for style, m, chunks in PIPE_STYLES:
        c = r0["check"][style]
        if c["grad_vs_ref_beyond_tol"] or not c["leaves_checked"]:
            raise AssertionError(f"phase 26b ({style}): {c}")
        say("pipe-b", schedule=style, microbatches=m, chunks=chunks, loss=c["loss"],
            loss_plain=c["loss_plain"], grad_vs_ref_max_rel=c["grad_vs_ref_max_rel"],
            grad_vs_ref_worst_leaf=c["grad_vs_ref_worst_leaf"], grad_vs_ref_tol=GRAD_TOL,
            leaves=c["leaves"],
            peak_in_flight=json.dumps([r["check"][style]["peak_in_flight"] for r in ranks]),
            ring=c["ring"])
    faults = r0["check"]["planted_faults_max_rel"]
    if any(e <= GRAD_TOL for e in faults.values()):
        raise AssertionError(f"phase 26b: the planted faults pass the check: {faults}")
    say("pipe-b", planted_faults_max_rel=json.dumps(faults), grad_vs_ref_tol=GRAD_TOL)
    mem = [r["memory"] for r in ranks]
    say("pipe-c", microbatches=8, stage0=json.dumps(mem[0]), stage1=json.dumps(mem[1]))
    if not mem[0]["1f1b"]["peak_above_rest_gib"] < mem[0]["fthenb"]["peak_above_rest_gib"]:
        raise AssertionError(f"phase 26c: stage 0's peak under 1F1B is not below FThenB's: "
                             f"{mem[0]}")
    from paddle_tpu_torch.models.llama import LlamaConfig

    seq = TRAIN_SEQ // PIPE_M
    reckoned = PIPE_M * seq * LlamaConfig.llama3_8b().hidden_size * 2
    say("pipe-a", ranks=PIPE, microbatches=PIPE_M, rows=f"{PIPE_M} x {seq}",
        step_ms_mean=json.dumps([r["step_ms_mean"] for r in ranks]),
        step_ms=json.dumps([r["step_ms"] for r in ranks]), host_transport_included=True,
        train_step_ms=round(train_step_ms, 3),
        step_ms_ratio_to_train=round(max(r["step_ms_mean"] for r in ranks) / train_step_ms, 4),
        max_memory_allocated_gib=json.dumps([r["max_memory_allocated_gib"] for r in ranks]),
        device_busy_share=json.dumps([r["device_busy_share"] for r in ranks]),
        params_on_rank=json.dumps([r["params_on_rank"] for r in ranks]),
        transfers_per_step=json.dumps([r["transfers_per_step"] for r in ranks]),
        transfer_bytes_per_step=json.dumps([r["transfer_bytes_per_step"] for r in ranks]),
        reckoned_bytes_each_way=reckoned, losses=json.dumps([r["losses"] for r in ranks]),
        launches_per_rank=json.dumps([r["launches"] for r in ranks]))
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 27: hybrid parallelism over four ranks sharing the card
# ---------------------------------------------------------------------------


def hybrid_phase(seed: int, train_step_ms: float) -> dict:
    """Phase 27 (27a-c): returns the launches of 27a's timed steps over
    the four ranks."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools.dist_train import GRAD_TOL, HY_M, HY_STYLES, HYBRID

    torch.cuda.empty_cache()
    ranks = run_ranks("h", HYBRID, seed, {"PADDLE_DISTRI_BACKEND": "gloo"})
    cfg = LlamaConfig.llama3_8b()
    # activations and cotangents between stages: each rank's half of the sequence
    reckoned = HY_M * (TRAIN_SEQ // HY_M // 2) * cfg.hidden_size * 2
    for r in ranks:
        # a stage's launches as in phase 26a (rank r runs stage r // 2), each
        # flash at the rank's heads (H 16, Hk 4), each RMSNorm on its part of
        # the sequence ([1024, 4096] a microbatch), one fused update a step
        want = pipe_expected(r["rank"] // 2)
        if r["launches"] != want or r["backend"] != "gloo" or r["world"] != HYBRID:
            raise AssertionError(f"phase 27a rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']} at world {r['world']}, expected {want}")
        sent = r["transfer_bytes_per_step"]
        if sent.get("send") != reckoned or sent.get("recv") != reckoned:
            raise AssertionError(f"phase 27a rank {r['rank']} moved {sent} a step between "
                                 f"stages, expected {reckoned} each way")
    r0 = ranks[0]
    for style, m, chunks, spec in HY_STYLES:
        c = r0["check"][f"{style}_spec{int(spec)}"]
        if c["grad_vs_ref_beyond_tol"] or not c["leaves_checked"]:
            raise AssertionError(f"phase 27b ({style}, activation_spec {spec}): {c}")
        say("hybrid-b", schedule=style, microbatches=m, chunks=chunks, activation_spec=spec,
            sequence_parallel=spec, loss=c["loss"], loss_plain=c["loss_plain"],
            grad_vs_ref_max_rel=c["grad_vs_ref_max_rel"],
            grad_vs_ref_worst_leaf=c["grad_vs_ref_worst_leaf"], grad_vs_ref_tol=GRAD_TOL,
            leaves=c["leaves"])
    faults = {k: v["grad_vs_ref_max_rel"] for k, v in r0["check"].items()
              if k.endswith(("_unsummed", "_wrong_peer"))}
    if len(faults) != 2 or any(e <= GRAD_TOL for e in faults.values()):
        raise AssertionError(f"phase 27b: the planted faults pass the check: {faults}")
    say("hybrid-b", planted_faults_max_rel=json.dumps(faults), grad_vs_ref_tol=GRAD_TOL)
    shard = [r["shard"] for r in ranks]
    c0 = shard[0]
    if c0["grad_vs_ref_beyond_tol"] or not c0["leaves_checked"]:
        raise AssertionError(f"phase 27c: {c0}")
    for c in shard:
        if c["state_numel"] * 2 != c["pp2_state_numel"]:
            raise AssertionError(f"phase 27c: the optimizer state on a rank is not half of "
                                 f"pp 2's: {c}")
    say("hybrid-c", mode=c0["mode"], sharding_stage=c0["sharding_stage"], loss=c0["loss"],
        loss_plain=c0["loss_plain"], grad_vs_ref_max_rel=c0["grad_vs_ref_max_rel"],
        grad_vs_ref_worst_leaf=c0["grad_vs_ref_worst_leaf"], grad_vs_ref_tol=GRAD_TOL,
        state_numel=json.dumps([c["state_numel"] for c in shard]),
        pp2_state_numel=json.dumps([c["pp2_state_numel"] for c in shard]),
        state_ratio_to_pp2=json.dumps([c["state_ratio_to_pp2"] for c in shard]))
    say("hybrid-a", ranks=HYBRID, mesh="pp 2 x tensor 2", microbatches=HY_M,
        rows=f"{HY_M} x {TRAIN_SEQ // HY_M}", activation_spec=True, sequence_parallel=True,
        coords=json.dumps([r["coord"] for r in ranks]),
        step_ms_mean=json.dumps([r["step_ms_mean"] for r in ranks]),
        step_ms=json.dumps([r["step_ms"] for r in ranks]), host_transport_included=True,
        train_step_ms=round(train_step_ms, 3),
        step_ms_ratio_to_train=round(max(r["step_ms_mean"] for r in ranks) / train_step_ms, 4),
        max_memory_allocated_gib=json.dumps([r["max_memory_allocated_gib"] for r in ranks]),
        device_busy_share=json.dumps([r["device_busy_share"] for r in ranks]),
        params_on_rank=json.dumps([r["params_on_rank"] for r in ranks]),
        transfers_per_step=json.dumps([r["transfers_per_step"] for r in ranks]),
        transfer_bytes_per_step=json.dumps([r["transfer_bytes_per_step"] for r in ranks]),
        reckoned_bytes_each_way=reckoned, losses=json.dumps([r["losses"] for r in ranks]),
        launches_per_rank=json.dumps([r["launches"] for r in ranks]))
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 28: context parallelism across ranks sharing the card
# ---------------------------------------------------------------------------


# 28a's timed steps: two fewer than the other cells', whose ~9-12 s each
# are gloo's host transport of the gradients (the script's time limit: cut
# from 2 to 1 when phase 29 came; every check of phase 28 stays)
SEP_STEPS = 1


def sep_phase(seed: int, train_step_ms: float, ring_step_ms: float) -> dict:
    """Phase 28 (28a-c): returns the launches of 28a's timed steps over
    both ranks, the ring's among them."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools.dist_train import (GRAD_TOL, SEP, SEP_RUNS, SEP_TENSOR,
                                                   sep_bytes, sep_expected)

    torch.cuda.empty_cache()
    ranks = run_ranks("s", SEP, seed, {"PADDLE_DISTRI_BACKEND": "gloo"}, SEP_STEPS)
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS)
    ring_bytes = sep_bytes(cfg, TRAIN_SEQ, SEP, TRAIN_LAYERS)
    failures = []
    for r in ranks:
        # rank r of the causal ring: flash r + 1 times each way a layer, the
        # merge r times, RMSNorm round_first on its [4096, 4096] rows
        want = sep_expected(r["sep_index"], TRAIN_LAYERS, SEP_STEPS)
        if r["launches"] != want or r["backend"] != "gloo" or r["world"] != SEP:
            raise AssertionError(f"phase 28a rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']} at world {r['world']}, expected {want}")
        moved = r["collective_bytes_per_step"]
        reduce_bytes = 4 * r["params"] + 12     # f32 gradients over gloo, the loss's sum and count
        if moved.get("send") != ring_bytes or moved.get("recv") != ring_bytes \
                or moved.get("all_reduce") != reduce_bytes:
            raise AssertionError(f"phase 28a rank {r['rank']} moved {moved} a step, expected "
                                 f"{ring_bytes} each way around the ring and {reduce_bytes} "
                                 "all-reduced")
        if not all(r["vs_one_process"]["bit_identical"].values()):
            failures.append(f"phase 28a rank {r['rank']}: the ring across processes is not "
                            f"the one-process ring's bits: {r['vs_one_process']}")
    r0 = ranks[0]
    for part, group in (("28b", ranks), ("28c", None)):
        if group is None:
            group = run_ranks("s", SEP_TENSOR, seed, {"PADDLE_DISTRI_BACKEND": "gloo"})
        c = group[0]["check"]
        for cp, plant in SEP_RUNS:
            name = cp + (f"_{plant}" if plant else "")
            k = c[name]
            say(f"sep-{part[-1]}", mesh="sep 2" if part == "28b" else "sep 2 x tensor 2",
                context_parallel=cp, planted_fault=plant or "none", loss=k["loss"],
                loss_plain=k["loss_plain"], grad_vs_ref_max_rel=k["grad_vs_ref_max_rel"],
                grad_vs_ref_worst_leaf=k["grad_vs_ref_worst_leaf"], grad_vs_ref_tol=GRAD_TOL,
                leaves=k["leaves"], seconds=k["seconds"])
            if not k["leaves_checked"]:
                failures.append(f"phase {part} ({name}): not every leaf checked: {k}")
            elif plant is None and k["grad_vs_ref_beyond_tol"]:
                failures.append(f"phase {part} ({name}): {k}")
            elif plant is not None and not k["grad_vs_ref_max_rel"] > GRAD_TOL:
                failures.append(f"phase {part}: the planted fault {plant} passes the check: {k}")
    say("sep-a", ranks=SEP, mesh="sep 2", rows=f"1 x {TRAIN_SEQ}",
        positions_on_rank=r0["positions_on_rank"],
        vs_one_process=json.dumps([r["vs_one_process"] for r in ranks]),
        step_ms_mean=json.dumps([r["step_ms_mean"] for r in ranks]),
        step_ms=json.dumps([r["step_ms"] for r in ranks]), host_transport_included=True,
        train_step_ms=round(train_step_ms, 3), ring_step_ms=round(ring_step_ms, 3),
        step_ms_ratio_to_train=round(max(r["step_ms_mean"] for r in ranks) / train_step_ms, 4),
        step_ms_ratio_to_ring=round(max(r["step_ms_mean"] for r in ranks) / ring_step_ms, 4),
        max_memory_allocated_gib=json.dumps([r["max_memory_allocated_gib"] for r in ranks]),
        device_busy_share=json.dumps([r["device_busy_share"] for r in ranks]),
        collectives_per_step=json.dumps(r0["collectives_per_step"]),
        collective_bytes_per_step=json.dumps(r0["collective_bytes_per_step"]),
        reckoned_ring_bytes_each_way=ring_bytes, losses=json.dumps([r["losses"] for r in ranks]),
        launches_per_rank=json.dumps([r["launches"] for r in ranks]))
    if failures:
        raise AssertionError("\n".join(failures))
    out = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    out["ring_flash_attention"] = sum(out[k] for k in ("flash_wgmma_fwd", "flash_wgmma_bwd",
                                                       "ring_merge"))
    return out


# ---------------------------------------------------------------------------
# phase 29: expert parallelism across ranks sharing the card
# ---------------------------------------------------------------------------

# 29a's timed steps (each ~3.5 s, most of it gloo's host transport)
EP_STEPS = 2


def expert_phase(seed: int, train_step_ms: float, moe_step_ms: float) -> dict:
    """Phase 29 (29a-c): two gloo ranks, a Mixtral-width MoE Llama at
    ``EP_LAYERS`` layers through ``PartitionedTrainStep``; returns the
    launches of 29a's timed steps over both ranks."""
    import torch

    from paddle_tpu_torch.tools.dist_train import EP, EP_FAULT_CF, EP_LAYERS, GRAD_TOL

    torch.cuda.empty_cache()
    ranks = run_ranks("e", EP, seed, {"PADDLE_DISTRI_BACKEND": "gloo"}, EP_STEPS)
    failures = []
    r0 = ranks[0]
    for name, part, mesh, rows in (("check_dp", "29a", "dp 2", f"2 x {TRAIN_SEQ // 2}"),
                                   ("check_fault", "29c", "dp 2", f"2 x {CHECK_SEQ}"),
                                   ("check_tensor", "29b", "tensor 2", f"1 x {CHECK_SEQ}")):
        for case, k in r0[name].items():
            say(f"expert-{part[-1]}", mesh=mesh, rows=rows, case=case,
                capacity_factor=EP_FAULT_CF if name == "check_fault" else 1.5,
                loss=k["loss"], loss_plain=k["loss_plain"], loss_rel_diff=k["loss_rel_diff"],
                loss_rtol=k["loss_rtol"], grad_vs_ref_max_rel=k["grad_vs_ref_max_rel"],
                grad_vs_ref_worst_leaf=k["grad_vs_ref_worst_leaf"], grad_vs_ref_tol=GRAD_TOL,
                leaves=k["leaves"], logits_differing=f"{k['logits_differing']}/{k['logits']}",
                logits_max_ulps=k["logits_max_ulps"], logits_tol_ulps=k["logits_tol_ulps"],
                seconds=k["seconds"])
            if not k["leaves_checked"]:
                failures.append(f"phase {part} ({case}): not every leaf checked: {k}")
            elif case == "check" and (k["grad_vs_ref_beyond_tol"]
                                      or k["logits_max_ulps"] > k["logits_tol_ulps"]
                                      or k["loss_rel_diff"] > k["loss_rtol"]):
                failures.append(f"phase {part}: {k}")
            elif case != "check" and not k["grad_vs_ref_max_rel"] > GRAD_TOL:
                failures.append(f"phase {part}: the planted fault {case} passes the check: {k}")
    hidden = r0["hidden"]
    for r in ranks:
        if r["launches"] != r["expected_launches"] or r["backend"] != "gloo" \
                or r["world"] != EP:
            raise AssertionError(f"phase 29a rank {r['rank']} launched {r['launches']} on "
                                 f"{r['backend']} at world {r['world']}, expected "
                                 f"{r['expected_launches']}")
        # a layer's forward sends the rank's kept rows and returns what it
        # received; its backward sends both back: bf16 rows of H
        a2a = 2 * sum(r["a2a_rows"]) * hidden * 2
        reduced = 4 * r["replicated_params"] * EP_STEPS     # f32 over gloo
        moved = r["collective_bytes"]
        if moved.get("all_to_all_single") != a2a or moved.get("fused_allreduce") != reduced:
            raise AssertionError(f"phase 29a rank {r['rank']} moved {moved}, expected {a2a} "
                                 f"through the all-to-all and {reduced} all-reduced")
    for layer in range(EP_LAYERS):      # every kept choice leaves its rank and comes back
        moved_rows = sum(r["a2a_rows"][layer] for r in ranks)
        if moved_rows != 2 * r0["kept_rows"][layer]:
            raise AssertionError(f"phase 29a layer {layer}: {moved_rows} rows through the "
                                 f"all-to-all, {r0['kept_rows'][layer]} kept choices")
    step_ms = max(r["step_ms_mean"] for r in ranks)
    say("expert-a", ranks=EP, mesh="dp 2 (experts on dp)", rows=f"2 x {TRAIN_SEQ // 2}",
        layers=EP_LAYERS, step_ms_mean=json.dumps([r["step_ms_mean"] for r in ranks]),
        step_ms=json.dumps([r["step_ms"] for r in ranks]), host_transport_included=True,
        train_step_ms=round(train_step_ms, 3), moe_step_ms=round(moe_step_ms, 3),
        step_ms_ratio_to_train=round(step_ms / train_step_ms, 4),
        step_ms_ratio_to_moe=round(step_ms / moe_step_ms, 4),
        tokens_per_s=round(2 * (TRAIN_SEQ // 2) / step_ms * 1e3, 1),
        max_memory_allocated_gib=json.dumps([r["max_memory_allocated_gib"] for r in ranks]),
        device_busy_share=json.dumps([r["device_busy_share"] for r in ranks]),
        params_on_rank=r0["params_on_rank"], expert_params_on_rank=r0["expert_params_on_rank"],
        a2a_rows=json.dumps([r["a2a_rows"] for r in ranks]), kept_rows=r0["kept_rows"],
        collective_bytes=json.dumps([r["collective_bytes"] for r in ranks]),
        collectives_per_step=json.dumps(r0["collectives_per_step"]),
        losses=json.dumps([r["losses"] for r in ranks]),
        launches_per_rank=json.dumps([r["launches"] for r in ranks]))
    if failures:
        raise AssertionError("\n".join(failures))
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


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
    gemm, gemm_verify = check_int8(gen)
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
    reset_observability()
    bf16_reqs = serve(engine, prompts, NEW_TOKENS, "bf16-engine")
    serve_obs = hold_serving_telemetry(engine, bf16_reqs, "bf16-engine")
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
    with recording_decode(engine) as decoded:
        int8_reqs = serve(engine, prompts, NEW_TOKENS, "int8-engine")
    time_decode_traffic(gen, "phase4", decoded, engine._kv.num_blocks)
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
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    prefix_kern, prefix_launches = check_prefix_cache(model, args.seed, gen)
    lap("15")
    verify_launches = check_speculative(model, args.seed)
    del model
    torch.cuda.empty_cache()
    lap("16")
    fused_opt = check_fused_optimizer(args.seed)
    sentinel_kern = check_sentinels(args.seed)
    lap("17")
    amp_o2 = train_amp(args.seed, "O2", TRAIN_LAYERS)
    amp_o1 = train_amp(args.seed, "O1", AMP_O1_LAYERS)
    say("amp", o2_step_ms=round(amp_o2["step_ms"], 3), o1_step_ms=round(amp_o1["step_ms"], 3),
        train_step_ms=round(trained["step_ms"], 3),
        o2_step_ms_ratio_to_train=round(amp_o2["step_ms"] / trained["step_ms"], 4),
        o2_max_memory_allocated_gib=round(amp_o2["max_memory_allocated_gib"], 3),
        o1_max_memory_allocated_gib=round(amp_o1["max_memory_allocated_gib"], 3))
    check_amp(args.seed)
    fused_master = check_fused_optimizer(args.seed, master=True)
    lap("18")
    ernie_launches = ernie(args.seed, smi)
    lap("19")
    vision_launches = vision(args.seed, smi)
    lap("20")
    hapi_launches = hapi(args.seed, smi)
    lap("21")
    moe_launches = moe(args.seed, smi)
    lap("22")
    ops_launches = ops_phase(args.seed, trained["step_ms"])
    lap("23")
    dist_launches = dist_phase(args.seed, trained["step_ms"])["all"]
    lap("24")
    tp_launches = tensor_phase(args.seed, trained["step_ms"])
    tp_flash = time_flash(gen, H=32 // TP, Hk=8 // TP, case=f"tensor{TP}_rank_shape")
    lap("25")
    pp_launches = pipe_phase(args.seed, trained["step_ms"])
    lap("26")
    hy_launches = hybrid_phase(args.seed, trained["step_ms"])
    pp_launches = {k: pp_launches[k] + hy_launches[k] for k in pp_launches}
    lap("27")
    sep_launches = sep_phase(args.seed, trained["step_ms"], ring_trained["step_ms"])
    pp_launches = {k: pp_launches[k] + sep_launches[k] for k in pp_launches}
    for name in ("ring_merge", "ring_flash_attention"):
        ring_launches[name] += sep_launches[name]
    lap("28")
    ep_launches = expert_phase(args.seed, trained["step_ms"], moe_launches["step_ms"])
    from paddle_tpu_torch.tools.dist_train import EP_LAYERS
    pp_launches = {k: pp_launches[k] + ep_launches[k] for k in pp_launches}
    lap("29")
    amp_launches = {k: amp_o2["launches"][k] + amp_o1["launches"][k] for k in amp_o2["launches"]}

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
            "launches": (train_launches[wrapper] + amp_launches[wrapper]
                         + moe_launches["train"][wrapper] + ops_launches[wrapper]
                         + dist_launches[wrapper] + tp_launches[wrapper]
                         + pp_launches[wrapper]), **nums})
        kernels[-1][f"at_tensor{TP}_rank_shape"] = {
            k: v for k, v in tp_flash[0 if name.endswith("fwd") else 1].items()
            if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "at")}
        kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed training steps "
                              f"({TRAIN_LAYERS} layers), the {TRAIN_STEPS} timed AMP steps "
                              f"of each level (phase 18, bf16), the {MOE_STEPS} timed steps "
                              f"of the Mixtral cell (phase 22a, {MOE_LAYERS} layers, S "
                              f"{MOE_SEQ}), the {TRAIN_STEPS} timed eager steps of "
                              f"OpsLlama (phase 23a: scaled_dot_product_attention), the "
                              f"{TRAIN_STEPS} timed steps of phase 24a (one NCCL rank, "
                              f"{TRAIN_LAYERS} layers), phase 24b's step on each of its two "
                              f"gloo ranks ({CHECK_LAYERS} layers, S {CHECK_SEQ}) and the "
                              f"{TRAIN_STEPS} timed steps of phase 25a on each of its {TP} "
                              f"ranks (tensor {TP}: H {32 // TP}, Hk {8 // TP} a rank) and "
                              f"those of phase 26a on each of its two pipeline stages "
                              f"({TRAIN_LAYERS // 2} layers a stage, 4 microbatches of 1 x "
                              f"{TRAIN_SEQ // 4}) and of phase 27a on each of its four ranks "
                              f"(pp 2 x tensor 2: H {32 // TP}, Hk {8 // TP} a rank) and of "
                              f"phase 28a on each of its two sep ranks ({SEP_STEPS} steps, the "
                              f"ring across processes on {TRAIN_SEQ // 2} positions a rank: "
                              f"rank r launches r + 1 a layer each way) and of phase 29a on "
                              f"each of its two ranks ({EP_STEPS} steps, the Mixtral-width "
                              f"MoE at {EP_LAYERS} layers, experts over dp, 1 x "
                              f"{TRAIN_SEQ // 2} a rank)")
    for name, nums, launches in (
            ("rms_norm_fwd", norm_fwd, norm_launches["fwd"] + amp_launches["rms_norm_fwd_fused"]
             + ops_launches["rms_norm_fwd_fused"] + dist_launches["rms_norm_fwd_fused"]),
            ("rms_norm_bwd", norm_bwd, norm_launches["bwd"] + amp_launches["rms_norm_bwd_dx_fused"]
             + ops_launches["rms_norm_bwd_dx_fused"] + dist_launches["rms_norm_bwd_dx_fused"])):
        kernels.append({
            "name": name, "route": "cuda", "source": "paddle_tpu_torch/csrc/rms_norm.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm.py:79", "launches": launches, **nums})
        kernels[-1]["at"] += ("; the fused rounding, which eager calls take (a TrainStep "
                              "takes round_first): launches from phase 5's checks, in f32 "
                              "(amp casts a norm's inputs to f32) the timed AMP steps of "
                              "phase 18, and in bf16 the timed eager steps of OpsLlama (phase "
                              "23a: nn.functional.rms_norm) and phase 24b's eager step on each "
                              "of its two ranks")
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
        kernels[-1]["at"] += (f" ({TRAIN_STEPS} steps, {TRAIN_LAYERS} layers, sep={RING}), and "
                              f"the {SEP_STEPS} timed steps of phase 28a on each of its two "
                              "sep ranks (the ring across processes: rank r merges r times a "
                              "layer)")
    for name, source, replaces, nums, launches, where in (
            ("int8_matmul_fp16", "quant_matmul.cu", "quant_matmul.py:117", fp16_step,
             fp16_launches, "the traced window of the graphed fp16 int8 engine "
             f"({FP16_INT8_LAYERS} layers)"),
            ("int8_matmul_large_m_fp16", "quant_matmul.cu", "quant_matmul.py:117", fp16_layer,
             fp16_tc_launches, "phase 2's held calls (no serving path runs M > 64)"),
            ("rms_norm_fwd_round_first", "rms_norm.cu", "fused_norm.py:79", rms_rf[0],
             train_launches["rms_norm_fwd_round_first"]
             + moe_launches["train"]["rms_norm_fwd_round_first"]
             + dist_launches["rms_norm_fwd_round_first"]
             + tp_launches["rms_norm_fwd_round_first"]
             + pp_launches["rms_norm_fwd_round_first"],
             f"the {TRAIN_STEPS} timed training steps (TrainStep runs the composed form's "
             f"rounding), the {MOE_STEPS} timed steps of the Mixtral cell (phase 22a), the "
             f"{TRAIN_STEPS} timed steps of phase 24a (TrainStep on the sharded model), "
             f"those of phase 25a on each of its {TP} ranks, those of phase 26a on each of "
             f"its two pipeline stages (a stage runs traced), those of phase 27a on each "
             f"of its four ranks (pp 2 x tensor 2, [{TRAIN_SEQ // 8}, 4096] a microbatch "
             f"under sequence parallelism), those of phase 28a on each of its two sep "
             f"ranks ([{TRAIN_SEQ // 2}, 4096] a step) and those of phase 29a on each of "
             f"its two ranks ([{TRAIN_SEQ // 2}, 4096] a step)"),
            ("rms_norm_bwd_round_first", "rms_norm.cu", "fused_norm.py:79", rms_rf[1],
             train_launches["rms_norm_bwd_dx_round_first"]
             + moe_launches["train"]["rms_norm_bwd_dx_round_first"]
             + dist_launches["rms_norm_bwd_dx_round_first"]
             + tp_launches["rms_norm_bwd_dx_round_first"]
             + pp_launches["rms_norm_bwd_dx_round_first"],
             f"the {TRAIN_STEPS} timed training steps, the {MOE_STEPS} timed steps of the "
             f"Mixtral cell (phase 22a), the {TRAIN_STEPS} timed steps of phase 24a, "
             f"those of phase 25a on each of its {TP} ranks, those of phase 26a on each of "
             f"its two pipeline stages, those of phase 27a on each of its four ranks, "
             f"those of phase 28a on each of its two sep ranks and those of phase 29a on "
             f"each of its two ranks"),
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
    kernels.append({
        "name": "paged_decode_attention_prefix_cache", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:68", "launches": prefix_launches,
        **{k: prefix_kern[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
        "at": f"8 lanes, H32 Hk8 hd128 bs16 MB64, bf16, lengths {PREFIX_LENGTHS}, the first "
              f"{PREFIX_SYSTEM // 16} pages of every lane shared (one lane holds a fork of the "
              "last), the bound counting each shared row once; launches traced on the device "
              "in the graphed prefix-cache engine's window of 8 hits (phase 15)"})
    kernels.append({
        "name": "int8_matmul_verify", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:117", "launches": verify_launches,
        **{k: gemm_verify[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "bf16_gemm_ms")},
        "at": f"sum over one verify call of the speculative engine at M={VERIFY_M} (8 lanes x "
              f"k + 1 = {SPEC_K + 1} positions; 7 projections x 32 layers + lm_head), bf16, "
              "the weight stream; launches traced on the device in the graphed int8 "
              "speculative engine's window (phase 16)"})
    kernels.append({
        "name": "multi_tensor_update", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/optimizer/fused_step.py:105 (an XLA program: no TPU kernel)",
        "launches": (train_launches["multi_tensor_update"]
                     + amp_launches["multi_tensor_update_direct"] + ernie_launches["direct"]
                     + vision_launches["resnet50"] + vision_launches["lenet"]
                     + sum(hapi_launches.values()) + moe_launches["train"]["multi_tensor_update"]
                     + moe_launches["bench"] + ops_launches["multi_tensor_update"]
                     + dist_launches["multi_tensor_update"] + tp_launches["multi_tensor_update"]
                     + pp_launches["multi_tensor_update"]),
        **fused_opt})
    kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed training steps "
                          f"({TRAIN_LAYERS} layers, one AdamW update a step), the "
                          f"{TRAIN_STEPS} timed O1 AMP steps (f32 parameters) and the "
                          f"{ERNIE_STEPS} timed ERNIE-3.0 base finetune steps of phase 19a "
                          f"({ernie_launches['direct']}: {ERNIE_TENSORS} bf16 tensors, two "
                          f"launches a step), the {VISION_STEPS} timed ResNet-50 steps of phase "
                          f"20a ({vision_launches['resnet50']}: Momentum over "
                          f"{RESNET50_TENSORS} bf16 tensors, two launches a step) and the "
                          f"{LENET_STEPS} counted LeNet steps of phase 20e "
                          f"({vision_launches['lenet']}: Adam over 10 f32 tensors, one a step) "
                          f"and phase 21's Model.fit runs: the quick start's two epochs "
                          f"({hapi_launches['quickstart']}), the {HAPI_CHECK_STEPS} card steps "
                          f"of 21b ({hapi_launches['check']}) and ResNet-50's Flowers epoch "
                          f"({hapi_launches['flowers']}: Momentum over {RESNET50_TENSORS} f32 "
                          "tensors, two launches a step), and phase 22: the Mixtral cell's "
                          f"{MOE_STEPS} timed steps ({moe_launches['train']['multi_tensor_update']}"
                          f": AdamW over {10 * MOE_LAYERS + 3} bf16 tensors, one a step) and the "
                          f"MoE bench's SGD steps ({moe_launches['bench']}: "
                          f"{MOE_BENCH_TENSORS} tensors, one a step), and phase 23a: OpsLlama's "
                          f"{TRAIN_STEPS} timed eager steps ({ops_launches['multi_tensor_update']}"
                          f": opt.step() of AdamW over {9 * TRAIN_LAYERS + 3} bf16 tensors, one "
                          f"a step), and phase 24: 24a's {TRAIN_STEPS} timed steps (the sharded "
                          "update over one NCCL rank, one a step) and 24b's eager step on each "
                          f"of its two gloo ranks (one each), and phase 25a's {TRAIN_STEPS} timed "
                          f"steps on each of its {TP} ranks (the sharded update over the rank's "
                          f"slices, one a step), and phase 26a's {TRAIN_STEPS} timed steps on each "
                          "of its two pipeline stages (PipelineParallel.train_batch over the "
                          f"stage's tensors, one a step) and phase 27a's {TRAIN_STEPS} on each of "
                          "its four ranks (the sharded update over the stage's tensor slices, "
                          f"one a step) and phase 28a's {SEP_STEPS} on each of its two sep "
                          "ranks (TrainStep's update of the whole model, one a step) and phase "
                          f"29a's {EP_STEPS} on each of its two ranks (the sharded update over "
                          "the rank's expert slices and the replicated rest, one a step)")
    kernels.append({
        "name": "multi_tensor_update_master", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_optimizer.cu",
        "replaces": "paddle_tpu/optimizer/fused_step.py:142 (an XLA program: no TPU kernel)",
        "launches": amp_launches["multi_tensor_update_master"] + ernie_launches["master"],
        **fused_master})
    kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed O2 AMP steps of phase 18 "
                          "(the kernel's master mode, one a step) and the ERNIE steps of "
                          f"phase 19e under amp O2 ({ernie_launches['master']}, "
                          f"{ERNIE_LEARN_LAYERS} layers: one a step)")
    kernels.append({
        "name": "sentinel_stats", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/sentinels.cu",
        "replaces": "paddle_tpu/profiler/numerics.py:103 (part of an XLA program: no TPU kernel)",
        "launches": train_launches["sentinel_stats"], **sentinel_kern})
    kernels[-1]["at"] += (f"; launches from the {TRAIN_STEPS} timed training steps of phase 7 "
                          "(TrainStep at numerics 'summary': one a step over the gradients and "
                          "the parameters before the update)")
    say("done", total_s=round(time.perf_counter() - t_start, 1), phase_s=json.dumps(phase_s))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
