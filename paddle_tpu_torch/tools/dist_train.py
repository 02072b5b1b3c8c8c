"""Multi-process Llama training on the card, one rank of it: the worker of
``chip_smoke.py``'s phase 24 and of the distributed card tests.

Run through the launcher, e.g. ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 1
paddle_tpu_torch/tools/dist_train.py --phase a --out DIR``. Each rank
prints its numbers as ``[dist-<phase>] k=v`` lines and writes them to
``DIR/dist_<phase>.<rank>.json``: the launches of the flash, RMSNorm and
fused-optimizer kernels, counted from zero just before its main path runs
and read just after, and the collectives by kind (``distributed.collective``'s
counters).

- ``--phase a`` (one rank, NCCL): ``fleet.init`` with ``sharding_degree=1``,
  ``group_sharded_parallel(level="p_g_os")`` and ``TrainStep`` on the
  sharded model, with ``AdamW(3e-4, weight_decay=0.1)`` and
  ``ClipGradByGlobalNorm(1.0)``. First the step-check cell (``--check-layers``
  layers, ``--check-seq`` tokens): step 1's loss and every parameter held
  bit for bit against a plain ``TrainStep`` on the same batch (at one
  rank no collective runs and the sharded step sums the clip's squared
  norms in the same order); then the timed cell
  (``--layers`` layers, batch 1 x ``--seq``): a warm-up, ``--steps`` timed
  steps and one profiled step.
- ``--phase b`` (two ranks on one card, gloo): ``DataParallel`` with the
  bucketed reducer at the step-check cell, each rank on its row of a
  batch of 2 x ``--check-seq`` tokens; one eager step (``loss.backward();
  opt.step()``). Each rank writes a checksum of every gradient after the
  reduce and of every parameter after the step. Rank 0 holds its reduced
  gradients against a one-process backward on the whole batch: each
  leaf's largest difference over the leaf's largest entry must stay
  within ``GRAD_TOL`` (see there). The same check is run on two planted
  faults, which it must refuse: the reduced gradient not divided by the
  world (twice the mean), and rank 0's local gradient (a reduce that
  never ran, or one that covers half the batch). Rank 0 then holds its
  parameters against a one-process ``TrainStep`` on the whole batch
  within 2 lr plus one bf16 rounding of the parameter. That check is
  loose by nature: AdamW's first step moves a weight by lr * g / (|g| +
  eps), about lr times g's sign, whatever g's size, so it holds that the
  update ran once with the right rate, not the gradient; the gradient
  check holds the reduce.

- ``--phase t`` (two ranks on one card, gloo; tensor parallelism over
  ``Partitioner(build_program_mesh(tensor=world))`` and
  ``PartitionedTrainStep``): (c) the semi-auto API on CUDA tensors
  (``shard_tensor`` then ``reshard`` to ``Replicate`` equals the input,
  in f32 and bf16, and the gradient flows back whole); (b) the step-check
  cell, batch 1 x ``--check-seq`` on both ranks: the loss and every leaf's
  gradient after the step's reductions, gathered whole from the ranks,
  held on rank 0 against a one-process ``TrainStep``'s backward on the
  same card within ``GRAD_TOL`` of the leaf's largest entry; two planted
  faults refused by that check (the row-parallel products' all-reduce
  skipped, and the column-parallel inputs' backward all-reduce skipped);
  one optimizer step, whose numerics sentinels publish the same loss,
  grad norm and digest on both ranks, the norm the one-process
  gradients' within ``SENTINEL_NORM_TOL``, and after which every
  parameter the tensor axis does not cut (the norms) has the same bits on
  both ranks (a checksum each);
  then the same with ``sequence_parallel``; (a) the timed cell (phase
  7's, ``--layers`` layers, batch 1 x ``--seq``): a warm-up, ``--steps``
  timed steps (the host's transport of gloo included) and one profiled
  step, with exact launches and the collectives by kind.

- ``--phase p`` (two ranks on one card, gloo; the pipeline at pp 2 over
  ``ProcessMesh(shape=[2], dim_names=["pp"])``, the Llama split here into
  ``first`` (the embedding), ``layers`` (the decoder layers) and ``last``
  (the final norm and the head, ``LlamaForCausalLM.pipeline_stages``), the loss the
  model's mean cross entropy): (b) the step check at ``PIPE_CHECK_LAYERS`` layers,
  batch ``PIPE_M`` x ``--check-seq``: for each of ``PIPE_STYLES`` the loss
  and every leaf's gradient of ``forward_backward_pipeline``, reassembled
  by ``gather_pipeline_tree``, held on rank 0 against a one-process traced
  forward and backward of the whole batch on the same card within
  ``GRAD_TOL`` of the leaf's largest entry; two planted faults refused by
  that check (the last stage seeding its backward with 1 instead of 1/M,
  and stage 0 taking the cotangents of microbatches 0 and 1 through each
  other's graph); (c) the memory bound at the timed cell's widths and
  ``--layers``, ``PIPE_MEM_M`` microbatches of 1 x ``--seq / PIPE_MEM_M``:
  each stage's peak memory above its resting state over one pass of the
  schedule, under ``fthenb`` and ``1f1b``; (a) the timed cell: batch
  ``PIPE_M`` x ``--seq / PIPE_M`` in ``PIPE_M`` microbatches under
  ``1f1b``, ``PipelineParallel.train_batch`` with ``AdamW(3e-4,
  weight_decay=0.1)`` and no clip (the reference's ``train_batch`` reads
  none): a warm-up, ``--steps`` timed steps (the host's transport
  included) and one profiled step, with exact launches and the transfers
  by kind.

- ``--phase h`` (four ranks on one card, gloo; hybrid parallelism at pp 2
  x tensor 2 over ``ProcessMesh([2, 2], ["pp", "mp"])``, the Llama's
  stages from ``LlamaForCausalLM.pipeline_stages``, each rank on its
  heads, MLP columns and vocabulary rows, the loss ``ParallelCrossEntropy``
  on the head's vocabulary columns): (b) the step check at
  ``PIPE_CHECK_LAYERS`` layers, batch ``HY_M`` x ``--check-seq``, for each
  of ``HY_STYLES`` (1F1B with sequence parallelism and
  ``activation_spec``, without them, and vpp at 2 chunks with them): the
  loss and every leaf's gradient of ``forward_backward_pipeline``
  against a one-process traced backward of the whole batch on the same
  card within ``GRAD_TOL`` of the leaf's largest entry: each rank runs
  that backward itself (the ranks one after the other) and holds its
  slices against the same slices of it, the largest differences gathered
  to rank 0; for the first style rank 0 also holds the tree gathered over
  pipe and tensor by ``gather_pipeline_tree``; two planted
  faults refused by that check (the gradients partial over the tensor
  axis, the norms under sequence parallelism, left unsummed; stage 1
  taking the sequence shards that stage 0's other tensor rank sent); (a)
  the timed cell: ``--layers`` layers, batch ``HY_M`` x ``--seq / HY_M``
  in ``HY_M`` microbatches under 1F1B with sequence parallelism and
  ``activation_spec``, ``train_batch`` with ``AdamW(3e-4,
  weight_decay=0.1)``: a warm-up, ``--steps`` timed steps (the host's
  transport included) and one profiled step, with exact launches and the
  transfers by kind; (c) pp 2 x sharding 2 through fleet (sharding stage
  1) at ``HY_SHARD_LAYERS`` layers: the same gradient check, and one
  ``train_batch`` step's optimizer state on the rank against the stage's
  whole state.

- ``--phase s`` (two or four ranks on one card, gloo; context parallelism
  across processes, the Llama's ``context_parallel`` over
  ``ProcessMesh([2], ["sep"])``, or at four ranks ``ProcessMesh([2, 2],
  ["sep", "mp"])``, through ``parallelize`` and ``TrainStep``: each rank
  keeps its half of the sequence, the loss is the global token mean, the
  gradients are summed over sep): (b, c at four ranks) the step check at
  ``--check-layers`` layers, batch 1 x ``--check-seq``: for the ring, for
  Ulysses and for a planted fault (the ring with RoPE at every rank's
  positions from 0, ``models.llama._rope_offset``), the loss and every
  leaf's reduced gradient (this rank's slices beside the tensor axis)
  against a one-process traced backward of the whole batch on the card,
  each rank holding its own; (a, two ranks) the ring across processes
  against the one-process ring at the cell's layer shapes, bit for bit,
  then the timed cell: ``--layers`` layers, batch 1 x ``--seq`` (each rank
  on ``--seq / 2`` positions), the ring, AdamW with the clip: a warm-up,
  ``--steps`` timed steps (the host's transport included) and one
  profiled step, with exact launches (``sep_expected``) and the
  collectives by kind and bytes.

- ``--phase e`` (two ranks on one card, gloo; expert parallelism, an MoE
  Llama at Mixtral-8x7B's widths (``MIXTRAL``, ``EP_LAYERS`` layers),
  loss the cross entropy plus 0.02 x the layers' aux, through
  ``PartitionedTrainStep``): the step checks (``ep_check``), each rank's
  reduced gradients (its slices) against a one-process traced backward of
  the whole batch on the card within ``GRAD_TOL``: (29a's check) the
  experts over dp (``build_program_mesh(dp=2)``: the all-to-all), a global
  batch of 2 x ``--seq / 2`` (a row a rank); (29c) the same at capacity factor
  ``EP_FAULT_CF`` and 2 x ``--check-seq``, with the planted fault of
  every rank routing its rows alone, which the check must refuse; (29b)
  the experts over tensor (``build_program_mesh(tensor=2)``: partial
  sums, the attention cut by heads), 1 x ``--check-seq`` on both ranks;
  then (29a) the timed cell at dp 2, a global batch of 2 x ``--seq / 2``: a
  warm-up, ``--steps`` timed steps (the host's transport included) and
  one profiled step, with exact launches (``ep_expected``), the
  collectives' calls and bytes, the all-to-all's rows and the global
  batch's kept choices.

``--tiny`` runs ``LlamaConfig.tiny()`` widths with head_dim 64 (the card
tests).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

LR = 3e-4
# Phase b's gradient check: max |g - g_ref| / max |g_ref| for each leaf.
# Both are bf16 sums of the same per-token terms, rounded in different
# places (two half-batch partials each rounded to bf16, summed in f32,
# halved and rounded again, against one rounding of the whole-batch sum),
# and the two runs' activations differ by bf16 roundings of their own, so
# an entry differs by a few units of bf16's roundoff (2^-9 relative) of
# the leaf's largest; 2^-5 is 16 of them. The planted faults miss by
# about half the leaf's largest or more.
GRAD_TOL = 2.0 ** -5
# the numerics sentinels' grad norm of a sharded step against the norm of
# the one-process gradients: the entries differ by a few bf16 roundings
# (see GRAD_TOL), which a norm over millions of them averages down; 2^-7
# is four of bf16's roundoff units relative
SENTINEL_NORM_TOL = 2.0 ** -7


def say(phase, **nums):
    print(f"[dist-{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


def counters():
    """{name: (dict, key)}: where each kernel's launches are counted."""
    from ..ops import flash_attention as fa
    from ..ops import fused_norm as fn
    from ..ops import fused_optimizer as fo

    return {"flash_wgmma_fwd": (fa.flash_attention_fwd.by_route, "wgmma"),
            "flash_wgmma_bwd": (fa.flash_attention_bwd.by_route, "wgmma"),
            **{f"{n}_{m}": (w.by_mode, m) for m in ("fused", "round_first")
               for n, w in (("rms_norm_fwd", fn.rms_norm_fwd),
                            ("rms_norm_bwd_dx", fn.rms_norm_bwd_dx))},
            "multi_tensor_update": (vars(fo.multi_tensor_update), "launches")}


def read(c):
    return {k: d[key] for k, (d, key) in c.items()}


def zero(c):
    for d, key in c.values():
        d[key] = 0


def config(args, layers):
    from ..models.llama import LlamaConfig

    if args.tiny:      # head_dim 64: flash's wgmma route
        return LlamaConfig.tiny(num_hidden_layers=layers, num_attention_heads=4,
                                num_key_value_heads=2)
    return LlamaConfig.llama3_8b(num_hidden_layers=layers)


def build(args, layers, **overrides):
    import torch

    from ..models.llama import LlamaForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    cfg = config(args, layers)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, opt


def tokens(seed, rows, seq, vocab):
    import numpy as np
    import torch

    toks = np.random.RandomState(seed).randint(0, vocab, (rows, seq + 1)).astype("int64")
    t = torch.from_numpy(toks).cuda()
    return t[:, :-1], t[:, 1:]


def loss_fn(model):
    return lambda ids, labels: model(ids, labels=labels)[0]


def checksum(t) -> int:
    """An exact checksum of ``t``'s bits (position-weighted)."""
    import torch

    words = t.detach().reshape(-1).view(torch.int16).to(torch.int64)
    weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return int((words * weights).sum())


def phase_a(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective
    from ..jit import TrainStep

    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sep_degree": 1}
    dist.fleet.init(is_collective=True, strategy=strategy)
    res = {"backend": dist.env.backend(), "world": dist.get_world_size()}
    # the step-check cell: the sharded step against a plain TrainStep
    cfg = config(args, args.check_layers)
    ids, labels = tokens(args.seed + 2, 1, args.check_seq, cfg.vocab_size)
    plain, popt = build(args, args.check_layers)
    want = TrainStep(plain, popt, loss_fn(plain))(ids, labels)
    model, opt = build(args, args.check_layers)
    model, opt = dist.fleet.group_sharded_parallel(model, opt, level="p_g_os")
    got = TrainStep(model, opt, loss_fn(model))(ids, labels)
    torch.cuda.synchronize()
    pw = dict(plain.named_parameters())
    diffs = {n: (p.detach().float() - pw[n].detach().float()).abs().max().item()
             for n, p in model.named_parameters()}
    res.update(check_loss=got.item(), check_loss_plain=want.item(),
               check_params=len(diffs), check_params_equal=sum(d == 0 for d in diffs.values()),
               check_max_abs_diff=max(diffs.values()))
    say("a", **{k: v for k, v in res.items()})
    if got.item() != want.item() or res["check_params_equal"] != len(diffs):
        raise AssertionError(f"the sharded step differs from TrainStep: loss {got.item()} vs "
                             f"{want.item()}, parameters {diffs}")
    del plain, popt, model, opt, pw
    torch.cuda.empty_cache()
    # the timed cell: phase 7's
    torch.cuda.reset_peak_memory_stats()
    cfg = config(args, args.layers)
    model, opt = build(args, args.layers)
    model, opt = dist.fleet.group_sharded_parallel(model, opt, level="p_g_os")
    step = TrainStep(model, opt, loss_fn(model))
    c = counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, 1, args.seq, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, 1, args.seq, cfg.vocab_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    res.update(layers=args.layers, seq=args.seq, warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches,
               collectives_per_step={k: v / n for k, v in stats["calls"].items()},
               collective_bytes_per_step={k: v / n for k, v in stats["bytes"].items()},
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured")
    say("a", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if not k.startswith("check")})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    return res


def grad_errors(got, want) -> dict:
    """{leaf: max |got - want| / max |want|}."""
    out = {}
    for n, w in want.items():
        w = w.detach().float()
        scale = w.abs().max().item()
        out[n] = (got[n].detach().float() - w).abs().max().item() / (scale or 1.0)
    return out


def phase_b(args, out):
    import torch

    from .. import distributed as dist
    from ..jit import TrainStep

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = config(args, args.check_layers)
    ids, labels = tokens(args.seed + 2, world, args.check_seq, cfg.vocab_size)
    model, opt = build(args, args.check_layers)
    model = dist.DataParallel(model, comm_buffer_size=args.comm_buffer_size)
    c = counters()
    torch.cuda.synchronize()
    zero(c)
    loss = model(ids[rank:rank + 1], labels=labels[rank:rank + 1])[0]
    loss.backward()
    grads = {n: checksum(p.grad) for n, p in model._layers.named_parameters()}
    held = ({n: p.grad.detach().clone() for n, p in model._layers.named_parameters()}
            if rank == 0 else None)
    opt.step()
    torch.cuda.synchronize()
    launches = read(c)
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device()), "loss": loss.item(),
           "comm_buffer_size_mb": args.comm_buffer_size, "buckets": model.bucket_stats(),
           "grad_checksums": grads, "launches": launches,
           "param_checksums": {n: checksum(p) for n, p in model._layers.named_parameters()}}
    say("b", rank=rank, device=res["device"], loss=res["loss"],
        buckets=json.dumps(res["buckets"]), comm_buffer_size_mb=args.comm_buffer_size,
        launches=json.dumps(launches))
    if rank == 0:
        ref, _ = build(args, args.check_layers)
        ref(ids, labels=labels)[0].backward()
        want = {n: p.grad for n, p in ref.named_parameters()}
        errs = grad_errors(held, want)
        local = dict(ref.named_parameters())
        for p in local.values():
            p.grad = None
        ref(ids[:1], labels=labels[:1])[0].backward()
        faults = {"no_division": max(grad_errors({n: 2 * g for n, g in held.items()},
                                                 want).values()),
                  "no_reduce": max(grad_errors({n: p.grad for n, p in local.items()},
                                               want).values())}
        worst = max(errs, key=errs.get)
        res.update(grad_vs_ref_max_rel=errs[worst], grad_vs_ref_worst_leaf=worst,
                   grad_vs_ref_tol=GRAD_TOL, grad_vs_ref_beyond_tol=sum(
                       e > GRAD_TOL for e in errs.values()),
                   planted_faults_max_rel=faults)
        say("b", grad_vs_ref_max_rel=errs[worst], grad_vs_ref_worst_leaf=worst,
            grad_vs_ref_tol=GRAD_TOL, planted_faults_max_rel=json.dumps(faults))
        if res["grad_vs_ref_beyond_tol"]:
            raise AssertionError("the reduced gradients differ from the one-process backward "
                                 f"on the whole batch beyond {GRAD_TOL} of a leaf's largest: "
                                 f"{ {n: e for n, e in errs.items() if e > GRAD_TOL} }")
        caught = [k for k, e in faults.items() if e > GRAD_TOL]
        if len(caught) != len(faults):
            raise AssertionError(f"the gradient check does not tell the planted faults apart: "
                                 f"{faults} against {GRAD_TOL}")
        del ref, want, local, held
        torch.cuda.empty_cache()
        ref, ropt = build(args, args.check_layers)
        TrainStep(ref, ropt, loss_fn(ref))(ids, labels)
        torch.cuda.synchronize()
        rp = dict(ref.named_parameters())
        worst, beyond = 0.0, 0
        for n, p in model._layers.named_parameters():
            d = (p.detach().float() - rp[n].detach().float()).abs()
            tol = 2 * LR + rp[n].detach().float().abs() * 2.0 ** -8
            worst = max(worst, d.max().item())
            beyond += int((d > tol).sum())
        res.update(vs_trainstep_max_abs_diff=worst, vs_trainstep_beyond_tol=beyond,
                   vs_trainstep_tol="2 lr + |p| 2^-8")
        say("b", vs_trainstep_max_abs_diff=worst, vs_trainstep_beyond_tol=beyond)
        if beyond:
            raise AssertionError(f"{beyond} parameters differ from the one-process TrainStep "
                                 "by more than 2 lr + one bf16 rounding")
    dist.barrier()
    return res


def tensor_step(args, layers, **overrides):
    """(model, PartitionedTrainStep) over the tensor axis of the world."""
    from .. import distributed as dist
    from ..distributed.partitioning import PartitionedTrainStep, Partitioner

    model, opt = build(args, layers, **overrides)
    mesh = dist.build_program_mesh(tensor=dist.get_world_size())
    return model, PartitionedTrainStep(model, opt, loss_fn(model),
                                       partitioner=Partitioner(mesh))


def reduced_grads(step, ids, labels) -> tuple:
    """(loss, {leaf: (this rank's slice of its gradient, the slice's index
    in the whole)}) of one batch through the step's own backward and
    reductions."""
    from ..distributed import _sharded

    params = step._params()
    loss, grads = step._loss_and_grads(params, (ids, labels))
    grads = step.optimizer._update._reduce([p for _, p in params], grads)
    out = {}
    for (n, p), g in zip(params, grads):
        info = _sharded.info_of(p)
        out[n] = (g, info.held_index if info is not None else tuple(slice(None) for _ in g.shape))
    return loss, out


def sliced_grad_errors(got, want) -> dict:
    """{leaf: max |g - g_ref| / max |g_ref|} over the whole leaf: each rank
    holds its slice (``reduced_grads``) against the same slice of the
    one-process gradient, and the ranks' largest differences are
    gathered."""
    from .. import distributed as dist

    local = {n: (g.float() - want[n][idx].float()).abs().max().item()
             for n, (g, idx) in got.items()}
    every = []
    dist.all_gather_object(every, local)
    return {n: max(e[n] for e in every) / (want[n].float().abs().max().item() or 1.0)
            for n in want}


def semi_auto_check() -> dict:
    """(25c) shard_tensor -> reshard(Replicate) on CUDA tensors over the
    world's one axis, and the gradient through shard_tensor."""
    import torch

    from .. import distributed as dist

    n = dist.get_world_size()
    mesh = dist.ProcessMesh(shape=[n], dim_names=["mp"])
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(8 * n * 4, device="cuda").reshape(8 * n, 4).to(dtype)
        xs = dist.shard_tensor(x, mesh, [dist.Shard(0)])
        xr = dist.reshard(xs, mesh, [dist.Replicate()])
        out[f"round_trip_equal_{str(dtype)[6:]}"] = bool(torch.equal(xr, x)) and \
            xs.shape[0] == 8 and xs.device == x.device
    y = torch.ones(8 * n, 4, device="cuda", requires_grad=True)
    dist.shard_tensor(y, mesh, [dist.Shard(0)]).sum().backward()
    out["grad_all_ones"] = bool(torch.equal(y.grad, torch.ones_like(y)))
    if not all(out.values()):
        raise AssertionError(f"phase 25c: the semi-auto API on the card: {out}")
    return out


def sentinel_check(step, ids, labels, want_grads) -> dict:
    """One call of ``step`` with its numerics fold captured: the published
    loss, grad norm, digest and nonfinite count must be the same on every
    rank (the sentinels read the reduced gradients and fold their
    statistics over the ranks), and the grad norm that of the one-process
    gradients ``want_grads`` within SENTINEL_NORM_TOL."""
    import torch

    from .. import distributed as dist
    from ..profiler import numerics

    seen, publish = [], numerics.publish

    def capture(sent, loss=None):
        seen.append({"grad_norm": sent["grad_norm"], "digest": sent["digest"],
                     "nonfinite": sent["nonfinite"], "loss": loss})
        publish(sent, loss=loss)

    numerics.publish = capture
    try:
        step(ids, labels)
    finally:
        numerics.publish = publish
    torch.cuda.synchronize()
    every = []
    dist.all_gather_object(every, seen)
    plain = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in want_grads.values())).item()
    got = seen[0]["grad_norm"] if len(seen) == 1 else None
    rel = abs(got - plain) / plain if got is not None else None
    if len(seen) != 1 or any(e != seen for e in every) or seen[0]["nonfinite"] \
            or not rel <= SENTINEL_NORM_TOL:
        raise AssertionError(f"the sentinels of a partitioned step: every rank's {every}, "
                             f"the one-process grad norm {plain}")
    return {"sentinel_grad_norm": got, "sentinel_plain_norm": plain,
            "sentinel_norm_rel": rel, "sentinel_digest": seen[0]["digest"],
            "sentinel_ranks_agree": True}


def step_check(args, ids, labels, want, sequence_parallel: bool) -> dict:
    """(25b) at the step-check cell: the reduced gradients against the
    one-process ``want``, the planted faults (without sequence
    parallelism), one step with its numerics sentinels held
    (:func:`sentinel_check`), and the checksums of the uncut parameters."""
    import torch

    from ..distributed import _sharded
    from ..distributed import tensor_parallel as tp

    model, step = tensor_step(args, args.check_layers, sequence_parallel=sequence_parallel)
    loss, got = reduced_grads(step, ids, labels)
    errs = sliced_grad_errors(got, want["grads"])
    worst = max(errs, key=errs.get)
    res = {"loss": loss.item(), "loss_plain": want["loss"], "grad_vs_ref_max_rel": errs[worst],
           "grad_vs_ref_worst_leaf": worst, "grad_vs_ref_tol": GRAD_TOL,
           "grad_vs_ref_beyond_tol": sum(e > GRAD_TOL for e in errs.values()),
           "leaves": len(errs)}
    del got
    if not sequence_parallel:
        faults = {}
        keep = tp.reduce_from, tp.copy_to
        for name, attr in (("row_without_allreduce", "reduce_from"),
                           ("column_backward_without_allreduce", "copy_to")):
            setattr(tp, attr, lambda x, group: x)
            try:
                _, bad = reduced_grads(step, ids, labels)
            finally:
                tp.reduce_from, tp.copy_to = keep
            faults[name] = max(sliced_grad_errors(bad, want["grads"]).values())
            del bad
        res["planted_faults_max_rel"] = faults
    torch.cuda.empty_cache()
    res.update(sentinel_check(step, ids, labels, want["grads"]))
    res["uncut_checksums"] = {n: checksum(p) for n, p in model.named_parameters()
                              if (_sharded.info_of(p) is None
                                  or _sharded.info_of(p).tdim is None)}
    res["cut"] = sum(1 for p in model.parameters()
                     if _sharded.info_of(p) is not None and _sharded.info_of(p).tdim is not None)
    del model, step
    torch.cuda.empty_cache()
    return res


def phase_t(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective

    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device())}
    res["semi_auto"] = semi_auto_check()
    say("t", rank=rank, semi_auto=json.dumps(res["semi_auto"]))
    # (25b) the step check, against one process's TrainStep backward (each
    # rank makes it, and holds its slices against it)
    from ..jit import TrainStep

    cfg = config(args, args.check_layers)
    ids, labels = tokens(args.seed + 2, 1, args.check_seq, cfg.vocab_size)
    plain, popt = build(args, args.check_layers)
    ref = TrainStep(plain, popt, loss_fn(plain))
    loss, grads = ref._loss_and_grads(ref._params(), (ids, labels))
    want = {"loss": loss.item(), "grads": {n: g for (n, _), g in zip(ref._params(), grads)}}
    del plain, popt, ref, grads
    for sp in (False, True):
        key = "check_sp" if sp else "check"
        res[key] = step_check(args, ids, labels, want, sp)
        say("t", rank=rank, case=key, **{k: json.dumps(v) if isinstance(v, dict) else v
                                          for k, v in res[key].items()
                                          if k != "uncut_checksums"})
        r = res[key]
        if r["grad_vs_ref_beyond_tol"]:
            raise AssertionError(f"phase 25b ({key}): {r['grad_vs_ref_beyond_tol']} leaves "
                                 f"differ from the one-process backward beyond {GRAD_TOL} of "
                                 f"their largest (worst {r['grad_vs_ref_worst_leaf']}: "
                                 f"{r['grad_vs_ref_max_rel']})")
        faults = r.get("planted_faults_max_rel", {})
        if any(e <= GRAD_TOL for e in faults.values()):
            raise AssertionError(f"phase 25b: the gradient check does not refuse the planted "
                                 f"faults: {faults}")
    del want
    torch.cuda.empty_cache()
    # (25a) the timed cell
    torch.cuda.reset_peak_memory_stats()
    cfg = config(args, args.layers)
    model, step = tensor_step(args, args.layers)
    c = counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, 1, args.seq, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, 1, args.seq, cfg.vocab_size)
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    res.update(layers=args.layers, seq=args.seq, warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches,
               collectives_per_step={k: v / n for k, v in stats["calls"].items()
                                     if k != "barrier"},
               collective_bytes_per_step={k: v / n for k, v in stats["bytes"].items()
                                          if k != "barrier"},
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               params_on_rank=sum(p.numel() for p in model.parameters()),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured")
    say("t", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if not k.startswith(("check", "semi"))})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    dist.barrier()
    return res


# ---------------------------------------------------------------------------
# phase p: the pipeline
# ---------------------------------------------------------------------------

PIPE = 2                # stages
PIPE_M = 4              # microbatches of the timed cell and the step check
PIPE_CHECK_LAYERS = 4   # vpp at 2 stages x 2 chunks: one layer a chunk
PIPE_MEM_M = 8          # microbatches of the memory bound
#: (schedule, microbatches, chunks) of the step check
PIPE_STYLES = (("1f1b", 4, 1), ("fthenb", 2, 1), ("zero_bubble", 4, 1), ("vpp", 4, 2))


def llama_loss(logits, labels):
    from ..nn import functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           reduction="mean")


def tree_by_name(tree, num_chunks: int) -> dict:
    """{the model's parameter name: gradient} of a reassembled pipeline tree."""
    out = {"llama.embed_tokens.weight": tree["first"]["embed_tokens.weight"],
           "llama.norm.weight": tree["last"]["norm.weight"],
           "lm_head.weight": tree["last"]["lm_head.weight"]}
    for k, leaf in tree["stack"].items():
        P = leaf.shape[0]
        for p in range(P):
            chunks = [leaf[p]] if num_chunks == 1 else list(leaf[p])
            for v, chunk in enumerate(chunks):
                for j in range(chunk.shape[0]):
                    out[f"llama.layers.{(v * P + p) * chunk.shape[0] + j}.{k}"] = chunk[j]
    return out


def pipe_check(args, mesh) -> dict:
    """(26b): see the module docstring."""
    import torch

    from .. import distributed as dist
    from .. import tracing
    from ..distributed.fleet import PipelineParallel, gather_pipeline_tree
    from ..distributed.fleet import pipeline_parallel as ppmod

    rank = dist.get_rank()
    cfg = config(args, PIPE_CHECK_LAYERS)
    ids, labels = tokens(args.seed + 2, PIPE_M, args.check_seq, cfg.vocab_size)
    model, _ = build(args, PIPE_CHECK_LAYERS)
    want = None
    if rank == 0:
        named = list(model.named_parameters())
        with tracing.traced():
            loss = model(ids, labels=labels)[0].float()
            grads = torch.autograd.grad(loss, [q for _, q in named])
        want = {"loss": loss.item(), "grads": {n: g for (n, _), g in zip(named, grads)}}
        del loss, grads
    first, layers, last = model.pipeline_stages()

    def run(style, m, chunks):
        pp = PipelineParallel(first, layers, last, llama_loss, mesh=mesh, num_microbatches=m,
                              schedule=style, num_chunks=chunks)
        loss, grads = pp.forward_backward_pipeline(ids, labels)
        tree = gather_pipeline_tree(grads, pp)
        del grads
        got = tree_by_name(tree, chunks) if rank == 0 else None
        return loss.item(), got, pp.peak_in_flight, pp._sched.ring

    res = {}
    for style, m, chunks in PIPE_STYLES:
        loss, got, peak, ring = run(style, m, chunks)
        r = {"loss": loss, "microbatches": m, "chunks": chunks, "peak_in_flight": peak,
             "ring": ring}
        if rank == 0:
            errs = grad_errors(got, want["grads"])
            worst = max(errs, key=errs.get)
            r.update(loss_plain=want["loss"], leaves=len(errs), grad_vs_ref_max_rel=errs[worst],
                     grad_vs_ref_worst_leaf=worst, grad_vs_ref_tol=GRAD_TOL,
                     grad_vs_ref_beyond_tol=sum(e > GRAD_TOL for e in errs.values()),
                     leaves_checked=sorted(got) == sorted(want["grads"]))
        del got
        torch.cuda.empty_cache()
        res[style] = r
        say("p", rank=rank, case=f"check_{style}", **{k: v for k, v in r.items()})
    faults = {}
    keep = ppmod._loss_seed, ppmod._graph_of
    planted = {"seed_one_not_one_over_m": ("_loss_seed", lambda M: 1.0),
               "stage0_cotangents_swapped": (
                   "_graph_of", lambda v, m: (1 - m) if (rank == 0 and v == 0 and m < 2) else m)}
    for name, (attr, fn) in planted.items():
        setattr(ppmod, attr, fn)
        try:
            _, got, _, _ = run("1f1b", PIPE_M, 1)
        finally:
            ppmod._loss_seed, ppmod._graph_of = keep
        if rank == 0:
            faults[name] = max(grad_errors(got, want["grads"]).values())
        del got
        torch.cuda.empty_cache()
    if rank == 0:
        res["planted_faults_max_rel"] = faults
        say("p", rank=rank, planted_faults_max_rel=json.dumps(faults))
    del model, first, layers, last, want
    torch.cuda.empty_cache()
    return res


def pipe_memory(args, mesh, first, layers, last, vocab) -> dict:
    """(26c): each stage's peak memory above its resting state over one
    pass of the schedule under fthenb and 1f1b."""
    import gc

    import torch

    from ..distributed.fleet import PipelineParallel

    ids, labels = tokens(args.seed + 50, PIPE_MEM_M, args.seq // PIPE_MEM_M, vocab)
    out = {}
    for style in ("fthenb", "1f1b"):
        pp = PipelineParallel(first, layers, last, llama_loss, mesh=mesh,
                              num_microbatches=PIPE_MEM_M, schedule=style)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resting = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pp._forward_backward(ids, labels)
        torch.cuda.synchronize()
        out[style] = {"peak_above_rest_gib": round((torch.cuda.max_memory_allocated() - resting)
                                                   / 2**30, 4),
                      "resting_gib": round(resting / 2**30, 4),
                      "peak_in_flight": pp.peak_in_flight, "ring": pp._sched.ring}
        del pp
    return out


def phase_p(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective
    from ..distributed.fleet import PipelineParallel
    from ..models.llama import LlamaForCausalLM
    from ..optimizer import AdamW

    dist.init_parallel_env(timeout=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != PIPE:
        raise ValueError(f"phase p runs {PIPE} ranks, got {world}")
    mesh = dist.ProcessMesh(shape=[PIPE], dim_names=["pp"])
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device())}
    res["check"] = pipe_check(args, mesh)
    if rank == 0:
        bad = {k: v["grad_vs_ref_max_rel"] for k, v in res["check"].items()
               if k in dict((s[0], 1) for s in PIPE_STYLES) and v["grad_vs_ref_beyond_tol"]}
        if bad:
            raise AssertionError(f"phase 26b: the pipeline's gradients differ from the "
                                 f"one-process backward beyond {GRAD_TOL} of a leaf's largest: "
                                 f"{bad}")
        faults = res["check"]["planted_faults_max_rel"]
        if any(e <= GRAD_TOL for e in faults.values()):
            raise AssertionError(f"phase 26b: the gradient check does not refuse the planted "
                                 f"faults: {faults}")
    cfg = config(args, args.layers)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    first, layers, last = model.pipeline_stages()
    res["memory"] = pipe_memory(args, mesh, first, layers, last, cfg.vocab_size)
    say("p", rank=rank, memory=json.dumps(res["memory"]))
    # (26a) the timed cell
    pp = PipelineParallel(first, layers, last, llama_loss, mesh=mesh, num_microbatches=PIPE_M,
                          schedule="1f1b")
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, PIPE_M, args.seq // PIPE_M, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pp.train_batch((ids, labels), opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, PIPE_M, args.seq // PIPE_M, cfg.vocab_size)
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pp.train_batch((ids, labels), opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    res.update(layers=args.layers, seq=args.seq, microbatches=PIPE_M, schedule="1f1b",
               stage_layers=len(pp.chunks[0]), warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches,
               transfers_per_step={k: v / n for k, v in stats["calls"].items()
                                   if k != "barrier"},
               transfer_bytes_per_step={k: v / n for k, v in stats["bytes"].items()
                                        if k != "barrier"},
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               params_on_rank=sum(q.numel() for _, _, q in pp._owned()),
               tensors_on_rank=len(pp._owned()),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured")
    say("p", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if k not in ("check", "memory")})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    dist.barrier()
    return res


# ---------------------------------------------------------------------------
# phase h: hybrid parallelism
# ---------------------------------------------------------------------------

HYBRID = 4              # ranks: pp 2 x tensor 2
HY_M = 4                # microbatches of the timed cell and the step check
HY_SPEC = ("dp", "mp")  # activation_spec: the sequence over the tensor axis
#: (schedule, microbatches, chunks, activation_spec with sequence parallelism) of the check
HY_STYLES = (("1f1b", 4, 1, True), ("1f1b", 4, 1, False), ("vpp", 4, 2, True))
HY_SHARD_LAYERS = 2     # 27c's depth
HY_SHARD_M = 2          # 27c: each sharding replica's 2 rows in 2 microbatches


def hybrid_mesh():
    from .. import distributed as dist

    return dist.ProcessMesh(shape=[2, 2], dim_names=["pp", "mp"])


def hybrid_pipeline(args, layers, style, m, chunks, spec, mesh):
    """(model, PipelineParallel) of a fresh Llama over ``mesh``, its stages
    from ``pipeline_stages``, ParallelCrossEntropy on the head's
    vocabulary columns; ``spec``: sequence parallelism and
    activation_spec."""
    from ..distributed.fleet import ParallelCrossEntropy, PipelineParallel

    model, _ = build(args, layers, sequence_parallel=spec)
    first, lyrs, last = model.pipeline_stages()
    pp = PipelineParallel(first, lyrs, last, ParallelCrossEntropy(), mesh=mesh,
                          num_microbatches=m, schedule=style, num_chunks=chunks,
                          activation_spec=HY_SPEC if spec else None)
    return model, pp


def one_process(args, layers, ids, labels) -> dict:
    """The loss and every gradient of a one-process traced backward of the
    whole batch on the card (the reference of the step checks), on every
    rank, one rank after the other (each holds its own: the ranks compare
    their slices without moving gradients)."""
    import torch

    from .. import distributed as dist
    from .. import tracing

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            model, _ = build(args, layers)
            named = list(model.named_parameters())
            with tracing.traced():
                loss = model(ids, labels=labels)[0].float()
                grads = torch.autograd.grad(loss, [q for _, q in named])
            out = {"loss": loss.item(), "grads": {n: g for (n, _), g in zip(named, grads)}}
            del model, loss, named, grads
            torch.cuda.empty_cache()
        dist.barrier()
    return out


class wrong_peer:
    """A planted fault: stage 1 takes the activation shards that stage 0's
    other tensor rank sent (``StageLink.exchange`` swapped over the tensor
    group for the block)."""

    def __init__(self, pp):
        self.group = pp.link.tensor_group

    def __enter__(self):
        from ..distributed import tensor_parallel as tp
        from ..distributed.fleet import _pipe_p2p

        self.keep = keep = _pipe_p2p.StageLink.exchange
        group = self.group

        def exchange(link, sends, recvs):
            got = keep(link, sends, recvs)
            if link.stage == 1:
                got = [tp.gather_dim(t[None], 0, group)[1 - group.rank] for t in got]
            return got

        _pipe_p2p.StageLink.exchange = exchange
        return self

    def __exit__(self, *exc):
        from ..distributed.fleet import _pipe_p2p

        _pipe_p2p.StageLink.exchange = self.keep
        return False


def hybrid_grads(args, model, pp, ids, labels, chunks, want, plant=None,
                 gather=False) -> tuple:
    """(loss, {leaf: max |g - g_ref| / max |g_ref|} on rank 0) of one
    forward_backward_pipeline: every rank holds its gradients (its tensor
    slices) against the same slices of its own ``want``, and the ranks'
    largest differences are gathered; with ``gather`` rank 0 also holds the
    tree gathered over pipe and tensor by ``gather_pipeline_tree``, and
    each leaf's error is the larger of the two. ``plant`` a fault:
    ``unsummed`` (the gradients partial over the tensor axis left
    unsummed) or ``wrong_peer``."""
    import contextlib

    import torch

    from .. import distributed as dist
    from ..distributed import _sharded
    from ..distributed.fleet import gather_pipeline_tree

    if plant == "unsummed":
        pp._partial = set()
    with wrong_peer(pp) if plant == "wrong_peer" else contextlib.nullcontext():
        loss, got = pp._forward_backward(ids, labels)
    names = {id(q): n for n, q in model.named_parameters()}
    local = {}
    for _, _, q, g in got:
        info = _sharded.info_of(q)
        w = want["grads"][names[id(q)]]
        w = w[info.held_index] if info is not None else w
        local[names[id(q)]] = (g.float() - w.float()).abs().max().item()
    every = []
    dist.all_gather_object(every, local)
    errs = None
    if dist.get_rank() == 0:
        scale = {n: w.float().abs().max().item() or 1.0 for n, w in want["grads"].items()}
        errs = {n: max(e[n] for e in every if n in e) / scale[n] for n in want["grads"]
                if any(n in e for e in every)}
    if gather:
        tree = gather_pipeline_tree(pp._tree({(part, key): g for part, key, _, g in got}), pp)
        if dist.get_rank() == 0:
            whole = tree_by_name(tree, chunks)
            for n, g in whole.items():
                e = (g.float() - want["grads"][n].float()).abs().max().item() / scale[n]
                errs[n] = max(errs.get(n, 0.0), e)
            errs["gathered_leaves"] = len(whole)
        del tree
    del got
    torch.cuda.empty_cache()
    return loss.item(), errs


def hybrid_check(args, mesh) -> dict:
    """(27b): see the module docstring."""
    import torch

    from .. import distributed as dist

    rank = dist.get_rank()
    cfg = config(args, PIPE_CHECK_LAYERS)
    ids, labels = tokens(args.seed + 2, HY_M, args.check_seq, cfg.vocab_size)
    t0 = time.perf_counter()
    want = one_process(args, PIPE_CHECK_LAYERS, ids, labels)
    res = {"one_process_s": round(time.perf_counter() - t0, 1)}
    runs = [s + (None,) for s in HY_STYLES] + [("1f1b", HY_M, 1, True, plant)
                                               for plant in ("unsummed", "wrong_peer")]
    for k, (style, m, chunks, spec, plant) in enumerate(runs):
        t0 = time.perf_counter()
        model, pp = hybrid_pipeline(args, PIPE_CHECK_LAYERS, style, m, chunks, spec, mesh)
        loss, errs = hybrid_grads(args, model, pp, ids, labels, chunks, want, plant,
                                  gather=k == 0)
        name = f"{style}_spec{int(spec)}" + (f"_{plant}" if plant else "")
        r = {"loss": loss, "schedule": style, "microbatches": m, "chunks": chunks,
             "activation_spec": spec, "sequence_parallel": spec,
             "tree_gathered": k == 0, "seconds": round(time.perf_counter() - t0, 1)}
        if rank == 0:
            gathered = errs.pop("gathered_leaves", None)
            worst = max(errs, key=errs.get) if errs else None
            r.update(loss_plain=want["loss"], leaves=len(errs), gathered_leaves=gathered,
                     leaves_checked=len(errs) == len(want["grads"]),
                     grad_vs_ref_max_rel=errs[worst] if errs else None,
                     grad_vs_ref_worst_leaf=worst, grad_vs_ref_tol=GRAD_TOL,
                     grad_vs_ref_beyond_tol=sum(e > GRAD_TOL for e in errs.values()))
        res[name] = r
        say("h", rank=rank, case=f"check_{name}", **r)
        del model, pp
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    return res


def hybrid_shard(args) -> dict:
    """(27c) pp 2 x sharding 2 through fleet (sharding stage 1) at
    ``HY_SHARD_LAYERS`` layers: the gradient check of
    forward_backward_pipeline (each sharding replica on its half of the
    batch), then one train_batch step: the optimizer state on the rank
    against the same stage's whole state (AdamW's two moments)."""
    import torch

    from .. import distributed as dist
    from ..distributed.fleet import (DistributedStrategy, ParallelCrossEntropy,
                                     PipelineParallel)
    from ..optimizer import AdamW

    rank = dist.get_rank()
    cfg = config(args, HY_SHARD_LAYERS)
    ids, labels = tokens(args.seed + 4, HY_M, args.check_seq, cfg.vocab_size)
    t0 = time.perf_counter()
    want = one_process(args, HY_SHARD_LAYERS, ids, labels)
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2,
                               "sharding_degree": 2, "sep_degree": 1}
    strategy.sharding_configs = {"stage": 1}
    dist.fleet.init(is_collective=True, strategy=strategy)
    model, _ = build(args, HY_SHARD_LAYERS)
    first, lyrs, last = model.pipeline_stages()
    pp = PipelineParallel(first, lyrs, last, ParallelCrossEntropy(), mesh=dist.get_mesh(),
                          num_microbatches=HY_SHARD_M)
    loss, errs = hybrid_grads(args, model, pp, ids, labels, 1, want)
    held = sum(q.numel() for _, _, q in pp._owned())
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1)
    pp.train_batch((ids, labels), opt)
    torch.cuda.synchronize()
    state = sum(v.numel() for st in pp._update.states.values() for v in st.values()
                if torch.is_tensor(v))
    res = {"loss": loss, "params_on_rank": held, "state_numel": state,
           "pp2_state_numel": 2 * held, "state_ratio_to_pp2": state / (2 * held),
           "sharding_stage": pp._update.stage, "mode": dist.fleet.get_hybrid_communicate_group()
           .get_parallel_mode(), "seconds": round(time.perf_counter() - t0, 1)}
    if rank == 0:
        worst = max(errs, key=errs.get)
        res.update(loss_plain=want["loss"], leaves=len(errs),
                   leaves_checked=len(errs) == len(want["grads"]),
                   grad_vs_ref_max_rel=errs[worst], grad_vs_ref_worst_leaf=worst,
                   grad_vs_ref_tol=GRAD_TOL,
                   grad_vs_ref_beyond_tol=sum(e > GRAD_TOL for e in errs.values()))
    say("h", rank=rank, case="shard", **res)
    del model, pp, want
    torch.cuda.empty_cache()
    return res


def phase_h(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective
    from ..optimizer import AdamW

    dist.init_parallel_env(timeout=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != HYBRID:
        raise ValueError(f"phase h runs {HYBRID} ranks, got {world}")
    mesh = hybrid_mesh()
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device()), "coord": mesh.coordinate()}
    res["check"] = hybrid_check(args, mesh)
    # (27a) the timed cell
    t_a = time.perf_counter()
    cfg = config(args, args.layers)
    model, pp = hybrid_pipeline(args, args.layers, "1f1b", HY_M, 1, True, mesh)
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, HY_M, args.seq // HY_M, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pp.train_batch((ids, labels), opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, HY_M, args.seq // HY_M, cfg.vocab_size)
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pp.train_batch((ids, labels), opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    res.update(layers=args.layers, seq=args.seq, microbatches=HY_M, schedule="1f1b",
               activation_spec=list(HY_SPEC), stage=pp.stage,
               tensor_rank=pp.link.tensor_group.rank, stage_layers=len(pp.chunks[0]),
               warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches,
               transfers_per_step={k: v / n for k, v in stats["calls"].items()
                                   if k != "barrier"},
               transfer_bytes_per_step={k: v / n for k, v in stats["bytes"].items()
                                        if k != "barrier"},
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               params_on_rank=sum(q.numel() for _, _, q in pp._owned()),
               tensors_on_rank=len(pp._owned()),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured",
               seconds=round(time.perf_counter() - t_a, 1))
    say("h", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if k != "check"})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    del model, pp, opt
    torch.cuda.empty_cache()
    dist.barrier()
    res["shard"] = hybrid_shard(args)
    dist.barrier()
    return res


# ---------------------------------------------------------------------------
# phase s: context parallelism across processes
# ---------------------------------------------------------------------------

SEP = 2                 # ranks of the sep axis
SEP_TENSOR = 4          # 28c's ranks: sep 2 x tensor 2
#: (context_parallel, planted fault) of the step check
SEP_RUNS = (("ring", None), ("ulysses", None), ("ring", "no_offset"))


def sep_counters():
    """:func:`counters` and the ring's merge."""
    from ..ops import ring_flash as rf

    return {**counters(), "ring_merge": (vars(rf.ring_merge), "launches")}


def sep_expected(index: int, layers: int, steps: int) -> dict:
    """Launches on sep rank ``index`` of ``steps`` TrainStep calls of the
    ring at ``layers`` layers: flash forward and backward ``index + 1``
    times a layer (the visible steps of a causal ring), the merge ``index``
    times, RMSNorm's ``round_first`` mode 2 L + 1 each way on the rank's
    positions, one fused update a step."""
    norms = (2 * layers + 1) * steps
    return {"flash_wgmma_fwd": (index + 1) * layers * steps,
            "flash_wgmma_bwd": (index + 1) * layers * steps,
            "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
            "rms_norm_fwd_round_first": norms, "rms_norm_bwd_dx_round_first": norms,
            "multi_tensor_update": steps, "ring_merge": index * layers * steps}


def sep_bytes(cfg, seq: int, size: int, layers: int) -> int:
    """The ring's bytes sent a TrainStep call by one rank: K and V (bf16,
    grouped heads) P - 1 hops forward and P - 1 in the backward, the f32
    dK and dV accumulators P hops."""
    kv = (seq // size) * cfg.num_key_value_heads * (cfg.hidden_size // cfg.num_attention_heads)
    return layers * (2 * kv * 2 * (size - 1) * 2 + 2 * kv * 4 * size)


def sep_mesh(world: int):
    from .. import distributed as dist

    if world == SEP:
        return dist.ProcessMesh(shape=[SEP], dim_names=["sep"])
    return dist.ProcessMesh(shape=[SEP, world // SEP], dim_names=["sep", "mp"])


def sep_step(args, layers, cp, mesh):
    """(model, TrainStep) of a fresh Llama under ``context_parallel=cp``,
    parallelized over ``mesh`` (its tensor axis by ``mp_config``)."""
    from .. import distributed as dist
    from ..jit import TrainStep

    model, opt = build(args, layers, context_parallel=cp)
    config = {"mp_config": {}} if "mp" in mesh.dim_names else None
    model, opt = dist.parallelize(model, opt, mesh=mesh, config=config)
    return model, TrainStep(model, opt, loss_fn(model))


def sep_grads(step, ids, labels) -> tuple:
    """(loss, {leaf: (this rank's reduced gradient, its index in the
    whole)}) through the step's reductions: the model's ``reduce_gradients``
    (the sum over sep), or beside a tensor axis the sharded update's."""
    upd = getattr(step.optimizer, "_update", None)
    if upd is not None:
        return reduced_grads(step, ids, labels)
    params = step._params()
    loss, grads = step._loss_and_grads(params, (ids, labels))
    grads = step.model.reduce_gradients([p for _, p in params], grads)
    return loss, {n: (g, tuple(slice(None) for _ in g.shape))
                  for (n, _), g in zip(params, grads)}


def sep_check(args, mesh) -> dict:
    """(28b / 28c): see the module docstring."""
    import torch

    from .. import distributed as dist
    from ..models import llama as L

    rank = dist.get_rank()
    cfg = config(args, args.check_layers)
    ids, labels = tokens(args.seed + 2, 1, args.check_seq, cfg.vocab_size)
    want = one_process(args, args.check_layers, ids, labels)
    res = {}
    keep = L._rope_offset
    for cp, plant in SEP_RUNS:
        t0 = time.perf_counter()
        model, step = sep_step(args, args.check_layers, cp, mesh)
        if plant == "no_offset":
            L._rope_offset = lambda link, n: 0
        try:
            loss, got = sep_grads(step, ids, labels)
        finally:
            L._rope_offset = keep
        errs = sliced_grad_errors(got, want["grads"])
        worst = max(errs, key=errs.get)
        name = cp + (f"_{plant}" if plant else "")
        res[name] = {"loss": loss.item(), "loss_plain": want["loss"], "leaves": len(errs),
                     "leaves_checked": len(errs) == len(want["grads"]),
                     "grad_vs_ref_max_rel": errs[worst], "grad_vs_ref_worst_leaf": worst,
                     "grad_vs_ref_tol": GRAD_TOL,
                     "grad_vs_ref_beyond_tol": sum(e > GRAD_TOL for e in errs.values()),
                     "seconds": round(time.perf_counter() - t0, 1)}
        say("s", rank=rank, case=f"check_{name}", **res[name])
        del model, step, got
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    return res


def ring_vs_one_process(args, cfg, link) -> dict:
    """(28a) the ring across processes against the one-process ring on the
    card, at the cell's layer shapes (q [1, seq, H, 128], K/V at Hk, bf16,
    causal): this rank's output and dQ, dK, dV against its rows of the
    one-process ring's, bit for bit."""
    import torch

    from ..ops import ring_flash as rf

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 5)
    hd = cfg.hidden_size // cfg.num_attention_heads

    def draw(heads):
        return torch.randn(1, args.seq, heads, hd, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = draw(cfg.num_attention_heads), draw(cfg.num_key_value_heads), \
        draw(cfg.num_key_value_heads)
    do = draw(cfg.num_attention_heads)
    n = args.seq // link.size
    rows = slice(link.index * n, (link.index + 1) * n)
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    one = rf.ring_flash_attention(*whole, link.size, True)
    one.backward(do)
    mine = [t[:, rows].clone().requires_grad_(True) for t in (q, k, v)]
    got = rf.ring_flash_attention(*mine, link.size, True, link=link)
    got.backward(do[:, rows].contiguous())
    torch.cuda.synchronize()
    pairs = {"out": (got, one[:, rows])}
    pairs.update({f"d{x}": (m.grad, w.grad[:, rows]) for x, m, w in zip("qkv", mine, whole)})
    out = {"bit_identical": {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()},
           "max_abs_err": {k: (a.float() - b.float()).abs().max().item()
                           for k, (a, b) in pairs.items()},
           "shape": [1, n, cfg.num_attention_heads, hd]}
    if args.tiny:       # the plain full attention over the whole inputs (small shapes)
        from ..ops import flash_attention as fa

        o, lse = fa.flash_attention_fwd_ref(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        plain = (o,) + tuple(fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, True))
        out["vs_plain_max_rel"] = {
            key: ((a.float() - w[:, rows].float()).abs().max()
                  / w[:, rows].float().abs().max()).item()
            for key, (a, _), w in zip(pairs, pairs.values(), plain)}
    del q, k, v, do, whole, one, mine, got, pairs
    torch.cuda.empty_cache()
    return out


def phase_s(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective
    from ..distributed.fleet.sequence_parallel import context_link

    dist.init_parallel_env(timeout=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world not in (SEP, SEP_TENSOR):
        raise ValueError(f"phase s runs {SEP} or {SEP_TENSOR} ranks, got {world}")
    mesh = sep_mesh(world)
    dist.set_mesh(mesh)
    link = context_link("sep", mesh)
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device()), "coord": mesh.coordinate(), "sep_index": link.index}
    t0 = time.perf_counter()
    res["check"] = sep_check(args, mesh)
    res["check_s"] = round(time.perf_counter() - t0, 1)
    if world != SEP:
        dist.barrier()
        return res
    # (28a) the timed cell, after the ring against the one-process ring
    t_a = time.perf_counter()
    cfg = config(args, args.layers)
    res["vs_one_process"] = ring_vs_one_process(args, cfg, link)
    model, step = sep_step(args, args.layers, "ring", mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = sep_counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, 1, args.seq, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, 1, args.seq, cfg.vocab_size)
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    res.update(layers=args.layers, seq=args.seq, positions_on_rank=args.seq // link.size,
               warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches,
               collectives_per_step={k: v / n for k, v in stats["calls"].items()
                                     if k != "barrier"},
               collective_bytes_per_step={k: v / n for k, v in stats["bytes"].items()
                                          if k != "barrier"},
               params=model.num_params(),
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured",
               seconds=round(time.perf_counter() - t_a, 1))
    say("s", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if k != "check"})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    del model, step
    torch.cuda.empty_cache()
    dist.barrier()
    return res


EP = 2                  # ranks of phase e
EP_LAYERS = 2           # 29's depth, cut from Mixtral's 32
EP_AUX = 0.02           # Mixtral's router_aux_loss_coef
EP_FAULT_CF = 0.5       # 29c's capacity factor: tokens drop
# Phase e's router check: the one process's own logits against the
# program's, in units of bf16's rounding at each layer's largest |logit|
# (2^-7 of the power of two at or below it). Both are bf16 products of
# hidden states that differ by a few roundings (the batch cut otherwise,
# the attention's partial sums added in another order), so the largest
# logit moves by a unit or two; a fault in the router's forward moves
# them by its own size.
EP_LOGIT_ULPS = 4
# Phase e's loss check, relative: both are f32 means over the global
# batch of cross entropies of bf16 logits that differ by roundings, plus
# 0.02 x the aux; 2^-8 is one unit of bf16's roundoff.
EP_LOSS_RTOL = 2.0 ** -8
#: Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json), as
#: chip_smoke's phase 22 types them in
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768,
               rms_norm_eps=1e-5, rope_theta=1e6, tie_word_embeddings=False,
               moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.5)


def ep_config(args, layers, cf=None):
    from ..models.llama import LlamaConfig

    if args.tiny:       # head_dim 64, 4 experts
        cfg = LlamaConfig.tiny(num_hidden_layers=layers, num_attention_heads=4,
                               num_key_value_heads=2, moe_num_experts=4)
    else:
        cfg = LlamaConfig(num_hidden_layers=layers, **MIXTRAL)
    if cf is not None:
        cfg.moe_capacity_factor = cf
    return cfg


def ep_loss(model):
    """The cross entropy plus ``EP_AUX`` times the layers' load-balance
    losses."""
    def loss(ids, labels):
        ce = model(ids, labels=labels)[0]
        return ce + EP_AUX * sum(lyr.mlp.aux_loss for lyr in model.llama.layers)
    return loss


def ep_build(args, cfg):
    import torch

    from ..models.llama import LlamaForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
    return model, AdamW(LR, parameters=model.parameters(), weight_decay=0.1,
                        grad_clip=ClipGradByGlobalNorm(1.0))


def ep_step(args, cfg, axes):
    """(model, PartitionedTrainStep) of a fresh MoE Llama over
    ``build_program_mesh(**axes)``."""
    from .. import distributed as dist
    from ..distributed.partitioning import PartitionedTrainStep, Partitioner

    model, opt = ep_build(args, cfg)
    part = Partitioner(dist.build_program_mesh(**axes))
    return model, PartitionedTrainStep(model, opt, ep_loss(model), partitioner=part)


class routing_alone:
    """A planted fault: every rank routes its rows as if they were the
    batch (its own capacity, slots from 0, its own load-balance means), as
    the port did before it routed the global batch; the collectives stay
    those of the global routing, so no rank waits on another."""

    def __enter__(self):
        import torch

        from ..distributed.fleet import moe

        class Alone(moe.GlobalView):
            def of(self, r):
                return torch.zeros_like(self.counts[r]), self.counts[r], self.token_counts[r]

        self.keep = keep = moe.route_view

        def route_view(ids, probs, group):
            v = keep(ids, probs, group)
            return Alone(v.counts, v.token_counts, v.index, probs.mean(0))

        moe.route_view = route_view
        return self

    def __exit__(self, *exc):
        from ..distributed.fleet import moe

        moe.route_view = self.keep
        return False


def _gate_hooks(model, fn):
    return [lyr.mlp.gate.register_forward_hook(fn(i))
            for i, lyr in enumerate(model.llama.layers)]


def ep_check(args, cfg, axes, rows, seq, faults=()) -> dict:
    """(29a's check, 29b, 29c) the loss and every leaf's reduced gradient
    of ``PartitionedTrainStep`` over ``axes`` on a global batch of ``rows``
    x ``seq`` (this rank's slices), against a one-process traced backward
    of the whole batch on the card within ``GRAD_TOL`` of the leaf's
    largest entry; then each planted fault (``"alone"``: every rank routes
    its rows alone) against the same. The one process routes from the
    logits the ranks computed (each layer's router output gathered over the
    data ranks, its value taken and its gradient passed through): a bf16
    logit one unit off on a near-tie would move a token to another expert,
    and the check holds the routing of one set of logits. Its own logits
    are held against the program's within ``EP_LOGIT_ULPS`` units of bf16's
    rounding at the layer's largest, and the loss within ``EP_LOSS_RTOL``;
    how many logits differ in their bits is reported."""
    import torch

    from .. import distributed as dist
    from .. import tracing
    from ..distributed.tensor_parallel import gather_dim
    from ..models.llama import LlamaForCausalLM

    rank = dist.get_rank()
    ids, labels = tokens(args.seed + 6, rows, seq, cfg.vocab_size)
    res, held, logits = {}, {}, None
    for plant in (None,) + tuple(faults):
        t0 = time.perf_counter()
        model, step = ep_step(args, cfg, axes)
        part = step.partitioner
        seen = []
        hooks = _gate_hooks(model, lambda i: lambda m, a, o: seen.append(o.detach()))
        try:
            with routing_alone() if plant == "alone" else contextlib.nullcontext():
                loss, got = reduced_grads(step, part.shard_batch(ids), part.shard_batch(labels))
        finally:
            for h in hooks:
                h.remove()
        losses = []
        dist.all_gather_object(losses, loss.item())
        data = part.update.data_group
        if logits is None:      # the global batch's logits, in its order
            logits = [gather_dim(t, 0, data) for t in seen]
        held[plant] = ({n: (g.detach().clone(), idx) for n, (g, idx) in got.items()},
                       sum(losses) / len(losses), round(time.perf_counter() - t0, 1))
        del model, step, got, seen
        torch.cuda.empty_cache()
    errs = {p: {} for p in held}
    for r in range(dist.get_world_size()):      # the one process, rank after rank
        if r == rank:
            model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=args.seed)
            named = list(model.named_parameters())
            mine = []
            hooks = _gate_hooks(model, lambda i: lambda m, a, o: (
                mine.append(o.detach()), o + (logits[i] - o).detach())[1])
            with tracing.traced():
                loss = ep_loss(model)(ids, labels).float()
                grads = torch.autograd.grad(loss, [q for _, q in named])
            for h in hooks:
                h.remove()
            want = {n: g for (n, _), g in zip(named, grads)}
            plain_loss = loss.item()
            differ = sum(int((a != b).sum()) for a, b in zip(mine, logits))
            ulps = max((a.float() - b.float()).abs().max().item()
                       / 2.0 ** (math.floor(math.log2(b.float().abs().max().item())) - 7)
                       for a, b in zip(mine, logits))
            for p, (got, _, _) in held.items():
                errs[p] = {n: (g.float() - want[n][idx].float()).abs().max().item()
                           / (want[n].float().abs().max().item() or 1.0)
                           for n, (g, idx) in got.items()}
            del model, named, grads, want, loss, mine
            torch.cuda.empty_cache()
        dist.barrier()
    for p, (got, loss, secs) in held.items():
        every = []
        dist.all_gather_object(every, errs[p])
        worst_of = {n: max(e[n] for e in every) for n in every[0]}
        worst = max(worst_of, key=worst_of.get)
        res[p or "check"] = {
            "loss": loss, "loss_plain": plain_loss,
            "loss_rel_diff": abs(loss - plain_loss) / abs(plain_loss),
            "loss_rtol": EP_LOSS_RTOL, "leaves": len(worst_of),
            "leaves_checked": len(worst_of) == len(list(held[None][0])),
            "grad_vs_ref_max_rel": worst_of[worst], "grad_vs_ref_worst_leaf": worst,
            "grad_vs_ref_tol": GRAD_TOL,
            "grad_vs_ref_beyond_tol": sum(e > GRAD_TOL for e in worst_of.values()),
            "logits_differing": differ, "logits": sum(t.numel() for t in logits),
            "logits_max_ulps": ulps, "logits_tol_ulps": EP_LOGIT_ULPS, "seconds": secs}
    del held, logits
    torch.cuda.empty_cache()
    return res


def ep_expected(layers: int, steps: int) -> dict:
    """Launches on one rank of ``steps`` PartitionedTrainStep calls at
    ``layers`` layers: flash once each way a layer, RMSNorm's
    ``round_first`` mode 2 L + 1 each way, one fused update a step (the
    rank's 10 L + 3 tensors, the expert slices among them)."""
    norms = (2 * layers + 1) * steps
    return {"flash_wgmma_fwd": layers * steps, "flash_wgmma_bwd": layers * steps,
            "rms_norm_fwd_fused": 0, "rms_norm_bwd_dx_fused": 0,
            "rms_norm_fwd_round_first": norms, "rms_norm_bwd_dx_round_first": norms,
            "multi_tensor_update": steps}


def phase_e(args, out):
    import torch

    from .. import distributed as dist
    from ..distributed import collective

    dist.init_parallel_env(timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != EP:
        raise ValueError(f"phase e runs {EP} ranks, got {world}")
    res = {"backend": dist.env.backend(), "world": world, "rank": rank,
           "device": str(dist.env.device())}
    cfg = ep_config(args, EP_LAYERS)
    seq = args.seq // EP            # a global batch of --seq tokens, a row a rank
    t0 = time.perf_counter()
    # (29a's check) experts over dp: the all-to-all
    res["check_dp"] = ep_check(args, cfg, {"dp": EP}, EP, seq)
    # (29c) at a capacity where tokens drop: routing each rank's rows alone is refused
    res["check_fault"] = ep_check(args, ep_config(args, EP_LAYERS, EP_FAULT_CF), {"dp": EP},
                                  EP, args.check_seq, faults=("alone",))
    # (29b) experts over tensor: partial sums, the attention cut by heads
    res["check_tensor"] = ep_check(args, cfg, {"tensor": EP}, 1, args.check_seq)
    res["check_s"] = round(time.perf_counter() - t0, 1)
    for name in ("check_dp", "check_fault", "check_tensor"):
        for case, k in res[name].items():
            say("e", rank=rank, case=f"{name}_{case}", **k)
    # (29a) the timed cell
    t_a = time.perf_counter()
    model, step = ep_step(args, cfg, {"dp": EP})
    links = [lyr.mlp._ep.link for lyr in model.llama.layers]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = counters()
    losses, times = [], []
    for i in range(args.steps + 1):
        ids, labels = tokens(args.seed + 3 + i, EP, seq, cfg.vocab_size)
        if i == 1:
            torch.cuda.synchronize()
            zero(c)
            collective.reset_stats()
            for link in links:
                link.rows = link.kept = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read(c)
    stats = collective.stats()
    rows = [link.rows for link in links]
    kept = [link.kept for link in links]
    from torch.profiler import ProfilerActivity, profile

    ids, labels = tokens(args.seed + 99, EP, seq, cfg.vocab_size)
    dist.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    n = args.steps
    held = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for lyr in model.llama.layers
                  for p in (lyr.mlp.w_gate, lyr.mlp.w_up, lyr.mlp.w_down))
    res.update(layers=EP_LAYERS, rows=EP, seq=seq, tokens_on_rank=seq,
               warmup_step_ms=round(1e3 * times[0], 3),
               step_ms=[round(1e3 * t, 3) for t in times[1:]],
               step_ms_mean=round(1e3 * sum(times[1:]) / n, 3), losses=losses,
               launches=launches, expected_launches=ep_expected(EP_LAYERS, n),
               a2a_rows=rows, kept_rows=kept, hidden=cfg.hidden_size,
               collectives_per_step={k: v / n for k, v in stats["calls"].items()
                                     if k != "barrier"},
               collective_bytes={k: v for k, v in stats["bytes"].items() if k != "barrier"},
               params_on_rank=held, expert_params_on_rank=experts,
               replicated_params=held - experts,
               max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
               profiled_step_ms=round(1e3 * wall, 3), device_busy_ms=round(1e3 * busy, 3),
               device_busy_share=round(busy / wall, 4) if busy else "not measured",
               seconds=round(time.perf_counter() - t_a, 1))
    say("e", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                for k, v in res.items() if not k.startswith("check")})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses are not finite: {losses}")
    del model, step
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("a", "b", "t", "p", "h", "s", "e"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--check-layers", type=int, default=2)
    ap.add_argument("--check-seq", type=int, default=2048)
    ap.add_argument("--comm-buffer-size", type=float, default=25)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    res = {"a": phase_a, "b": phase_b, "t": phase_t, "p": phase_p,
           "h": phase_h, "s": phase_s, "e": phase_e}[args.phase](args, args.out)
    from .. import distributed as dist

    with open(os.path.join(args.out, f"dist_{args.phase}.{dist.get_rank()}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.tools import dist_train

    sys.exit(dist_train.main())
