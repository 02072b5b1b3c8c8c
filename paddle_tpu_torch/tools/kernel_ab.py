"""Compare variants of ``csrc/flash_attention.cu``, ``csrc/quant_matmul.cu``
or ``csrc/paged_attention.cu`` on one GPU, in one run.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.kernel_ab VARIANT.cu [VARIANT.cu ...]
    python -m paddle_tpu_torch.tools.kernel_ab --f32 VARIANT.cu [VARIANT.cu ...]
    python -m paddle_tpu_torch.tools.kernel_ab --quant [--no-check] VARIANT.cu [...]
    python -m paddle_tpu_torch.tools.kernel_ab --paged [--wide] VARIANT.cu [VARIANT.cu ...]
    python -m paddle_tpu_torch.tools.kernel_ab --stream [--no-check] VARIANT.cu [...]

The ``--stream`` form takes copies of ``csrc/quant_matmul.cu`` for the
weight stream (M <= 64): the current interface (it exports
``int8_stream_abi``: one launch, K cut into slices that a thread-block
cluster adds) or the SIMT one before it (a K-split kernel writing f32
partials into per-call scratch, then a finalize kernel, called as its
wrapper called it; ``git show <commit>:<path>`` gives one). Each runs in a
child process, in the order given (the same source may be named twice):
held against the plain version at the eight Llama-3-8B decode shapes
(chip_smoke.py's GEMM_SHAPES) at M = 8 in bf16 and f32 and two calls bit
for bit, then timed at each shape at M = 1, 8, 16 and 64 with
chip_smoke.py's CUDA-graph timing (weights cycled past the L2), with the
decode step's sum (225 calls) at each M. The bf16 GEMM on weights
dequantized before timing (the bf16 engine's own call) is timed before
and after as the yardstick; ``--no-check`` times copies that skip part
of the work; ``VARIANT.cu@NAME=VALUE,...`` plans the calls with the
wrapper's plan constants so set (``_BLOCKS_PER_SM``, ``_FILL``,
``_MAX_SPLIT``: how finely K is cut).

The ``--paged`` form takes copies of ``csrc/paged_attention.cu``: the
current interface (one launch, Kc passed from the shapes;
``paged_attention_abi`` 3), the one before it (Kc found on the device from
the lengths; ``paged_attention_abi`` 2), or the first one (a decode kernel
and a merge kernel over per-call scratch), each called as its source's
wrapper called it (``git show <commit>:<path>`` gives one).
Each runs in a child process, in the order given (the same source may be
named twice, e.g. parent, new, new, parent): held against the plain
version at chip_smoke.py's three timed cases (PAGED_TIMED: ragged, full
and skewed lengths at the serving shape, bf16), two calls bit for bit,
then timed at each case with chip_smoke.py's CUDA-graph timing. SDPA over
the gathered window is timed at each case before and after the variants.
``VARIANT.cu@N`` runs a copy with N blocks an SM (the wrapper's
``BLOCKS_PER_SM``), ``VARIANT.cu@fill=F`` one of the current interface
with chunks F times the grid with every lane full (the wrapper's ``FILL``:
blocks loop over the chunks); ``--paged --no-check`` times copies that skip part of
the work without the check; ``--paged --wide`` holds (against the plain
version in f32) and times the kernel's wide mode at chip_smoke.py's
WIDE_PAGED_CASES (head dims 320 to 1024, pages of 512 slots) instead.

The ``--f32`` form takes copies of ``csrc/flash_attention.cu`` and holds
each on flash's f32 route at chip_smoke.py phase 5's f32 case (B 1, S
2048, H 32, Hk 8, head_dim 128, causal): out, dQ, dK and dV tile errors
against the plain versions in full f32 (TF32 off), two backward calls bit
for bit, and the forward and backward timed twice, SDPA in f32 before and
after as the yardstick.

The second form takes copies of ``csrc/quant_matmul.cu``, checks each
library's tensor-core forward and dX (bf16 at a ragged M, held as phase 8
of chip_smoke.py holds bf16; f32 through the split, held to its
tensor-core limit for the reduction's length) against the plain versions,
and times both in bf16 over the seven projections of one Llama-3-8B layer
at M = 8192, with cuBLAS (``torch.matmul`` on the weights cast to bf16)
timed before and after as the yardstick. ``--no-check`` times every
variant without the check: for diagnostic copies that skip part of the
work to show what bounds the rest.

Each variant is a copy of ``paddle_tpu_torch/csrc/flash_attention.cu``
with the same C interface (an older source without the f32 route's
trailing scratch pointer loads as it is: it ignores that argument). All
are compiled together with the build's own
flags into ``paddle_tpu_torch/_build/ab/``; the compiler's spill and wgmma-serialization notes and each
library's SASS counts (HGMMA, HMMA, UTMALDG, SYNCS) are printed. Then each
variant runs in a child process of its own (a fault in one does not stop
the others): the flash wrappers are pointed at its library, checked
against the plain versions (forward and backward tile errors, and two
backward calls bit for bit) at three small shapes, and timed at the
training shape (B 1, S 8192, H 32, Hk 8, head_dim 128, causal, bf16)
with chip_smoke.py's CUDA-graph timing, twice, with the device time of
each kernel of the backward from torch.profiler. SDPA's forward and
backward are timed before and after, in the same run, as the yardstick.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (1, 8192, 32, 8, 128)          # B, S, H, Hk, head_dim of the timing
CHECKS = ((1, 2048, 32, 8, 128, True, "bf16"), (2, 1000, 8, 2, 64, False, "fp16"),
          (1, 127, 4, 1, 128, True, "bf16"))
F32_SHAPE = (1, 2048, 32, 8, 128)      # B, S, H, Hk, head_dim of the f32 form


def _kernel(name: str) -> str:
    """A kernel's short name from its demangled or mangled name."""
    m = re.search(r"(flash_(?:fwd|bwd_[a-z]+)_kernel)<([^>]*)>", name)
    if m:
        return f"{m.group(1)}<{m.group(2).replace(' ', '')}>"
    m = re.search(r"(flash_(?:fwd|bwd_[a-z]+)_kernel)I(\w+?)Li(\d+)E(?:Lb(\d))?", name)
    if m:
        return m.group(1) + "<" + ",".join(x for x in m.groups()[1:] if x) + ">"
    return name[:60]


def build(sources, out_dir: Path) -> dict:
    """{source: library} of the variants that compiled."""
    from paddle_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    procs = {}
    for src in sources:
        lib = out_dir / f"{Path(src).stem}.so"
        cmd = [nvcc, *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), src]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    for src, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        print(f"== {src}: nvcc exit {proc.returncode}", flush=True)
        fn = ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = _kernel(m.group(1))
            elif "C75" in line:
                print(f"   {_kernel(line)}: {line.split('due to')[-1].split(' for ')[0].strip()}")
            elif "Used" in line:
                print(f"   {fn}: {line.strip()[:120]}")
            elif ("spill stores" in line and not line.strip().startswith("0 bytes")) or "error" in line:
                print(f"   {fn}: {line.strip()[:200]}")
        if proc.returncode == 0:
            if cuobjdump.is_file():
                sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                                      text=True).stdout
                print("   sass", {op: len(re.findall(rf"\b{op}\b", sass))
                                  for op in ("HGMMA", "HMMA", "UTMALDG", "SYNCS")})
            libs[src] = lib
    return libs


def sdpa_ms(gen, shape=SHAPE, dtype=None):
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    B, S, H, Hk, hd = shape
    dtype = dtype or torch.bfloat16
    q, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda").to(dtype) for _ in "ab")
    k, v = (torch.randn((B, Hk, S, hd), generator=gen, device="cuda").to(dtype) for _ in "ab")
    fwd = cs.device_ms(lambda i: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                enable_gqa=True), 1, 5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    bwd = cs.eager_ms(lambda i: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True),
                      1, 5, 2)
    return round(fwd, 5), round(bwd, 5)


def run_variant(lib: str):
    """Check and time one library (in a child process)."""
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    _build._loaded["flash_attention"] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst, same = 0.0, True
    for B, S, H, Hk, hd, causal, dt in CHECKS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float16
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dtype)
                       for n in (H, Hk, Hk, H))
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        got = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
        again = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
        want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
        ref_out, _ = fa.flash_attention_fwd_ref(q, k, v, causal)
        worst = max(worst, fa.tile_errors(out, ref_out)[0],
                    *(fa.tile_errors(a, b)[0] for a, b in zip(got, want)))
        same = same and all(torch.equal(a, b) for a, b in zip(got, again))
    B, S, H, Hk, hd = SHAPE
    q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda").bfloat16()
                   for n in (H, Hk, Hk, H))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for _ in range(2):
        fwd = cs.device_ms(lambda i: fa.flash_attention_fwd(q, k, v, True), 1, 5)
        bwd = cs.device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta, True), 1, 5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention_bwd(q, k, v, do, lse, delta, True)
            torch.cuda.synchronize()
        per = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA and "flash_" in ev.name:
                key = _kernel(ev.name)
                per[key] = round(per.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3, 4)
        print(f"{Path(lib).name}: worst_tile_err {worst:.5f} bit_identical {same} "
              f"fwd_ms {fwd:.5f} bwd_ms {bwd:.5f} bwd_kernels_ms {per}", flush=True)


def run_f32_variant(lib: str):
    """Check and time one library on flash's f32 route (in a child process)."""
    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    _build._loaded["flash_attention"] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, S, H, Hk, hd = F32_SHAPE
    q, k, v, do = (torch.randn((B, S, n, hd), generator=gen, device="cuda")
                   for n in (H, Hk, Hk, H))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, True)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, True)
    ref_out, _ = fa.flash_attention_fwd_ref(q, k, v, True)
    want = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, True)
    errs = [fa.tile_errors(out, ref_out)[0]] + [fa.tile_errors(a, b)[0]
                                                for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    for _ in range(2):
        fwd = cs.device_ms(lambda i: fa.flash_attention_fwd(q, k, v, True), 1, 5)
        bwd = cs.device_ms(lambda i: fa.flash_attention_bwd(q, k, v, do, lse, delta, True), 1, 5)
        print(f"{Path(lib).name}: f32 out/dq/dk/dv tile_err {[f'{e:.3g}' for e in errs]} "
              f"bit_identical {same} fwd_ms {fwd:.5f} bwd_ms {bwd:.5f}", flush=True)


def _int8_layer(gen):
    """The seven projections of one layer at M = 8192: [(x, dO, w, s)]."""
    import chip_smoke as cs
    import torch

    M = cs.TRAIN_SEQ
    out = []
    for _, K, N, _ in cs.GEMM_SHAPES[:7]:
        out.append((torch.randn((M, K), generator=gen, device="cuda").bfloat16(),
                    torch.randn((M, N), generator=gen, device="cuda").bfloat16(),
                    torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                                  dtype=torch.int8),
                    torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3))
    return out


def cublas_ms(gen):
    """cuBLAS over one layer's projections, forward and dX shapes."""
    import chip_smoke as cs
    import torch

    fwd = dx = 0.0
    for x, do, w, s in _int8_layer(gen):
        wb = w.to(torch.bfloat16)
        fwd += cs.device_ms(lambda i: torch.matmul(x, wb), 1, 10)
        dx += cs.device_ms(lambda i: torch.matmul(do, wb.T), 1, 10)
    return round(fwd, 5), round(dx, 5)


def run_quant_variant(lib: str, check: bool = True):
    """Check (unless ``check`` is false) and time one quant_matmul library
    (in a child process)."""
    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_matmul as qm

    _build._loaded["quant_matmul"] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = [0.0]
    checks = ((1000, 4096, 1024, torch.bfloat16), (300, 14336, 4096, torch.float32))
    for M, K, N, dt in checks if check else ():
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        do = torch.randn((M, N), generator=gen, device="cuda").to(dt)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        got = (qm.int8_matmul_large_m(x, w, s), qm.int8_matmul_dx(do, w, s))
        want = (qm.int8_matmul_ref(x, w, s), qm.int8_matmul_dx_ref(do, w, s))
        for label, g, ref, red in zip(("fwd", "dx"), got, want, (K, N)):
            if dt == torch.float32:
                errs.append(cs.hold_gemm_f32(f"{label} f32", g, ref, red))
            else:
                errs.append(cs.hold_gemm(f"{label} bf16", g, ref))
    fwd = dx = 0.0
    for x, do, w, s in _int8_layer(gen):
        fwd += cs.device_ms(lambda i: qm.int8_matmul_large_m(x, w, s), 1, 10)
        dx += cs.device_ms(lambda i: qm.int8_matmul_dx(do, w, s), 1, 10)
    print(f"{Path(lib).name}: max_abs_err {max(errs) if check else 'not checked'} "
          f"fwd_ms {fwd:.5f} dx_ms {dx:.5f}", flush=True)


STREAM_M = (1, 8, 16, 64)


def _legacy_split_plan(M: int, K: int, N: int, sms: int):
    """The earlier stream's plan (rows of x a block, K rows a block, K
    slices), as its wrapper computed it."""
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    blocks = -(-N // 128) * -(-M // mt)
    want = max(1, -(-2 * sms // blocks))
    kc = max(256, -(-K // want))
    kc = min(32 * 1024 // (4 * mt), -(-kc // 16) * 16)
    return mt, kc, -(-K // kc)


def _legacy_stream(lib):
    """``kern(x, w, s)`` over a library of the earlier stream interface,
    its f32 partials allocated per call as its wrapper did."""
    import torch

    from paddle_tpu_torch.ops import _build

    fn = lib.int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def kern(x, w, s):
        M, K = x.shape
        N = w.shape[1]
        mt, kc, ksplit = _legacy_split_plan(M, K, N, sms)
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        part = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
                if ksplit > 1 else None)
        rc = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                part.data_ptr() if part is not None else None, out.data_ptr(), M, K, N, mt, kc,
                ksplit, 0 if x.dtype == torch.float32 else 1, _build.launch_stream(x.device))
        if rc:
            raise RuntimeError(f"legacy weight stream: error {rc}")
        return out

    return kern


def stream_times(gen, kern) -> dict:
    """{M: (decode step ms, {shape: ms})} of ``kern(x, w, s)`` at the
    decode shapes, CUDA-graph timed with weights cycled past the L2."""
    import math

    import chip_smoke as cs
    import torch

    out = {M: [0.0, {}] for M in STREAM_M}
    for name, K, N, per_step in cs.GEMM_SHAPES:
        n_bufs = max(1, min(8, math.ceil(3 * cs.L2_BYTES / (K * N))))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(n_bufs)]
        ss = [torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(n_bufs)]
        for M in STREAM_M:
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            ms = cs.device_ms(lambda i: kern(x, ws[i], ss[i]), n_bufs)
            out[M][0] += per_step * ms
            out[M][1][name] = round(ms, 5)
        del ws, ss
        torch.cuda.empty_cache()
    return out


def bf16_gemm_ms(gen) -> str:
    """The decode step at M = 8 through ``torch.matmul`` on bf16 weights
    (dequantized before timing) times the scales: the bf16 engine's call."""
    import chip_smoke as cs
    import torch

    total = 0.0
    for _, K, N, per_step in cs.GEMM_SHAPES:
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8).to(torch.bfloat16)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        x = torch.randn((8, K), generator=gen, device="cuda").bfloat16()
        total += per_step * cs.device_ms(lambda i: torch.matmul(x, w) * s, 1)
        del w
        torch.cuda.empty_cache()
    return f"{total:.5f}"


def run_stream_variant(lib: str, check: bool = True, plan: str = ""):
    """Check (unless ``check`` is false) and time one weight-stream library
    (in a child process), with the plan constants ``plan`` sets
    (``NAME=VALUE,...``)."""
    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_matmul as qm

    for item in filter(None, plan.split(",")):
        name, value = item.split("=")
        setattr(qm, name, type(getattr(qm, name))(float(value)))
    cdll = ctypes.CDLL(lib)
    if hasattr(cdll, "int8_stream_abi"):
        _build._loaded["quant_matmul"] = cdll
        kern = qm.int8_matmul
    else:
        kern = _legacy_stream(cdll)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err, same = 0.0, True
    for name, K, N, _ in cs.GEMM_SHAPES if check else ():
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((8, K), generator=gen, device="cuda").to(dt)
            got, want = kern(x, w, s), qm.int8_matmul_ref(x, w, s)
            same = same and torch.equal(got, kern(x, w, s))
            err = max(err, cs.hold_gemm_f32(f"{name} f32", got, want) if dt == torch.float32
                      else cs.hold_gemm(f"{name} bf16", got, want))
        del w
    times = stream_times(gen, kern)
    line = "; ".join(f"M{M} step {t[0]:.5f} ms {json.dumps(t[1])}" for M, t in times.items())
    print(f"{Path(lib).name}: max_abs_err {err if check else 'not checked'} bit_identical "
          f"{same}; {line}", flush=True)


def _legacy_paged(lib):
    """``kern(q, pk, pv, table, ln)`` over a library of the first interface:
    its tile rule (whole pages, up to 64 slots and 40 KB of shared memory)
    and its f32 merge scratch allocated per call, as its wrapper did."""
    import math

    import torch

    from paddle_tpu_torch.ops import _build

    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def kern(q, pk, pv, table, ln):
        lanes, H, hd = q.shape
        _, bs, Hk, _ = pk.shape
        mb = table.shape[1]
        rep, es = H // Hk, q.element_size()
        fit = (40 * 1024 - 4 * rep * hd) // (2 * (hd * es + 16) + 4 * rep)
        tile = max(1, min(64, fit) // bs) * bs
        splits = -(-mb * bs // tile)
        out = torch.empty_like(q)
        acc = torch.empty((lanes, H, splits, hd), dtype=torch.float32, device=q.device)
        ml = torch.empty((lanes, H, splits, 2), dtype=torch.float32, device=q.device)
        rc = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(), ln.data_ptr(),
                acc.data_ptr(), ml.data_ptr(), out.data_ptr(), lanes, H, Hk, hd, bs, mb, tile,
                1.0 / math.sqrt(hd), 1 if q.dtype == torch.bfloat16 else 0,
                _build.launch_stream(q.device))
        if rc:
            raise RuntimeError(f"legacy paged kernel: error {rc}")
        return out

    return kern


def _abi2_paged(lib):
    """``kern(q, pk, pv, table, ln)`` over a library of the second
    interface: Kc found on the device from the lengths, so no Kc argument,
    and scratch of grid + pairs partials, as its wrapper allocated it."""
    import math

    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = {}

    def kern(q, pk, pv, table, ln):
        lanes, H, hd = q.shape
        nb, bs, Hk, _ = pk.shape
        grid, hp = pa._plan_for(q, pk, table)[0], pa.heads_per_pass(H, Hk)
        pairs = lanes * Hk * -(-(H // Hk) // hp)
        key = (lanes, H, Hk, hd, grid)
        if key not in scratch:
            scratch[key] = (torch.empty((grid + pairs) * hp * (-(-hd // 8) * 8 + 2),
                                        dtype=torch.float32, device=q.device),
                            torch.zeros(pairs, dtype=torch.int32, device=q.device))
        part, tickets = scratch[key]
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(), ln.data_ptr(),
                part.data_ptr(), tickets.data_ptr(), out.data_ptr(), lanes, H, Hk, hd, bs,
                table.shape[1], nb, grid, hp, 1.0 / math.sqrt(hd), pa._DTYPES[q.dtype],
                _build.launch_stream(q.device))
        if rc:
            raise RuntimeError(f"abi 2 paged kernel: error {rc}")
        return out

    return kern


def run_paged_variant(lib: str, check: bool = True, per_sm: int = 0, wide: bool = False,
                      fill: int = 0):
    """Check (unless ``check`` is false) and time one paged_attention
    library (in a child process), with ``per_sm`` blocks an SM and the
    wrapper's ``FILL`` if given; with ``wide`` at the wide mode's cases
    (chip_smoke.py's WIDE_PAGED_CASES, held against the plain version in
    f32)."""
    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    if per_sm:
        pa.BLOCKS_PER_SM = pa.WIDE_BLOCKS_PER_SM = per_sm
    if fill:
        pa.FILL = fill
    cdll = ctypes.CDLL(lib)
    abi = cdll.paged_attention_abi() if hasattr(cdll, "paged_attention_abi") else 1
    if abi >= 3:
        _build._loaded["paged_attention"] = cdll
        kern = pa.paged_decode_attention
    elif abi == 2:
        kern = _abi2_paged(cdll)
    else:
        kern = _legacy_paged(cdll)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    line = []
    for label, lengths, shape in _paged_cases(wide):
        q, pk, pv, table, ln = cs.attention_inputs(gen, lengths, 1, **shape)
        same = torch.equal(kern(q[0], pk[0], pv[0], table, ln), kern(q[0], pk[0], pv[0], table, ln))
        r = cs.time_paged(gen, label, lengths, kern, yardsticks=False, hold=check, shape=shape,
                          hold_f32=wide)
        line.append(f"{label} {r['ms']:.5f} ms (err {r['max_abs_err']:.3g}, bit_identical {same}, "
                    f"bound {r['bound_ms']:.5f})")
    print(f"{Path(lib).name}: " + "; ".join(line), flush=True)


def _paged_cases(wide: bool) -> list:
    """(label, lengths, attention_inputs shape) of the timed paged cases."""
    import chip_smoke as cs

    if wide:
        return list(cs.WIDE_PAGED_CASES)
    return [(label, lengths, {}) for label, lengths in cs.PAGED_TIMED]


def paged_sdpa_ms(gen, wide: bool = False) -> str:
    """SDPA over the gathered window at each timed case."""
    import chip_smoke as cs

    ms = [(label, cs.time_paged(gen, label, lengths, shape=shape, hold_f32=wide)["library_ms"])
          for label, lengths, shape in _paged_cases(wide)]
    return "; ".join(f"{label} {t:.5f}" for label, t in ms)


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--run-paged"]:
        run_paged_variant(argv[-3], check="--no-check" not in argv, per_sm=int(argv[-2]),
                          wide="--wide" in argv, fill=int(argv[-1]))
        return 0
    if argv[:1] == ["--run"]:
        run_variant(argv[1])
        return 0
    if argv[:1] == ["--run-quant"]:
        run_quant_variant(argv[-1], check=argv[1] != "--no-check")
        return 0
    if argv[:1] == ["--run-f32"]:
        run_f32_variant(argv[1])
        return 0
    if argv[:1] == ["--run-stream"]:
        run_stream_variant(argv[-2], check=argv[1] != "--no-check", plan=argv[-1])
        return 0
    import chip_smoke as cs
    import torch

    print(cs.nvidia_smi(), flush=True)
    from paddle_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    if argv[:1] == ["--quant"]:
        flags = ["--no-check"] if argv[1:2] == ["--no-check"] else []
        libs = build(argv[1 + len(flags):], out_dir)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        print("cublas fwd/dx ms", cublas_ms(gen), flush=True)
        for src, lib in libs.items():
            r = subprocess.run(["timeout", "-k", "5", "300", sys.executable, "-m",
                                "paddle_tpu_torch.tools.kernel_ab", "--run-quant", *flags,
                                str(lib)],
                               capture_output=True, text=True, cwd=str(ROOT))
            print(r.stdout.strip() or f"{src}: exit {r.returncode}\n{r.stderr[-800:]}",
                  flush=True)
        print("cublas fwd/dx ms", cublas_ms(gen), flush=True)
        return 0
    if argv[:1] == ["--stream"]:
        flags = ["--no-check"] if argv[1:2] == ["--no-check"] else []
        variants = [(str(Path(a.split("@")[0]).resolve()), a.split("@")[1] if "@" in a else "")
                    for a in argv[1 + len(flags):]]
        libs = {}
        for i, src in enumerate(dict.fromkeys(src for src, _ in variants)):  # stems may clash
            d = out_dir / "stream" / str(i)
            d.mkdir(parents=True, exist_ok=True)
            libs.update(build([src], d))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        print("bf16 gemm decode step M8 ms", bf16_gemm_ms(gen), flush=True)
        for a, (src, plan) in zip(argv[1 + len(flags):], variants):
            lib = libs.get(src)
            if lib is None:
                print(f"{a}: did not build", flush=True)
                continue
            r = subprocess.run(["timeout", "-k", "5", "300", sys.executable, "-m",
                                "paddle_tpu_torch.tools.kernel_ab", "--run-stream", *flags,
                                str(lib), plan],
                               capture_output=True, text=True, cwd=str(ROOT))
            print(f"{a}: " + (r.stdout.strip() or f"exit {r.returncode}\n{r.stderr[-800:]}"),
                  flush=True)
        print("bf16 gemm decode step M8 ms", bf16_gemm_ms(gen), flush=True)
        return 0
    if argv[:1] == ["--paged"]:
        flags = [a for a in argv[1:3] if a in ("--no-check", "--wide")]
        wide = "--wide" in flags
        variants = [(str(Path(a.split("@")[0]).resolve()), a.split("@")[1] if "@" in a else "")
                    for a in argv[1 + len(flags):]]
        sources = list(dict.fromkeys(src for src, _ in variants))
        paged_dir = out_dir / "paged"
        paged_dir.mkdir(exist_ok=True)
        libs = {}
        for i, src in enumerate(sources):  # one directory a source: equal stems do not clash
            d = paged_dir / str(i)
            d.mkdir(exist_ok=True)
            libs.update(build([src], d))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        print("sdpa ms", paged_sdpa_ms(gen, wide), flush=True)
        for a, (src, spec) in zip(argv[1 + len(flags):], variants):
            lib = libs.get(src)
            if lib is None:
                print(f"{a}: did not build", flush=True)
                continue
            fill = spec[5:] if spec.startswith("fill=") else "0"
            per_sm = spec if spec and fill == "0" else "0"
            r = subprocess.run(["timeout", "-k", "5", "150", sys.executable, "-m",
                                "paddle_tpu_torch.tools.kernel_ab", "--run-paged", *flags,
                                str(lib), per_sm, fill],
                               capture_output=True, text=True, cwd=str(ROOT))
            print(f"{a}: " + (r.stdout.strip() or f"exit {r.returncode}\n{r.stderr[-800:]}"),
                  flush=True)
        print("sdpa ms", paged_sdpa_ms(gen, wide), flush=True)
        return 0
    f32 = argv[:1] == ["--f32"]
    libs = build(argv[f32:], out_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    yardstick = (lambda: sdpa_ms(gen, F32_SHAPE, torch.float32)) if f32 else (lambda: sdpa_ms(gen))
    print(f"sdpa{' f32' if f32 else ''} fwd/bwd ms", yardstick(), flush=True)
    for src, lib in libs.items():
        r = subprocess.run(["timeout", "-k", "5", "150", sys.executable, "-m",
                            "paddle_tpu_torch.tools.kernel_ab", "--run-f32" if f32 else "--run",
                            str(lib)],
                           capture_output=True, text=True, cwd=str(ROOT))
        print(r.stdout.strip() or f"{src}: exit {r.returncode}\n{r.stderr[-800:]}", flush=True)
    print(f"sdpa{' f32' if f32 else ''} fwd/bwd ms", yardstick(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
