"""Where a call of the int8 weight stream spends its time, block by block, on one GPU.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.stream_trace [--no-compute] [SOURCE.cu ...]

Each source (default: ``csrc/quant_matmul.cu``) is copied with probes
inserted into ``int8_stream_kernel``: the first thread of every block
writes ``%globaltimer`` (ns, one clock for all blocks) at its start, the
producer when its first W boxes are issued and when the kernel before has
finished (``griddepcontrol.wait``), the first consumer thread when the
first and the last stage have landed, after its last stage, when the
block's sums are sent, after the cluster barrier and at the end; also the
block's SM.
The marks go to a device array of the copy, read back after
the last of 8 calls (weights cycled past the L2) at each decode shape of
chip_smoke.py (GEMM_SHAPES) at M = 8. ``--no-compute`` also drops the
consumers' work on a stage, so the copy shows what the loads alone take.
For each shape it prints the kernel's span (first start to last end), the
spread of the blocks' starts and ends, and the median and largest time
between marks over the blocks.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MARKS = ("start", "W prefetched", "kernel before done", "first stage landed",
         "last stage landed", "stages done", "sums sent", "cluster barrier", "end")
SLOTS = 10          # int64 a block: the marks, then the SM
MAX_BLOCKS = 4096


def _sub(src: str, anchor: str, repl: str) -> str:
    n = src.count(anchor)
    if n != 1:
        raise ValueError(f"stream_trace: anchor {anchor[:60]!r} found {n} times, not 1")
    return src.replace(anchor, repl)


def instrument(src: str, no_compute: bool) -> str:
    """The source with probes in the weight stream's kernel."""
    src = _sub(src, "namespace ws {\n", f"""namespace ws {{
__device__ unsigned long long g_trace[{MAX_BLOCKS * SLOTS}];
__device__ __forceinline__ void mark(int i) {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (blockIdx.x < {MAX_BLOCKS}) g_trace[blockIdx.x * {SLOTS} + i] = t;
}}
""")
    anchor = "  const int units = a.M * (kCols / 4), share = (units + ks - 1) / ks;\n"
    src = _sub(src, anchor, anchor +
               "  if (threadIdx.x == 0) { mark(0); unsigned smid; asm volatile(\"mov.u32 %0, "
               f"%%smid;\" : \"=r\"(smid)); if (blockIdx.x < {MAX_BLOCKS}) "
               f"g_trace[blockIdx.x * {SLOTS} + 9] = smid; }}\n")
    wait = "      asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
    src = _sub(src, wait + "      for (int it", "      mark(1);\n" + wait + "      mark(2);\n"
               "      for (int it")
    loop = "#pragma unroll\n      for (int p = 0; p < kSteps; ++p) {"
    src = _sub(src, "      mbar_wait(full + st, ph);\n" + loop,
               "      mbar_wait(full + st, ph);\n      if (tid == 0 && it == 0) mark(3);\n"
               "      if (tid == 0 && it == nst - 1) mark(4);\n#pragma unroll\n"
               + ("      for (int p = 0; p < (a.M >= 0 ? 0 : kSteps); ++p) {" if no_compute
                  else "      for (int p = 0; p < kSteps; ++p) {"))
    src = _sub(src, "    // the warps' sums, in a fixed order",
               "    if (tid == 0) mark(5);\n    // the warps' sums, in a fixed order")
    src = _sub(src, "  // rank `slice` adds its units",
               "  if (tid == 0) mark(6);\n  // rank `slice` adds its units")
    src = _sub(src, "  T* out = static_cast<T*>(a.out);\n  const int u0",
               "  if (tid == 0) mark(7);\n  T* out = static_cast<T*>(a.out);\n  const int u0")
    src = _sub(src, "pack2<__nv_bfloat16>(v.z, v.w));\n    }\n  }\n}",
               "pack2<__nv_bfloat16>(v.z, v.w));\n    }\n  }\n  if (tid == 0) mark(8);\n}")
    src += ("\nextern \"C\" int stream_trace_read(void* dst, int n) {\n"
            "  return (int)cudaMemcpyFromSymbol(dst, ws::g_trace, (size_t)n * 8);\n}\n")
    return src


def run(lib: str):
    """Trace one instrumented library (in a child process)."""
    import math

    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_matmul as qm

    cdll = ctypes.CDLL(lib)
    _build._loaded["quant_matmul"] = cdll
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, K, N, _ in cs.GEMM_SHAPES:
        n_bufs = max(1, min(8, math.ceil(3 * cs.L2_BYTES / (K * N))))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(n_bufs)]
        s = torch.rand((N,), generator=gen, device="cuda") * 0.02 + 1e-3
        x = torch.randn((8, K), generator=gen, device="cuda").bfloat16()
        for i in range(8):
            qm.int8_matmul(x, ws[i % n_bufs], s)
        torch.cuda.synchronize()
        _, ksplit, blocks = qm.stream_plan(8, K, N, sms)
        blocks = min(blocks, MAX_BLOCKS)
        buf = (ctypes.c_uint64 * (blocks * SLOTS))()
        if cdll.stream_trace_read(buf, blocks * SLOTS):
            raise RuntimeError("stream_trace: reading the marks failed")
        tr = torch.tensor(list(buf), dtype=torch.float64).view(blocks, SLOTS)
        t0 = tr[:, 0].min()
        start, end = (tr[:, 0] - t0) / 1e3, (tr[:, 8] - t0) / 1e3
        per_sm = torch.bincount(tr[:, 9].long(), minlength=sms)
        print(f"== {name} K {K} N {N}: {blocks} blocks, ksplit {ksplit}, blocks an SM "
              f"{per_sm.min().item()}-{per_sm.max().item()}; span {end.max():.2f} us; start "
              f"median {start.median():.2f} max {start.max():.2f}; end median {end.median():.2f} "
              f"min {end.min():.2f}", flush=True)
        for k in range(1, len(MARKS)):
            d = (tr[:, k] - tr[:, k - 1]) / 1e3
            print(f"   {MARKS[k - 1]:>18s} -> {MARKS[k]:<18s} us: median {d.median():.2f} "
                  f"max {d.max():.2f}", flush=True)
        del ws
        torch.cuda.empty_cache()
    del _build._loaded["quant_matmul"]


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--run"]:
        run(argv[1])
        return 0
    import chip_smoke as cs

    from paddle_tpu_torch.ops import _build

    print(cs.nvidia_smi(), flush=True)
    no_compute = argv[:1] == ["--no-compute"]
    sources = argv[no_compute:] or [str(_build.CSRC / "quant_matmul.cu")]
    out = _build.BUILD_DIR / "stream_trace"
    out.mkdir(parents=True, exist_ok=True)
    for i, src in enumerate(sources):
        copy = out / f"trace{i}.cu"
        copy.write_text(instrument(Path(src).read_text(), no_compute))
        lib = out / f"libtrace{i}.so"
        subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib), str(copy)], check=True, capture_output=True)
        print(f"== {src}{' (no compute)' if no_compute else ''}", flush=True)
        r = subprocess.run(["timeout", "-k", "5", "200", sys.executable, "-m",
                            "paddle_tpu_torch.tools.stream_trace", "--run", str(lib)],
                           capture_output=True, text=True, cwd=str(ROOT))
        print(r.stdout.strip() or f"exit {r.returncode}\n{r.stderr[-800:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
