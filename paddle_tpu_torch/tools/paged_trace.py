"""Where a paged-attention call spends its time, block by block, on one GPU.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.paged_trace [--wide] [--no-compute] [SOURCE.cu ...]

Each source (default: ``csrc/paged_attention.cu``) is copied with probes
inserted: the consumer's first thread of every block writes ``clock64``
marks (cycles since the block started) at the end of the schedule
(reading ``lengths``, Kc), at the first box landing, after the last box,
after the flush of its partial, after the ticket and after the merge, and
the cycles it spent waiting for boxes; the producer's thread marks its
first TMA issue; ``%globaltimer`` gives each block's start and end on one
clock. The marks go to scratch past the partials (the wrapper's scratch is
replaced by a larger one). ``--no-compute`` also drops the consumers' work
on a box, so the copy shows what the loads alone take. The copy is built
with the build's own flags and run at chip_smoke.py's PAGED_TIMED cases
(``--wide``: WIDE_PAGED_CASES, the kernel's wide mode) (8 calls each, the
last one read); for each case it prints the median and
the largest mark over the blocks, and the consumers' wait and time a box.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MARKS = ("schedule (lengths, Kc)", "first TMA issued (producer)", "first box landed",
         "last box done", "flush done", "ticket", "merge done")


def _sub(src: str, pattern: str, repl: str, count=(1,)) -> str:
    out, n = re.subn(pattern, repl, src)
    if n not in count:
        raise ValueError(f"paged_trace: anchor {pattern!r} found {n} times, not {count}")
    return out


def instrument(src: str, no_compute: bool) -> str:
    """The source with probes; the trace of block j is 16 int64 at
    ``part + (grid + pairs) * 8 * (hd + 2)`` floats, + 16 j."""
    src = _sub(src, r"(__device__ __forceinline__ float neg_inf\(\))", r"""
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
\1""")
    src = _sub(src, r"(  const int tid = threadIdx\.x, warp = tid >> 5, lane = tid & 31;\n)", r"""\1
  long long* tr = reinterpret_cast<long long*>(
      a.part + (size_t)(a.grid + a.lanes * a.Hk * a.npass) * 8 * (a.hd + 2)) + blockIdx.x * 16;
  const long long c0 = clock64();
  if (tid == 0) tr[0] = gtime();
""")
    src = _sub(src, r"(\n  __syncthreads\(\);\n)", r"""\1  if (tid == 0) tr[1] = clock64() - c0;
""")
    src = _sub(src, r"if \(j >= nchunks\) return;",
               "if (j >= nchunks) { if (tid == 0) tr[9] = gtime(); return; }")
    src = _sub(src, r"(tma_load\(dst \+ lay\.box, &tv, full \+ st, 0, g, row0, pk\);\n)",
               r"\1              if (it == 0) tr[2] = clock64() - c0;\n")
    src = _sub(src, r"(  int it = 0(?:, ex = 0)?;\n)(  for \(int c = j; c < nchunks; c \+= a\.grid\) "
               r"\{\n    int b, sub, ci, nsplit;)", r"\1  long long waited = 0, boxes = 0;\n\2")
    src = _sub(src, r"(\n +)(mbar_wait\(full \+ st, ph\);\n)",
               r"\1const long long w0 = clock64();\1\2"
               r"        waited += clock64() - w0;\n"
               r"        if (tid == 0 && boxes++ == 0) tr[3] = clock64() - c0;\n",
               count=(1, 2))  # the narrow and the wide mode's consumer loops
    src = _sub(src, r"(\n    )(cs\.reduce\(|// the slot groups of a warp, merged by shuffles)",
               r"\1if (tid == 0) { tr[4] = clock64() - c0; tr[11] = waited; tr[12] = boxes; }\1\2")
    src = _sub(src, r"(    consumers_sync\(\);\n)(    if \(nsplit == 1\) continue;)",
               r"\1    if (tid == 0) { tr[5] = clock64() - c0; tr[9] = gtime(); }\n\2")
    src = _sub(src, r"(    consumers_sync\(\);\n)(    if \(\*flag\) \{)",
               r"\1    if (tid == 0) tr[6] = clock64() - c0;\n\2")
    src = _sub(src, r"(    consumers_sync\(\);  // the flag and the reduction buffers are reused\n)",
               r"\1    if (tid == 0) { tr[7] = clock64() - c0; tr[9] = gtime(); }\n")
    if no_compute:
        src, n = re.subn(r"for \(int (s0|s16) = 0; \1 < rv;", r"for (int \1 = 0; \1 < 0;", src)
        if not n:
            raise ValueError("paged_trace: no loop over a box's rows to drop")
    return src


def run(lib: str, wide: bool = False):
    """Trace one instrumented library (in a child process)."""
    import chip_smoke as cs
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    _build._loaded["paged_attention"] = ctypes.CDLL(lib)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = cs.WIDE_PAGED_CASES if wide else [(label, ln, {}) for label, ln in cs.PAGED_TIMED]
    for label, lengths, shape in cases:
        q, pk, pv, table, ln = cs.attention_inputs(gen, lengths, **shape)
        layers, lanes, H, hd = q.shape
        Hk = pk.shape[3]
        grid = pa._grid_for(q[0], pk[0], table)
        pairs = lanes * Hk * -(-(H // Hk) // pa.heads_per_pass(H, Hk))
        n = (grid + pairs) * 8 * (hd + 2)
        part = torch.zeros(n + grid * 32, dtype=torch.float32, device="cuda")
        pa._scratch[(q.device.index, lanes, H, Hk, hd, grid)] = (
            part, torch.zeros(pairs, dtype=torch.int32, device="cuda"))
        for i in range(8):
            pa.paged_decode_attention(q[i % layers], pk[i % layers], pv[i % layers], table, ln)
        torch.cuda.synchronize()
        tr = part[n:].view(torch.int64).view(grid, 16).cpu()
        start = (tr[:, 0] - tr[:, 0].min()).double() / 1e3
        end = (tr[:, 9] - tr[:, 0].min()).double() / 1e3
        print(f"== {label}: {grid} blocks; start us median {start.median():.2f} max "
              f"{start.max():.2f}; end us median {end.median():.2f} max {end.max():.2f}")
        for k, name in enumerate(MARKS, 1):
            col = tr[:, k].double()
            col = col[col > 0]
            if len(col):
                print(f"   {name:28s} cycles: median {col.median():.0f} max {col.max():.0f} "
                      f"({len(col)} blocks)")
        boxes = tr[:, 12].double()
        busy = boxes > 0
        wait = tr[busy, 11].double() / boxes[busy]
        span = (tr[busy, 4] - tr[busy, 3]).double() / (boxes[busy] - 1).clamp(min=1)
        print(f"   consumer wait a box cycles: median {wait.median():.0f}; first to last box "
              f"a box: median {span.median():.0f}")
    del _build._loaded["paged_attention"]


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--run"]:
        run(argv[-1], wide="--wide" in argv)
        return 0
    import chip_smoke as cs

    from paddle_tpu_torch.ops import _build

    print(cs.nvidia_smi(), flush=True)
    flags = [a for a in argv[:2] if a in ("--wide", "--no-compute")]
    no_compute = "--no-compute" in flags
    sources = argv[len(flags):] or [str(_build.CSRC / "paged_attention.cu")]
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    for i, src in enumerate(sources):
        copy = out / f"trace{i}.cu"
        copy.write_text(instrument(Path(src).read_text(), no_compute))
        lib = out / f"libtrace{i}.so"
        subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib), str(copy)], check=True, capture_output=True)
        print(f"== {src}{' (no compute)' if no_compute else ''}", flush=True)
        r = subprocess.run(["timeout", "-k", "5", "150", sys.executable, "-m",
                            "paddle_tpu_torch.tools.paged_trace", "--run",
                            *[f for f in flags if f == "--wide"], str(lib)],
                           capture_output=True, text=True, cwd=str(ROOT))
        print(r.stdout.strip() or f"exit {r.returncode}\n{r.stderr[-800:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
