"""Compare variants of ``csrc/flash_attention.cu`` on one GPU, in one run.

Usage, from the root of a checkout on a machine with a card::

    python -m paddle_tpu_torch.tools.kernel_ab VARIANT.cu [VARIANT.cu ...]

Each variant is a copy of ``paddle_tpu_torch/csrc/flash_attention.cu``
with the same C interface. All are compiled together with the build's own
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
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (1, 8192, 32, 8, 128)          # B, S, H, Hk, head_dim of the timing
CHECKS = ((1, 2048, 32, 8, 128, True, "bf16"), (2, 1000, 8, 2, 64, False, "fp16"),
          (1, 127, 4, 1, 128, True, "bf16"))


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
        procs[src] = (subprocess.Popen([nvcc, *_build.FLAGS, "-o", str(lib), src],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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


def sdpa_ms(gen):
    import chip_smoke as cs
    import torch
    import torch.nn.functional as F

    B, S, H, Hk, hd = SHAPE
    q, do = (torch.randn((B, H, S, hd), generator=gen, device="cuda").bfloat16() for _ in "ab")
    k, v = (torch.randn((B, Hk, S, hd), generator=gen, device="cuda").bfloat16() for _ in "ab")
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


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--run"]:
        run_variant(argv[1])
        return 0
    import chip_smoke as cs
    import torch

    print(cs.nvidia_smi(), flush=True)
    from paddle_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(argv, out_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("sdpa fwd/bwd ms", sdpa_ms(gen), flush=True)
    for src, lib in libs.items():
        r = subprocess.run(["timeout", "-k", "5", "150", sys.executable, "-m",
                            "paddle_tpu_torch.tools.kernel_ab", "--run", str(lib)],
                           capture_output=True, text=True, cwd=str(ROOT))
        print(r.stdout.strip() or f"{src}: exit {r.returncode}\n{r.stderr[-800:]}", flush=True)
    print("sdpa fwd/bwd ms", sdpa_ms(gen), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
