"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own by ``nvcc`` into ``paddle_tpu_torch/_build/``, the
first time a kernel is used (or when :func:`build` is called first, as
``chip_smoke.py`` does). A source listed in ``PARTS`` is compiled as that
many translation units (``-DKERNEL_PART=0 .. n - 1``, one nvcc each,
started with the others) and linked into one library, so that its many
kernel instantiations do not hold the build up on one core. The library's file name carries a digest of its
source and flags, so an edited source is rebuilt and never mixed with an
old library; the shared headers ``csrc/*.cuh`` count as part of every
source. Nothing is built when a module is imported: the CPU tests
import every module, and a machine without a card has no ``nvcc``.

A failed build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "build", "launch_stream", "library_path", "load", "nvcc_path"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("paged_attention", "quant_matmul", "flash_attention", "rms_norm", "swiglu",
           "ring_merge")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources compiled in parts: {name: number of parts}
PARTS = {"flash_attention": 9, "paged_attention": 2}

_loaded: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built with the "
            "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()
                            + str(PARTS.get(name, 0)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` for the current source is built."""
    return _library(name)[1]


def _compiles(nvcc: str, name: str, src: Path, tmp: Path) -> tuple[list, list]:
    """(commands, objects) that compile one source: one nvcc into the
    library, or one per part into objects that :func:`build` links."""
    n = PARTS.get(name, 0)
    if not n:
        return [[nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]], []
    flags = [f for f in FLAGS if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.{p}.o") for p in range(n)]
    return [[nvcc, *flags, "-c", f"-DKERNEL_PART={p}", "-I", str(CSRC), "-o", str(obj),
             str(src)] for p, obj in enumerate(objs)], objs


def build(names=KERNELS) -> dict:
    """Compile every named kernel that has no current library, one
    ``nvcc`` per source or part, all started together. Returns ``{name:
    (compiler output, seconds)}`` for the sources compiled by this call:
    the output of ``-Xptxas -v`` (registers, shared memory, spills) of
    every part, and the wall time from the start of the call to the end of
    that source's compile and link."""
    nvcc = None
    jobs = {}
    logs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            src, lib = _library(name)
            if lib.exists():
                continue
            nvcc = nvcc or nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmds, objs = _compiles(nvcc, name, src, tmp)
            procs = []
            for i, cmd in enumerate(cmds):
                log = open(tmp.with_name(f"{tmp.name}.{i}.log"), "w+")
                procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                               text=True), log))
            jobs[name] = (procs, tmp, lib, objs)
        while len(logs) < len(jobs):
            for name, (procs, tmp, lib, objs) in jobs.items():
                if name in logs or any(proc.poll() is None for proc, _ in procs):
                    continue
                out = ""
                for proc, log in procs:
                    log.seek(0)
                    out += log.read()
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
                if objs:
                    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                           *map(str, objs)], capture_output=True, text=True)
                    if link.returncode != 0:
                        raise RuntimeError(f"linking {name} failed (exit {link.returncode}):\n"
                                           f"{link.stdout}{link.stderr}")
                os.replace(tmp, lib)
                logs[name] = (out, time.perf_counter() - t0)
            time.sleep(0.05)
    finally:
        for procs, tmp, _, objs in jobs.values():
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
                Path(log.name).unlink(missing_ok=True)
            for path in (tmp, *objs):
                path.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_library(name)[1]))
        _loaded[name] = lib
    return lib


def launch_stream(device: torch.device) -> int:
    """Raw handle of the current CUDA stream, on which a kernel for
    tensors on ``device`` is launched. The kernel launches on the current
    device, so that must be ``device``."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(
            f"kernel inputs are on {device} but the current CUDA device is "
            f"cuda:{current}; call under torch.cuda.device({device})")
    return torch.cuda.current_stream().cuda_stream
