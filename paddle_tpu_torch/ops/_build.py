"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own by ``nvcc`` into ``paddle_tpu_torch/_build/``, the
first time a kernel is used (or when :func:`build` is called first, as
``chip_smoke.py`` does). The library's file name carries a digest of its
source and flags, so an edited source is rebuilt and never mixed with an
old library. Nothing is built when a module is imported: the CPU tests
import every module, and a machine without a card has no ``nvcc``.

A failed build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["KERNELS", "build", "launch_stream", "load", "nvcc_path"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("paged_attention", "quant_matmul", "flash_attention", "rms_norm", "swiglu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel that has no current library, one
    ``nvcc`` per source, all started together. Returns ``{name: compiler
    output}`` (``-Xptxas -v``: registers, shared memory, spills) for the
    sources compiled by this call."""
    nvcc = None
    procs = {}
    logs = {}
    try:
        for name in names:
            src, lib = _library(name)
            if lib.exists():
                continue
            nvcc = nvcc or nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, lib)
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
            os.replace(tmp, lib)
            logs[name] = out
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
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
