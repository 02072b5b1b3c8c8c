"""Where the port's entry points run.

Entry points default to ``device="cuda"`` and run on the CPU only when the
caller asks for it (the tests do, with the kernels' plain versions).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist. Entry
    points default to ``"cuda"`` and run on the CPU only when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch runs on the GPU "
            "by default; pass device='cpu' to run the plain CPU path")
    return dev
