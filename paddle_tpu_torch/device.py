"""Where the port runs (counterpart of ``paddle_tpu/device.py``).

Two kinds of entry point:

- the older ones (models, layers, engines, loaders) take ``device=`` and
  default to ``"cuda"``: they run on the CPU only when the caller passes
  ``device="cpu"``;
- the Paddle op surface (``to_tensor``, the creation ops,
  ``create_parameter``, ``Layer.create_parameter``) follows the default
  device, which is the first card (``get_device() == "gpu:0"``) until
  :func:`set_device` says otherwise. Without a card it raises; it never
  drops to the CPU by itself.

``synchronize``, ``Event``, ``Stream`` and ``current_stream`` are
torch.cuda's.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_device", "get_device", "default_device", "place_device",
           "device_count", "get_all_devices", "is_compiled_with_cuda",
           "is_compiled_with_xpu", "synchronize", "Event", "Stream", "current_stream"]

_current: str | None = None          # None: "gpu:0"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist. Entry
    points default to ``"cuda"`` and run on the CPU only when asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch runs on the GPU "
            "by default; pass device='cpu' to run the plain CPU path")
    return dev


def _canonical(spec) -> str:
    """Paddle's name of a device: ``"cpu"`` or ``"gpu:N"``."""
    if isinstance(spec, torch.device):
        return "cpu" if spec.type == "cpu" else f"gpu:{spec.index or 0}"
    s = str(spec).lower()
    if s == "cpu" or s.startswith("cpu:"):
        return "cpu"
    kind, _, idx = s.partition(":")
    if kind not in ("gpu", "cuda"):
        raise ValueError(f"unknown device {spec!r}: expected 'cpu', 'gpu' or 'gpu:N'")
    return f"gpu:{int(idx) if idx else 0}"


def _torch_device(name: str) -> torch.device:
    return torch.device("cpu") if name == "cpu" else resolve_device("cuda:" + name[4:])


def set_device(device) -> torch.device:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:N"``, ``"cuda:N"`` or a
    torch.device) the default of the op surface; returns it as a
    torch.device. A card that does not exist raises."""
    global _current
    name = _canonical(device)
    dev = _torch_device(name)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{device!r}: only {torch.cuda.device_count()} card(s)")
    _current = name
    return dev


def get_device() -> str:
    """The default device's Paddle name: ``"gpu:0"`` unless set."""
    return _current or "gpu:0"


def default_device() -> torch.device:
    """The default device as a torch.device (raises without a card when
    the default is one)."""
    return _torch_device(get_device())


def place_device(place=None) -> torch.device:
    """A torch.device from Paddle's ``place``: None (the default device),
    a name, a torch.device, ``CPUPlace``, ``CUDAPlace(i)`` or
    ``CUDAPinnedPlace`` (host memory)."""
    if place is None:
        return default_device()
    if isinstance(place, torch.device):
        return place if place.type == "cpu" else resolve_device(place)
    kind = getattr(place, "_kind", None)
    if kind is not None:
        return _torch_device(kind)
    return _torch_device(_canonical(place))


def device_count() -> int:
    return torch.cuda.device_count()


def get_all_devices() -> list:
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def is_compiled_with_cuda() -> bool:
    """Whether this torch was built with CUDA (not whether a card is
    present)."""
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu() -> bool:
    return False


def synchronize(device=None):
    """Wait for every kernel queued on the card (``device`` as
    :func:`place_device` reads it; None: the current card)."""
    dev = None if device is None else place_device(device)
    if dev is None or dev.type == "cuda":
        torch.cuda.synchronize(dev)


Event = torch.cuda.Event
Stream = torch.cuda.Stream


def current_stream(device=None):
    return torch.cuda.current_stream(None if device is None else place_device(device))
