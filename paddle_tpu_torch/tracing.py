"""Whether the running code is the port's counterpart of a traced call.

The reference picks some kernels by whether a call is traced: its
``rms_norm`` takes the fused Pallas kernel only for eager calls and the
composed form under a jit trace, the compiled ``TrainStep`` and
``EvalStep`` included. PyTorch runs eagerly, so the port marks that region
itself: ``jit.TrainStep`` and ``jit.EvalStep`` run each call inside
:func:`traced`, and :func:`is_traced` reads the mark.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["traced", "is_traced", "marked"]

_state = threading.local()


@contextlib.contextmanager
def traced():
    """Run the body as a traced call (nests)."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


@contextlib.contextmanager
def marked(flag: bool):
    """Run the body traced if ``flag`` is true and untraced if not, whatever
    this thread's mark (a recomputed forward runs in autograd's thread and
    takes the mark of the forward it repeats)."""
    depth = getattr(_state, "depth", 0)
    _state.depth = int(bool(flag))
    try:
        yield
    finally:
        _state.depth = depth


def is_traced() -> bool:
    return getattr(_state, "depth", 0) > 0
