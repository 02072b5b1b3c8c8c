"""Context parallelism over the mesh's ``sep`` axis.

Counterpart of ``paddle_tpu/distributed/fleet/sequence_parallel.py``
:139-169 ``ring_context_attention`` only. Megatron-style sequence
parallelism and the Ulysses all-to-all change nothing inside one process
and wait, with the transport that moves shards between cards, for the
distributed slice of the port.
"""

from __future__ import annotations

from ...amp import cast_inputs
from ...ops.ring_attention import ring_attention
from ..mesh import get_mesh

__all__ = ["ring_context_attention"]


def ring_context_attention(q, k, v, causal: bool = True, axis_name: str = "sep"):
    """Attention of q [b, s, h, d] over k, v [b, s, hk, d] as a ring over
    the current mesh's ``axis_name`` (its size is the number of ranks,
    each holding s / size positions); returns [b, s, h, d]. GQA is handled
    inside the ring. Under ``amp.auto_cast`` q, k and v are first cast as
    the op ``ring_attention``."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("ring_context_attention requires an active mesh")
    if axis_name not in mesh.dim_names:
        raise ValueError(f"mesh has no {axis_name!r} axis for context parallel")
    q, k, v = cast_inputs("ring_attention", q, k, v)
    return ring_attention(q, k, v, mesh.get_dim_size(axis_name), causal=causal)
