"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``), in the reference's pickle format.

A tensor is pickled as ``{"__paddle_tpu_tensor__": True, "data": ndarray,
"stop_gradient": bool, "name": str}`` inside nested dicts, lists and
tuples, and everything else as itself, so a ``.pdparams`` or ``.pdopt``
written by either package loads in the other. bf16 arrays are numpy's
``ml_dtypes.bfloat16``, as the reference writes them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_SENTINEL = "__paddle_tpu_tensor__"


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_host(obj):
    if torch.is_tensor(obj):
        return {_SENTINEL: True, "data": _numpy(obj), "stop_gradient": not obj.requires_grad,
                "name": ""}
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _from_host(obj, return_numpy: bool):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL):
            return obj["data"] if return_numpy else _tensor(obj["data"])
        return {k: _from_host(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` (its directory made if missing), each
    tensor copied to the host in the reference's tensor record."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """What :func:`save` (or the reference's ``save``) wrote to ``path``:
    each tensor record as a CPU tensor, or as its numpy array with
    ``return_numpy=True``. Unpickling runs code: load only files that this
    program or the reference wrote."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_host(obj, return_numpy)
