"""``paddle.summary`` (counterpart of ``paddle_tpu/hapi/summary.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print each parameter's name, shape and size, and the totals; return
    ``{"total_params", "trainable_params"}`` (trainable: ``requires_grad``).
    The input arguments are taken and not used, as in the reference."""
    total_params = trainable_params = 0
    rows = []
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.dim() else 1
        total_params += n
        if p.requires_grad:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':<12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:<12}")
    print("-" * (width + 36))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    return {"total_params": total_params, "trainable_params": trainable_params}
