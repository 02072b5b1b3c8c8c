"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

The reference package ``paddle_tpu`` stays beside it, unchanged. This
package imports only torch and numpy. Its first slice served Llama
decoding; later slices added training, fine-tuning, the nn, optimizer and
amp surfaces, the vision models and the high-level API:

- :mod:`paddle_tpu_torch.models.llama`: configuration, parameter holder
  and the functional single-token decode;
- :mod:`paddle_tpu_torch.inference.serving`: the continuous-batching
  engine over a block-paged KV cache;
- :mod:`paddle_tpu_torch.ops`: the hand-written Hopper kernels (sources
  in ``csrc/``) with their wrappers and plain PyTorch versions;
- :mod:`paddle_tpu_torch.distributed`: recompute, the Mixture-of-Experts
  layer (``distributed.fleet.MoELayer``) and the ring, on one device;
- ``Model`` (``hapi``), ``io.DataLoader``, ``metric``, ``save`` and
  ``load``, ``get_flags`` and ``set_flags``, as ``paddle.*`` has them.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from . import (amp, distributed, flags, framework, hapi, io, jit, metric, models, nn,
               optimizer, utils, vision)
from .flags import get_flags, set_flags
from .framework.io import load, save
from .hapi import Model, summary

__all__ = ["amp", "distributed", "flags", "framework", "hapi", "io", "jit", "metric", "models",
           "nn", "optimizer", "utils", "vision", "Model", "summary", "save", "load",
           "get_flags", "set_flags"]
