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
- ``Model`` (``hapi``), ``io.DataLoader``, ``metric``, ``save`` and
  ``load``, as ``paddle.*`` has them.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from . import amp, framework, hapi, io, jit, metric, nn, optimizer, utils, vision
from .framework.io import load, save
from .hapi import Model, summary

__all__ = ["amp", "framework", "hapi", "io", "jit", "metric", "nn", "optimizer", "utils",
           "vision", "Model", "summary", "save", "load"]
