"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

The reference package ``paddle_tpu`` stays beside it, unchanged. This
package imports only torch and numpy. Its first slice served Llama
decoding; later slices added training, fine-tuning, the nn, optimizer and
amp surfaces, the vision models, the high-level API and the op surface:

- the top level, as ``paddle.*`` has it: ``to_tensor``, ``Tensor``
  (``torch.Tensor``), ``Parameter``, the dtype names, the default dtype
  and device (``set_device`` / ``get_device``: the card unless set),
  ``seed`` and the generators' states, the grad modes and ``grad``, the
  places, ``create_parameter``, and every op of the registry
  (``paddle_tpu_torch.ops``: ``matmul``, ``reshape``, ``concat``, ... and
  their ``<op>_`` in-place companions);
- :mod:`paddle_tpu_torch.nn`: ``Layer`` (a ``torch.nn.Module`` with
  Paddle's methods), the layers, ``ParamAttr``, ``initializer``,
  ``functional``;
- :mod:`paddle_tpu_torch.models.llama`: configuration, parameter holder
  and the functional single-token decode;
- :mod:`paddle_tpu_torch.inference.serving`: the continuous-batching
  engine over a block-paged KV cache;
- :mod:`paddle_tpu_torch.ops`: the hand-written Hopper kernels (sources
  in ``csrc/``) with their wrappers and plain PyTorch versions, and the op
  surface;
- :mod:`paddle_tpu_torch.distributed`: recompute, the Mixture-of-Experts
  layer (``distributed.fleet.MoELayer``) and the ring, on one device;
- ``Model`` (``hapi``), ``io.DataLoader``, ``metric``, ``save`` and
  ``load``, ``get_flags`` and ``set_flags``;
- :mod:`paddle_tpu_torch.profiler`: the observability plane (telemetry,
  spans, goodput, the flight recorder, the timeline, the numerics
  sentinels, attribution, ``Profiler`` and ``RecordEvent``).

Nothing is patched onto ``torch.Tensor``: Paddle's tensor methods
(``x.astype``, ``x.stop_gradient``, ...) are the top-level functions here
(``cast(x, ...)``, ``requires_grad``). The model, layer and engine entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the op surface follows the default device.
"""

import builtins as _builtins

from . import dtype as _dtype_ns
from .dtype import (bfloat16, bool_, complex64, complex128, float8_e4m3fn, float8_e5m2,
                    float16, float32, float64, get_default_dtype, int8, int16, int32, int64,
                    set_default_dtype, uint8)
from .tensor import Parameter, Tensor, to_tensor
from .flags import get_flags, set_flags
from .ops import *  # noqa: F403
from .ops import __all__ as _ops_all
from . import autograd, device, framework
from .autograd import enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled
from .device import get_device, is_compiled_with_cuda, is_compiled_with_xpu, set_device
from .framework.random import (get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
                               set_rng_state)
from .framework.misc import (CPUPlace, CUDAPinnedPlace, CUDAPlace, LazyGuard, batch,
                             check_shape, create_parameter, disable_signal_handler, finfo,
                             iinfo, set_printoptions, tolist)
from . import (amp, distributed, flags, hapi, io, jit, metric, models, nn, optimizer,
               profiler, utils, vision)
from .framework.io import load, save
from .hapi import Model, summary
from .nn import ParamAttr
from ._ops_attach import attach_nn_functional as _attach_nn_functional

_attach_nn_functional()

bool = bool_  # noqa: A001 (paddle.bool)
tensor = to_tensor


def disable_static(*args, **kwargs):
    """Eager is the port's only mode."""


def enable_static(*args, **kwargs):
    raise NotImplementedError("the port runs eagerly; jit.TrainStep captures a whole step")


def in_dynamic_mode():
    return True


__version__ = "0.1.0"

__all__ = sorted(_builtins.set(_ops_all) | {
    "amp", "autograd", "device", "distributed", "flags", "framework", "hapi", "io", "jit",
    "metric", "models", "nn", "optimizer", "utils", "vision", "Model", "summary", "save",
    "load", "get_flags", "set_flags", "Tensor", "Parameter", "to_tensor", "tensor",
    "bfloat16", "float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
    "bool", "bool_", "complex64", "complex128", "float8_e4m3fn", "float8_e5m2",
    "get_default_dtype", "set_default_dtype", "no_grad", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "grad", "get_device", "set_device", "is_compiled_with_cuda",
    "is_compiled_with_xpu", "seed", "get_rng_state", "set_rng_state", "get_cuda_rng_state",
    "set_cuda_rng_state", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "LazyGuard", "batch",
    "check_shape", "create_parameter", "disable_signal_handler", "finfo", "iinfo",
    "set_printoptions", "tolist", "ParamAttr", "disable_static", "enable_static",
    "in_dynamic_mode"})
