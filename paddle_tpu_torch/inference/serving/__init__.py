"""Continuous-batching LLM serving over a block-paged KV cache
(counterpart of ``paddle_tpu/inference/serving``, flat single-device
engine).

- :mod:`engine`: ServeConfig and ServingEngine, the submit/step/run/cancel
  API with chunked prefill and one decode step per scheduler iteration,
  the two programs (decode, prefill) as CUDA graphs on the card;
- :mod:`kv_cache`: PagedKVCache, the page pool and block allocator, and
  Staged, the programs' static input buffers;
- :mod:`sampling`: the per-lane sampling head of the decode program;
- :mod:`paged_attention`: PagedKVView, gather_lane_window, prefill_attend;
- :mod:`scheduler`: admission and retirement policy;
- :mod:`request`: the Request lifecycle handle and SamplingParams.
"""

from .engine import ServeConfig, ServingEngine  # noqa: F401
from .kv_cache import PagedKVCache  # noqa: F401
from .paged_attention import (  # noqa: F401
    PagedKVView, gather_lane_window, prefill_attend,
)
from .request import Request, SamplingParams  # noqa: F401
from .scheduler import Scheduler  # noqa: F401

__all__ = ["ServeConfig", "ServingEngine", "PagedKVCache", "PagedKVView",
           "Request", "SamplingParams", "Scheduler", "gather_lane_window",
           "prefill_attend"]
