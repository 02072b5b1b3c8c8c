"""Serving request lifecycle (counterpart of
``paddle_tpu/inference/serving/request.py``).

A :class:`Request` is the caller's handle for one generation job. State
moves strictly forward::

    WAITING -> PREFILLING -> RUNNING -> DONE
        \\          \\            \\-----> FAILED | CANCELLED
         \\          \\----------------> FAILED | CANCELLED
          \\---------------------------> FAILED | CANCELLED
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "Request", "SamplingParams", "WAITING", "PREFILLING", "RUNNING",
    "DONE", "FAILED", "CANCELLED", "TERMINAL",
]

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
#: states a request can never leave
TERMINAL = (DONE, FAILED, CANCELLED)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding strategy. This slice of the port decodes
    greedily only: the engine accepts params that mean greedy
    (``do_sample=False``, ``temperature <= 0`` or ``top_k == 1``) and
    raises on any other."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    do_sample: bool = True

    @property
    def greedy(self) -> bool:
        return (not self.do_sample or self.temperature <= 0.0
                or self.top_k == 1)


@dataclass
class Request:
    """One generation job: ``prompt`` token ids in, up to
    ``max_new_tokens`` continuations out (EOS included when it fires)."""

    id: int
    prompt: list
    max_new_tokens: int
    status: str = WAITING
    generated: list = field(default_factory=list)
    error: str | None = None
    lane: int | None = None
    #: prompt tokens already chunk-prefilled into the lane's pages
    prefill_pos: int = 0
    submitted_step: int | None = None
    finished_step: int | None = None
    #: perf_counter seconds at lane admission
    admit_time: float | None = None
    #: SLO class, 0 = most urgent (ascending priority admits first)
    priority: int = 1
    #: absolute completion deadline (perf_counter seconds) or None
    deadline: float | None = None
    slo_class: str | None = None
    sampling: SamplingParams | None = None
    #: the request's id in the timeline's spans and events, minted at submit
    trace_id: str | None = None
    #: perf_counter seconds at submit: the zero point of TTFT
    submit_time: float | None = None
    #: perf_counter seconds when the first decoded token landed
    first_token_time: float | None = None
    #: perf_counter seconds at the terminal transition
    finish_time: float | None = None

    @property
    def slo_label(self) -> str:
        """The SLO class, else ``p<priority>`` (the label of
        ``serve.slo_miss{class}``)."""
        return self.slo_class if self.slo_class else f"p{self.priority}"

    @property
    def tokens(self) -> list:
        """Full sequence: prompt + everything generated so far."""
        return list(self.prompt) + list(self.generated)

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.generated)}, lane={self.lane})")
