"""Serving work unit: one generation request and its lifecycle.

A :class:`Request` is the serving analogue of the simulator's job: it
arrives at a point in time, carries a prompt, wants ``max_new_tokens``
decoded, and occupies a growing slice of device memory (its KV cache)
while running.  The lifecycle is::

    QUEUED --admit--> RUNNING --last token--> FINISHED
       ^                 |
       +----preempt------+   (evict-and-requeue with recompute)

Preemption keeps the tokens decoded so far — on re-admission the engine
recomputes their KV by prefilling ``prompt + generated`` (the vLLM-style
recompute policy), so no emitted token is ever lost, only the time spent
building its cache.

Requests are duck-typed for the :mod:`repro_torch.sched.placement` registry
(``arrival`` / ``c_iso`` / ``items`` / ``unassigned``), so the same
fcfs/sjf/best-fit/arrival-aware policies that order simulator jobs order
the serving queue — and pick preemption victims (lowest-priority =
last in placement order).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    prompt: Optional[List[int]] = None      # token ids (jax backend)
    # --- SLO deadlines (None = unconstrained) ----------------------------
    #: max seconds from arrival to the first token (queueing + prefill)
    ttft_deadline: Optional[float] = None
    #: max mean seconds per output token after the first (decode cadence)
    tpot_deadline: Optional[float] = None
    #: owning tenant for fairness accounting (None = untenanted; all
    #: such requests share one default bucket — see sched.tenancy)
    tenant: Optional[str] = None

    # --- lifecycle (owned by the engine) ---------------------------------
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)  # generated so far
    admissions: int = 0        # times admitted (first + re-admissions)
    preemptions: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    def __post_init__(self):
        if self.prompt_len <= 0:
            raise ValueError(f"request {self.rid}: prompt_len must be > 0")
        if self.max_new_tokens <= 0:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be > 0")

    # --- derived sizes ----------------------------------------------------
    @property
    def tokens_decoded(self) -> int:
        return len(self.tokens)

    @property
    def context_len(self) -> int:
        """Tokens currently holding KV slots: prompt + decoded."""
        return self.prompt_len + self.tokens_decoded

    @property
    def prefill_len(self) -> int:
        """Tokens to (re)compute on admission.  After a preemption this
        includes the already-generated tokens (recompute policy)."""
        return self.context_len

    @property
    def remaining_new(self) -> int:
        return max(self.max_new_tokens - self.tokens_decoded, 0)

    @property
    def done(self) -> bool:
        return self.tokens_decoded >= self.max_new_tokens

    # --- SLO attainment ---------------------------------------------------
    def meets_slo(self) -> bool:
        """True when every declared deadline held for this (finished)
        request: TTFT within ``ttft_deadline``, mean decode cadence
        within ``tpot_deadline`` (vacuous with a single token).  A
        request with no deadlines always meets its (empty) SLO."""
        if self.ttft_deadline is not None:
            if self.first_token_t is None or \
                    self.first_token_t - self.arrival > self.ttft_deadline:
                return False
        if self.tpot_deadline is not None and self.tokens_decoded > 1:
            if self.finish_t is None or self.first_token_t is None:
                return False
            tpot = (self.finish_t - self.first_token_t) \
                / (self.tokens_decoded - 1)
            if tpot > self.tpot_deadline:
                return False
        return True

    # --- placement-registry duck typing ----------------------------------
    @property
    def c_iso(self) -> float:
        """Isolated 'service time' proxy: total tokens to process."""
        return float(self.prompt_len + self.max_new_tokens)

    @property
    def items(self) -> float:
        return float(self.prompt_len + self.max_new_tokens)

    @property
    def unassigned(self) -> float:
        """Remaining work, so SJF ranks by what is left, not what was."""
        return float(self.prompt_len + self.remaining_new)

    def __repr__(self) -> str:
        return (f"Request(rid={self.rid}, prompt={self.prompt_len}, "
                f"new={self.tokens_decoded}/{self.max_new_tokens}, "
                f"state={self.state.value})")
