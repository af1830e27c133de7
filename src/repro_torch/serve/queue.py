"""Arrival-fed request queue with pluggable placement ordering.

Bridges :mod:`repro_torch.sched.arrivals` (timed streams over an application
universe) to the serving engine: :func:`requests_from_arrivals` maps each
:class:`~repro_torch.sched.arrivals.Arrival` to a :class:`Request` whose prompt
length derives from the arrival's input size, and :class:`RequestQueue`
releases requests as virtual time passes, handing the engine a pending
list ordered by a :class:`~repro_torch.sched.placement.PlacementPolicy`
(fcfs / sjf / best-fit / arrival-aware — the same registry the cluster
simulator uses).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.sched.arrivals import Arrival
from repro_torch.sched.placement import PlacementPolicy, get_placement
from repro_torch.serve.request import Request, RequestState


def requests_from_arrivals(arrivals: Sequence[Arrival], *,
                           max_new_tokens: int = 32,
                           prompt_scale: float = 1.0,
                           min_prompt: int = 1,
                           max_prompt: Optional[int] = None,
                           seed: int = 0,
                           vary_new: bool = True) -> List[Request]:
    """Turn a sched arrival stream into serving requests.

    ``items`` (M-items in the cluster universes) becomes the prompt
    length via ``prompt_scale`` (clamped to ``[min_prompt, max_prompt]``);
    ``max_new_tokens`` is drawn uniformly from ``[max_new/2, max_new]``
    per request when ``vary_new`` (heterogeneous decode lengths are what
    make continuous batching beat waves), else fixed.
    """
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for i, a in enumerate(sorted(arrivals, key=lambda x: x.t)):
        plen = int(round(float(a.items) * prompt_scale))
        plen = max(plen, min_prompt)
        if max_prompt is not None:
            plen = min(plen, max_prompt)
        new = int(rng.integers(max(max_new_tokens // 2, 1),
                               max_new_tokens + 1)) if vary_new \
            else int(max_new_tokens)
        out.append(Request(rid=i, prompt_len=plen, max_new_tokens=new,
                           arrival=float(a.t),
                           tenant=getattr(a, "tenant", None)))
    return out


class RequestQueue:
    """Time-gated pending queue over a fixed request population.

    ``release(now)`` moves arrived requests into the pending set;
    ``pending(now)`` returns them in placement order (re-ordered every
    call — arrival-aware urgency changes as time passes); ``requeue``
    returns a preempted request.  The queue never drops a request: every
    request handed in is eventually surfaced by ``pending`` until the
    engine marks it FINISHED.
    """

    def __init__(self, requests: Sequence[Request],
                 placement: Union[str, PlacementPolicy] = "fcfs"):
        self.placement = get_placement(placement) \
            if isinstance(placement, str) else placement
        self._future: List[Request] = sorted(requests,
                                             key=lambda r: (r.arrival, r.rid))
        self._pending: List[Request] = []

    # --- time ------------------------------------------------------------
    def release(self, now: float) -> int:
        """Move requests with ``arrival <= now`` into the pending set."""
        out = self.drain_released(now)
        self._pending.extend(out)
        return len(out)

    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival if self._future else None

    def drain_released(self, now: float) -> List[Request]:
        """Pop requests with ``arrival <= now`` and return them in
        arrival order WITHOUT entering the pending set — the
        multi-replica engine routes each released request to a node's
        own pending list instead (``repro_torch.sched.cluster`` Router)."""
        out: List[Request] = []
        while self._future and self._future[0].arrival <= now + 1e-12:
            out.append(self._future.pop(0))
        return out

    # --- pending ---------------------------------------------------------
    def pending(self, now: float = 0.0,
                joinable: Optional[Callable[[Request], bool]] = None
                ) -> List[Request]:
        """Released-but-not-running requests in placement order, optionally
        filtered by a backend joinability predicate."""
        reqs = self.placement.order_jobs(list(self._pending), now=now)
        if joinable is not None:
            reqs = [r for r in reqs if joinable(r)]
        return reqs

    def take(self, reqs: Sequence[Request]) -> None:
        """Remove admitted requests from the pending set."""
        admitted = {id(r) for r in reqs}
        self._pending = [r for r in self._pending
                         if id(r) not in admitted]

    def requeue(self, req: Request) -> None:
        """Return a preempted request (keeps its generated tokens; its KV
        will be recomputed on re-admission)."""
        req.state = RequestState.QUEUED
        self._pending.append(req)

    # --- bookkeeping ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._future) + len(self._pending)

    @property
    def drained(self) -> bool:
        return not self._future and not self._pending
