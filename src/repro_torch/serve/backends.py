"""Execution backends for the serving engine.

The engine's scheduling loop (queue -> batcher -> step) is backend
agnostic; a backend owns *how* a step actually runs and how long it
takes, behind three operations::

    join(reqs, now)   # (re)compute KV for joining requests -> seconds
    decode(running)   # one token for every running request  -> seconds
    remove(reqs)      # release finished/preempted slots

* :class:`SimBackend` — virtual-time cost model, no torch import.  Step
  cost is ``base + per_seq * batch``; prefill cost is per token.

``_bucket`` / ``_shrink_bucket`` round batch capacity to powers of two
(with shrink hysteresis), which the model backends use to keep tensor
shapes few.  The model backend of this port is
:class:`~repro_torch.serve.paged.TorchPagedBackend`; the dense-cache
backend comes with the dense-cache serving slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.request import Request

PAD_ID = 3  # matches launch/serve.py's filler token


class Backend:
    """Interface; see module docstring.  ``join_stride`` quantizes the
    engine's join opportunities (1 = any step)."""

    join_stride: int = 1

    @property
    def empty(self) -> bool:
        """True when no request occupies a slot — the engine applies the
        restart cohort rules instead of the mid-stream ``joinable``
        filter.  Stateless backends are always 'empty'."""
        return True

    def joinable(self, req: Request) -> bool:
        return True

    def filter_joinable(self, pending: Sequence[Request]
                        ) -> List[Request]:
        """Pending requests this backend can join mid-stream, in the
        given (placement) order.  Backends with a *collective* join
        constraint (e.g. a shared page pool) override this; the default
        applies the per-request ``joinable`` predicate."""
        return [r for r in pending if self.joinable(r)]

    def restart_cohort(self, pending: Sequence[Request]
                       ) -> List[Request]:
        """Empty-backend restart: the greedy prefix of ``pending`` that
        can restart together.  The dense default packs a shared position
        window (max prefill + max remaining <= max_len); stateless
        backends take everything."""
        max_len = getattr(self, "max_len", None)
        if max_len is None:
            return list(pending)
        out: List[Request] = []
        maxp = maxr = 0
        for r in pending:
            p = max(maxp, r.prefill_len)
            n = max(maxr, r.remaining_new)
            if p + n <= max_len:
                out.append(r)
                maxp, maxr = p, n
        return out

    def join(self, reqs: Sequence[Request], now: float) -> float:
        raise NotImplementedError

    def decode(self, running: Sequence[Request]) -> float:
        raise NotImplementedError

    def remove(self, reqs: Sequence[Request]) -> None:
        pass

    # --- KV migration (repro_torch.sched.topology) ------------------------------
    #: True when this backend can take over a request whose KV arrived
    #: over the network (migration target).  Real-cache backends that
    #: cannot materialize foreign KV leave this False — the engine then
    #: falls back to recompute-on-join for them.
    can_adopt: bool = False

    def adopt(self, reqs: Sequence[Request], now: float) -> float:
        """Seat requests whose KV-cache already arrived via a
        transmission: occupy slots WITHOUT recomputing the context (the
        transfer already paid for it in virtual time).  Returns step
        cost in seconds (0 for model backends — no prefill runs)."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot adopt migrated KV "
            f"(can_adopt={self.can_adopt})")

    def recompute_cost(self, req: Request) -> Optional[float]:
        """Modeled seconds to rebuild ``req``'s context from scratch on
        THIS backend — the recompute side of the migrate-vs-recompute
        decision.  ``None`` means unknown (the engine then never
        migrates away from this backend)."""
        return None

    @property
    def position(self) -> int:
        return 0


class SimBackend(Backend):
    """Virtual-time cost model (no jax): decode-step latency grows with
    batch size, prefill latency with recomputed tokens.  Tokens are
    synthesized deterministically so conservation checks can count them."""

    def __init__(self, t_decode_base: float = 5e-3,
                 t_decode_per_seq: float = 1e-3,
                 t_prefill_per_token: float = 2e-4):
        self.t_decode_base = float(t_decode_base)
        self.t_decode_per_seq = float(t_decode_per_seq)
        self.t_prefill_per_token = float(t_prefill_per_token)

    @staticmethod
    def _synth_token(r: Request) -> int:
        return (r.rid * 7919 + r.tokens_decoded) % 50000

    def join(self, reqs: Sequence[Request], now: float) -> float:
        # cost covers the recomputed context; THEN the prefill emits one
        # generated token (its last-position logits), like the jax path
        cost = self.t_prefill_per_token * sum(r.prefill_len for r in reqs)
        for r in reqs:
            if not r.done:
                r.tokens.append(self._synth_token(r))
        return cost

    def decode(self, running: Sequence[Request]) -> float:
        for r in running:
            if not r.done:  # wave mode: finished requests idle in slots
                r.tokens.append(self._synth_token(r))
        return self.step_cost(len(running))

    def step_cost(self, batch: int) -> float:
        """Cost of one decode step at occupancy ``batch`` (also used by
        wave mode, where finished requests idle in their slots)."""
        return self.t_decode_base + self.t_decode_per_seq * max(batch, 1)

    # --- KV migration -----------------------------------------------------
    # stateless cost model: adopting transferred KV is free (the
    # Transmission already charged the virtual wire time); no token is
    # emitted because no prefill runs — the next decode produces one
    can_adopt = True

    def adopt(self, reqs: Sequence[Request], now: float) -> float:
        return 0.0

    def recompute_cost(self, req: Request) -> float:
        return self.t_prefill_per_token * req.prefill_len


def _bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def _shrink_bucket(cap: int, n: int, streak: int,
                   patience: int) -> tuple:
    """Bucket shrink hysteresis: a membership drop only re-buckets the
    batch axis down after ``patience`` consecutive shrink-eligible
    removals, so a join/finish cycle sitting on a power-of-two edge
    stops recompiling every step.  Returns ``(new_cap, new_streak)``."""
    target = _bucket(max(n, 1))
    if target >= cap:
        return cap, 0
    streak += 1
    if streak >= patience:
        return target, 0
    return cap, streak
