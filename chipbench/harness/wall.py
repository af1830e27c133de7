"""The paged backend on the wall clock.

The engine keeps time on a virtual clock that the backend's ``join`` and
``decode`` advance by what they return.  This subclass of the port's
``TorchPagedBackend`` makes that clock follow the wall:

* ``join`` waits until its joiners are due on the wall;
* ``join`` and ``decode`` return the wall seconds since the previous
  call returned, or since the joiners were due, whichever is later, so
  the engine's host work between calls is charged and an idle jump is
  not;
* every emitted token is stamped with the wall time at which the model
  call that produced it returned (its ``.cpu()`` read-back has
  synchronised the card by then).

The window opens at a wall mark (after a lead, or at the return of the
first call after which every row holds a request); a call that would
start after it closes raises ``WindowClosed``, which ends the engine's
run.  Each model call is recorded with its wall span, its rows, the KV
it holds against what it reserved and the port kernels it launched.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.paged import TorchPagedBackend


class WindowClosed(Exception):
    """The measured window has closed: the engine's run ends here."""


@dataclass
class Call:
    kind: str                    # "prefill" or "decode"
    t0: float                    # wall seconds at entry and return
    t1: float
    rows: List[Tuple[int, int]]  # active rows: (first position, tokens)
    logits_rows: int             # rows whose logits are read
    lens: List[int]              # kv length of every row, as launched
    kv_live: int                 # KV tokens held
    kv_reserved: int             # KV tokens reserved (whole pages)
    launches: Dict[str, int] = field(default_factory=dict)


def _rf(name: str):
    import torch
    return torch.profiler.record_function(name)


class WallPagedBackend(TorchPagedBackend):

    def __init__(self, cfg, *, clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 counters=None, **kw):
        super().__init__(cfg, **kw)
        self.clock, self.sleep = clock, sleep
        self.counters = counters
        self.origin: Optional[float] = None     # wall time of engine t=0
        self.last_return = 0.0
        self.window: Optional[Tuple[float, float]] = None
        self.calls: List[Call] = []
        self.stamps: Dict[int, List[float]] = {}
        self.joined: Dict[int, float] = {}
        self.lags: List[float] = []             # engine clock behind wall
        self.step_ends: List[float] = []        # wall at each decode return
        self.before_call: Optional[Callable] = None   # the profiler
        self.tamper = None                      # fault injection (tests)
        self._policy: dict = {}
        self._seconds = 0.0
        self.max_rows = 0

    # --- the window -------------------------------------------------------
    def arm(self, policy: dict, seconds: float, max_rows: int) -> None:
        """Start the wall clock: engine time 0 is now."""
        self.origin = self.last_return = self.clock()
        self._policy, self._seconds = dict(policy), float(seconds)
        self.max_rows = int(max_rows)
        if policy["opens"] == "lead":
            w0 = self.origin + float(policy["lead_s"])
            self.window = (w0, w0 + self._seconds)
        elif policy["opens"] != "rows_full":
            raise ValueError(f"unknown window opening {policy['opens']!r}")

    def _open_if_due(self, t: float) -> None:
        if (self.window is None and self._policy.get("opens") == "rows_full"
                and len(self._slots) >= self.max_rows):
            self.window = (t, t + self._seconds)

    def _gate(self) -> None:
        if self.window is not None and self.clock() >= self.window[1]:
            raise WindowClosed()
        if self.before_call is not None:
            self.before_call(self)

    # --- the engine's two calls ---------------------------------------------
    def join(self, reqs, now: float) -> float:
        reqs = list(reqs)
        if self.origin is None or not reqs:
            return super().join(reqs, now)
        due = self.origin + max(r.arrival for r in reqs)
        if self.window is not None and due >= self.window[1]:
            raise WindowClosed()
        wait = due - self.clock()
        if wait > 0:
            with _rf("chipbench/wait_arrival"):
                self.sleep(wait)
        self._gate()
        t = self.clock()
        self.lags.append((t - self.origin) - now)
        for r in reqs:
            self.joined.setdefault(r.rid, t)
        begin = max(self.last_return, due)
        super().join(reqs, now)
        return self.last_return - begin

    def decode(self, running) -> float:
        if self.origin is None:
            return super().decode(running)
        self._gate()
        begin = self.last_return
        super().decode(running)
        self.step_ends.append(self.last_return)
        return self.last_return - begin

    # --- the model calls ----------------------------------------------------
    def _lens_as_launched(self, decoding=()) -> List[int]:
        """Each row's kv length as the paged kernel reads it (the
        backend's ``lens`` + 1): a decoding row its context, any other
        slot its live tokens + 1, a free row 1 (the scratch page)."""
        lens = [0] * self._cap
        for r in self._slots:
            lens[self._rows[r.rid]] = self._live_tokens(r)
        for r in decoding:
            lens[self._rows[r.rid]] = r.context_len - 1
        return [n + 1 for n in lens]

    def _record(self, kind, t0, t1, rows, logits_rows, lens, before):
        launches = (self.counters.since(before)
                    if self.counters is not None else {})
        self.calls.append(Call(
            kind, t0, t1, rows, logits_rows, lens, self.kv_live_tokens(),
            self.alloc.reserved_pages * self.page_size, launches))

    def _prefill_rows(self, work) -> List[int]:
        if self.origin is None:
            return super()._prefill_rows(work)
        before = self.counters.snapshot() if self.counters else None
        t0 = self.clock()
        with _rf("chipbench/prefill_call"):
            out = super()._prefill_rows(work)
        t1 = self.clock()
        self._record("prefill", t0, t1, [(s, cl) for _, s, cl in work],
                     len(work), [], before)
        for i, (r, s, cl) in enumerate(work):
            # the rows whose prompt this chunk completes emit a token
            if s + cl >= self._target[r.rid] and not r.done:
                self.stamps.setdefault(r.rid, []).append(t1)
                if self.tamper is not None:
                    out[i] = self.tamper(r, out[i])
        self.last_return = t1
        self._open_if_due(t1)
        return out

    def _decode_rows(self, decoding: Sequence) -> float:
        if self.origin is None:
            return super()._decode_rows(decoding)
        before = self.counters.snapshot() if self.counters else None
        lens = self._lens_as_launched(decoding)
        t0 = self.clock()
        with _rf("chipbench/decode_call"):
            cost = super()._decode_rows(decoding)
        t1 = self.clock()
        self._record("decode", t0, t1,
                     [(r.context_len - 2, 1) for r in decoding],
                     len(decoding), lens, before)
        for r in decoding:
            self.stamps.setdefault(r.rid, []).append(t1)
            if self.tamper is not None:
                r.tokens[-1] = self.tamper(r, r.tokens[-1])
        self.last_return = t1
        self._open_if_due(t1)
        return cost
