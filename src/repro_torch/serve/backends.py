"""Execution backends for the serving engine.

The engine's scheduling loop (queue -> batcher -> step) is backend
agnostic; a backend owns *how* a step actually runs and how long it
takes, behind three operations::

    join(reqs, now)   # (re)compute KV for joining requests -> seconds
    decode(running)   # one token for every running request  -> seconds
    remove(reqs)      # release finished/preempted slots

* :class:`SimBackend` — virtual-time cost model, no torch import.  Step
  cost is ``base + per_seq * batch``; prefill cost is per token.

* :class:`TorchBackend` — the dense-cache model backend, mirroring the
  JAX package's ``JaxBackend`` line for line: drives
  ``train.step.build_prefill_step`` / ``build_decode_step`` (and through
  them the flash-attention and dense decode-attention kernels on the
  card) over a slot-compacted KV cache.  Batch capacity rounds up to a
  power of two (``_bucket``, with shrink hysteresis in
  ``_shrink_bucket``) and join positions quantize to ``sync`` steps, so
  tensor shapes stay few.

Dense-cache alignment: the model's cache keeps ONE shared position
counter, so a joiner's context is left-padded to the running position
(its tokens occupy the tail).  Joining is therefore only possible while
``prefill_len <= position`` and ``position + remaining_new <= max_len``
— the ``joinable`` predicate the engine passes to the queue.  The
page-granular backend :class:`~repro_torch.serve.paged.TorchPagedBackend`
lifts this constraint (per-request lengths, chunked prefill).
"""
from __future__ import annotations

import time
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


class TorchBackend(Backend):
    """Real prefill/decode over a slot-compacted, bucket-padded cache, in
    PyTorch on ``device`` (the card by default).

    Slot layout: ``self._slots[i]`` is the request in cache row ``i``;
    rows ``len(_slots)..cap`` are padding (decoded but discarded).  All
    rows share the cache position ``self._pos``; joins left-pad to it.
    The decode step writes the cache in place (the JAX backend donates
    it).  ``prefill_calls`` and ``decode_calls`` count model calls, and
    ``decode_seconds`` sums the decode steps' host-clock time (each ends
    reading the sampled tokens back, so the device work is included).
    """

    def __init__(self, cfg, params=None, max_len: int = 256,
                 sync: int = 16, seed: int = 0,
                 step_time: Optional[SimBackend] = None,
                 shrink_patience: int = 4, device="cuda"):
        import torch
        from repro_torch.models import model as model_lib
        from repro_torch.train.step import (build_decode_step,
                                            build_prefill_step)
        self._torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend(device='cuda') but CUDA is not available; "
                "pass device='cpu' to serve on the CPU")
        self.cfg = cfg
        self.max_len = int(max_len)
        self.join_stride = max(int(sync), 1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init(cfg, gen, self.device)
        self.params = params
        self._prefill = build_prefill_step(cfg, self.max_len)
        self._decode = build_decode_step(cfg)
        self._rng = np.random.default_rng(seed)
        self._slots: List[Request] = []
        self._cache = None
        self._last = None          # [cap, 1] int64 last tokens
        self._pos = 0
        self.shrink_patience = max(int(shrink_patience), 1)
        self._shrink_streak = 0
        # virtual time for deterministic schedules; wall time is
        # reported separately by the engine's metrics
        self._timer = step_time or SimBackend()
        self.prefill_calls = 0
        self.decode_calls = 0
        self.decode_seconds = 0.0

    # --- joinability ------------------------------------------------------
    @property
    def position(self) -> int:
        return self._pos

    @property
    def empty(self) -> bool:
        return not self._slots

    def joinable(self, req: Request) -> bool:
        if not self._slots:
            return True  # empty batch restarts at the joiner's length
        return (req.prefill_len <= self._pos
                and self._pos + req.remaining_new <= self.max_len)

    # --- slot ops ---------------------------------------------------------
    def _req_tokens(self, req: Request, length: int) -> np.ndarray:
        """Prompt + generated-so-far, left-padded to ``length``."""
        if req.prompt is None:
            req.prompt = list(self._rng.integers(
                PAD_ID, self.cfg.vocab_size, req.prompt_len))
        toks = list(req.prompt) + list(req.tokens)
        assert len(toks) <= length, (req.rid, len(toks), length)
        return np.asarray([PAD_ID] * (length - len(toks)) + toks,
                          np.int32)

    def _to_device(self, a: np.ndarray, dtype=None):
        return self._torch.from_numpy(a).to(self.device, dtype)

    def _prefill_batch(self, reqs: Sequence[Request], length: int):
        torch = self._torch
        bcap = _bucket(len(reqs))
        toks = np.full((bcap, length), PAD_ID, np.int32)
        for i, r in enumerate(reqs):
            toks[i] = self._req_tokens(r, length)
        batch = {"tokens": self._to_device(toks, torch.long)}
        if self.cfg.family == "encdec":
            batch["enc_embeds"] = self._to_device(self._rng.normal(
                0, 0.02, (bcap, 8, self.cfg.d_model)), torch.float32)
        if self.cfg.family == "vlm":
            batch["patch_embeds"] = self._to_device(self._rng.normal(
                0, 0.02, (bcap, 4, self.cfg.d_model)), torch.float32)
        logits, cache = self._prefill(self.params, batch)
        self.prefill_calls += 1
        last = logits.argmax(-1)                         # [bcap, 1]
        return cache, last

    def _cache_rows(self, cache, idx: np.ndarray):
        """Gather cache rows along the batch axis (axis 1 for stacked
        [L, B, ...] arrays; the scalar position counter passes through)."""
        i = self._to_device(np.asarray(idx, np.int64))
        return {k: (v if v.dim() == 0 else v.index_select(1, i))
                for k, v in cache.items()}

    @staticmethod
    def _emit_prefill_tokens(reqs: Sequence[Request], last) -> None:
        """A prefill's last-position logits ARE one generated token (the
        first for a fresh join, the next one for a recompute rejoin) —
        emit it, as the pre-engine wave driver did."""
        toks = last[:, 0].cpu().numpy()
        for i, r in enumerate(reqs):
            if not r.done:
                r.tokens.append(int(toks[i]))

    def join(self, reqs: Sequence[Request], now: float) -> float:
        torch = self._torch
        reqs = list(reqs)
        if not reqs:
            return 0.0
        if not self._slots:
            # (re)start: position = longest prefill, rounded up to the
            # sync quantum so restart shapes stay bucketed too — but
            # never so far up that the slowest joiner's remaining decode
            # would run past max_len (cache writes must stay in bounds)
            need = max(r.prefill_len for r in reqs)
            maxr = max(r.remaining_new for r in reqs)
            pos = -(-need // self.join_stride) * self.join_stride
            self._pos = max(min(pos, self.max_len - maxr), need)
            # the batch prefills EVERY row to the padded position, not
            # to its raw prefill length — charge what actually runs
            cost = self._timer.t_prefill_per_token * self._pos * len(reqs)
            self._cache, self._last = self._prefill_batch(reqs, self._pos)
            self._slots = reqs
            self._shrink_streak = 0
            self._emit_prefill_tokens(reqs, self._last)
            return cost
        assert all(self.joinable(r) for r in reqs)
        cost = self._timer.t_prefill_per_token * self._pos * len(reqs)
        new_cache, new_last = self._prefill_batch(reqs, self._pos)
        n_old, n_new = len(self._slots), len(reqs)
        cap = _bucket(n_old + n_new)
        old_cap = self._last.shape[0]
        if cap > old_cap:  # grow the bucket: zero-pad the batch axis
            pad = cap - old_cap
            self._cache = {
                k: (v if v.dim() == 0 else torch.cat(
                    [v, v.new_zeros((v.shape[0], pad) + v.shape[2:])], 1))
                for k, v in self._cache.items()}
            self._last = torch.cat([self._last,
                                    self._last.new_zeros((pad, 1))])
        # scatter the joiners' rows into slots [n_old, n_old + n_new)
        rows = self._cache_rows(new_cache, np.arange(n_new))
        self._cache = {
            k: (v if v.dim() == 0 else
                torch.cat([v[:, :n_old], rows[k], v[:, n_old + n_new:]], 1))
            for k, v in self._cache.items()}
        self._last = torch.cat(
            [self._last[:n_old], new_last[:n_new],
             self._last[n_old + n_new:]], 0)
        self._slots = self._slots + reqs
        self._shrink_streak = 0
        self._emit_prefill_tokens(reqs, new_last)
        return cost

    def decode(self, running: Sequence[Request]) -> float:
        assert set(id(r) for r in running) == \
            set(id(r) for r in self._slots), "engine/backend slot drift"
        assert self._pos < self.max_len, \
            "decode would write past max_len — join gating broke"
        t0 = time.perf_counter()
        logits, self._cache = self._decode(self.params, self._cache,
                                           self._last)
        self._last = logits.argmax(-1)
        toks = self._last[:, 0].cpu().numpy()
        for i, r in enumerate(self._slots):
            if not r.done:  # wave mode: finished requests idle in slots
                r.tokens.append(int(toks[i]))
        self._pos += 1
        self.decode_calls += 1
        self.decode_seconds += time.perf_counter() - t0
        return self._timer.step_cost(len(self._slots))

    def remove(self, reqs: Sequence[Request]) -> None:
        drop = {id(r) for r in reqs}
        keep = [i for i, r in enumerate(self._slots)
                if id(r) not in drop]
        self._slots = [self._slots[i] for i in keep]
        if not self._slots:
            self._cache, self._last, self._pos = None, None, 0
            self._shrink_streak = 0
            return
        cap, self._shrink_streak = _shrink_bucket(
            self._last.shape[0], len(self._slots),
            self._shrink_streak, self.shrink_patience)
        idx = np.asarray(keep + [keep[0]] * (cap - len(keep)))
        self._cache = self._cache_rows(self._cache, idx)
        self._last = self._last.index_select(
            0, self._to_device(idx.astype(np.int64)))
