"""Page-granular KV backends: block allocation + chunked prefill.

A verbatim copy of the JAX package's page scheduler, with the model
backend written for PyTorch:

* :class:`PageAllocator` — a free-list over fixed-size token pages with
  two ledgers: live pages (exactly ``ceil(context / page)`` per request
  at every step) and worst-case reservations made at join time, so
  on-demand page growth can never fail mid-decode.
* :class:`PagedSimBackend` / :class:`DenseSimBackend` — the virtual-time
  cost models (paged residency with chunked prefill, and the dense-cache
  twin) that need no model at all.
* :class:`TorchPagedBackend` — the real thing: drives
  ``build_prefill_chunk_step`` / ``build_paged_decode_step`` (and
  through them the CUDA paged-decode kernel on the card) over a shared
  page pool with per-request page tables and lengths.

Joining never depends on a shared position (``join_stride == 1``,
``position == 0``): a request joins whenever its worst-case pages fit
the pool, and its prompt prefills in ``prefill_chunk``-token slices
interleaved with the running batch's decode steps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.backends import (PAD_ID, Backend, SimBackend,
                                        _bucket, _shrink_bucket)
from repro_torch.serve.request import Request


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries."""
    return -(-max(int(tokens), 0) // int(page_size))


class PageAllocator:
    """Free-list allocator over a fixed pool of KV pages.

    Page 0 is the scratch page — padding rows and parked table slots
    point at it so every gather hits a valid page — and is never handed
    out.  ``reserve`` admits a request's worst-case page count up front;
    ``grow_to`` then allocates live pages on demand as its context
    crosses page boundaries, guaranteed to succeed because live pages
    never exceed reservations and reservations never exceed the pool.
    """

    def __init__(self, num_pages: int, page_size: int):
        if int(num_pages) < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "scratch page)")
        if int(page_size) < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # pop() from the tail hands out page 1 first — deterministic
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._reserved: Dict[int, int] = {}     # rid -> worst-case pages
        self._live: Dict[int, List[int]] = {}   # rid -> live page ids

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return sum(len(p) for p in self._live.values())

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    def can_reserve(self, pages: int) -> bool:
        return self.reserved_pages + pages <= self.usable_pages

    def reserve(self, rid: int, pages: int) -> None:
        if rid in self._reserved:
            raise RuntimeError(f"request {rid} already reserved")
        if not self.can_reserve(pages):
            raise RuntimeError(
                f"reservation of {pages} pages for request {rid} "
                f"exceeds the pool ({self.reserved_pages} reserved of "
                f"{self.usable_pages})")
        self._reserved[rid] = int(pages)
        self._live[rid] = []

    def grow_to(self, rid: int, tokens: int) -> List[int]:
        """Grow ``rid``'s live pages to cover ``tokens`` context tokens;
        returns its (ordered) page list."""
        need = pages_for(tokens, self.page_size)
        pages = self._live[rid]
        assert need <= self._reserved[rid], \
            (rid, tokens, need, self._reserved[rid])
        while len(pages) < need:
            pages.append(self._free.pop())
        return pages

    def pages_of(self, rid: int) -> List[int]:
        return self._live[rid]

    def release(self, rid: int) -> None:
        pages = self._live.pop(rid, [])
        self._free.extend(reversed(pages))
        self._reserved.pop(rid, None)


class _PagedScheduler:
    """The scheduling state machine both paged backends share: join
    reservations, per-request prefill progress, which rows chunk vs
    decode each step, and residency sampling.  Subclasses implement the
    actual chunk/decode compute (synthetic or jax)."""

    def __init__(self, num_pages: int, page_size: int,
                 prefill_chunk: int, timer: SimBackend):
        self.alloc = PageAllocator(num_pages, page_size)
        self.page_size = int(page_size)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        #: one request's table can span the whole usable pool — the
        #: engine validates prompt + max_new against this
        self.max_len = self.alloc.usable_pages * self.page_size
        self._timer = timer
        self._slots: List[Request] = []        # join order
        self._progress: Dict[int, int] = {}    # rid -> prefilled tokens
        # Request.prefill_len tracks context_len, which GROWS as tokens
        # decode — the prefill target must be frozen at join time
        self._target: Dict[int, int] = {}      # rid -> tokens to prefill
        self._resident_sum = 0
        self._live_sum = 0

    # --- joinability ------------------------------------------------------
    @property
    def empty(self) -> bool:
        return not self._slots

    @property
    def position(self) -> int:
        return 0        # no shared position: joins any step

    def _worst_pages(self, req: Request) -> int:
        return pages_for(req.prefill_len + req.remaining_new,
                         self.page_size)

    def joinable(self, req: Request) -> bool:
        return self.alloc.can_reserve(self._worst_pages(req))

    def filter_joinable(self, pending: Sequence[Request]
                        ) -> List[Request]:
        """Greedy cumulative reservation check: the pool is a collective
        constraint, so each accepted candidate shrinks what the next one
        can reserve (any prefix of the result fits together — the
        batcher admits prefixes)."""
        out: List[Request] = []
        extra = 0
        for r in pending:
            p = self._worst_pages(r)
            if self.alloc.reserved_pages + extra + p \
                    <= self.alloc.usable_pages:
                out.append(r)
                extra += p
        return out

    def restart_cohort(self, pending: Sequence[Request]
                       ) -> List[Request]:
        # no shared position window: the restart rule IS the join rule
        return self.filter_joinable(pending)

    # --- residency accounting ---------------------------------------------
    def _live_tokens(self, req: Request) -> int:
        """KV tokens this request holds: prefill progress while
        mid-prefill, the full (growing) context once complete."""
        prog = self._progress[req.rid]
        return prog if prog < self._target[req.rid] else req.context_len

    def kv_resident_tokens(self) -> int:
        return self.alloc.allocated_pages * self.page_size

    def kv_live_tokens(self) -> int:
        return sum(self._live_tokens(r) for r in self._slots)

    def _sample_residency(self) -> None:
        self._resident_sum += self.kv_resident_tokens()
        self._live_sum += self.kv_live_tokens()

    def waste_ratio(self) -> float:
        """Fraction of step-summed resident KV slots that held no live
        token (the HBM padding waste the benchmarks compare)."""
        if self._resident_sum <= 0:
            return 0.0
        return 1.0 - self._live_sum / self._resident_sum

    # --- the step machine -------------------------------------------------
    def join(self, reqs: Sequence[Request], now: float) -> float:
        """Reserve worst-case pages and run each joiner's FIRST prefill
        chunk (short prompts complete immediately and emit their first
        token, like a dense join)."""
        reqs = list(reqs)
        if not reqs:
            return 0.0
        for r in reqs:
            self.alloc.reserve(r.rid, self._worst_pages(r))
            self._progress[r.rid] = 0
            self._target[r.rid] = r.prefill_len
            self._slots.append(r)
            self._register(r)
        return self._advance_chunks(reqs)

    def decode(self, running: Sequence[Request]) -> float:
        assert set(id(r) for r in running) == \
            set(id(r) for r in self._slots), "engine/backend slot drift"
        incomplete = [r for r in self._slots
                      if self._progress[r.rid] < self._target[r.rid]]
        decoding = [r for r in self._slots
                    if self._progress[r.rid] >= self._target[r.rid]
                    and not r.done]
        cost = 0.0
        if incomplete:
            cost += self._advance_chunks(incomplete)
        if decoding:
            cost += self._decode_rows(decoding)
            for r in decoding:
                self.alloc.grow_to(r.rid, r.context_len)
        self._sample_residency()
        return cost

    def remove(self, reqs: Sequence[Request]) -> None:
        drop = {id(r) for r in reqs}
        self._slots = [r for r in self._slots if id(r) not in drop]
        for r in reqs:
            self.alloc.release(r.rid)
            self._progress.pop(r.rid, None)
            self._target.pop(r.rid, None)
            self._unregister(r)

    # --- KV migration -----------------------------------------------------
    def adopt(self, reqs: Sequence[Request], now: float) -> float:
        """Seat requests whose KV arrived over the wire: reserve pages,
        mark the prefill already complete (progress == target), and grow
        the live pages to the transferred context — no chunks run and no
        token is emitted (the next decode produces one)."""
        for r in reqs:
            self.alloc.reserve(r.rid, self._worst_pages(r))
            self._progress[r.rid] = r.prefill_len
            self._target[r.rid] = r.prefill_len
            self._slots.append(r)
            self._register(r)
            self.alloc.grow_to(r.rid, r.context_len)
        return 0.0

    def recompute_cost(self, req: Request) -> float:
        return self._timer.t_prefill_per_token * req.prefill_len

    def _advance_chunks(self, reqs: Sequence[Request]) -> float:
        """One prefill chunk for each request; completions emit their
        first generated token.  Returns the virtual-time cost."""
        work = []          # (req, start, chunk_len)
        for r in reqs:
            start = self._progress[r.rid]
            cl = min(self.prefill_chunk, self._target[r.rid] - start)
            assert cl > 0, (r.rid, start, self._target[r.rid])
            self.alloc.grow_to(r.rid, start + cl)
            work.append((r, start, cl))
        emitted = self._prefill_rows(work)
        for (r, start, cl), tok in zip(work, emitted):
            self._progress[r.rid] = start + cl
            if start + cl >= self._target[r.rid] and not r.done:
                r.tokens.append(tok)
                # the emitted token's KV slot is written by its decode
                self.alloc.grow_to(r.rid, r.context_len)
        return self._timer.t_prefill_per_token * sum(
            cl for _, _, cl in work)

    # --- compute hooks ----------------------------------------------------
    def _register(self, req: Request) -> None:
        pass

    def _unregister(self, req: Request) -> None:
        pass

    def _prefill_rows(self, work) -> List[int]:
        """Run the chunks in ``work``; return one would-be first token
        per entry (only consumed for rows whose prefill completed)."""
        raise NotImplementedError

    def _decode_rows(self, decoding: Sequence[Request]) -> float:
        """Decode one token for every complete-prefill request; append
        tokens and return the step cost."""
        raise NotImplementedError


class PagedSimBackend(_PagedScheduler, Backend):
    """Virtual-time paged backend: SimBackend's deterministic cost model
    and synthetic token stream over page-granular residency + chunked
    prefill.  Token streams match :class:`SimBackend` exactly (same
    ``(rid, tokens_decoded)`` synthesis), so conservation goldens can
    compare dense and paged schedules token-for-token."""

    join_stride = 1
    can_adopt = True   # synthetic KV: a transferred cache just IS pages

    def __init__(self, num_pages: int, page_size: int = 16,
                 prefill_chunk: int = 32,
                 t_decode_base: float = 5e-3,
                 t_decode_per_seq: float = 1e-3,
                 t_prefill_per_token: float = 2e-4):
        super().__init__(num_pages, page_size, prefill_chunk,
                         SimBackend(t_decode_base, t_decode_per_seq,
                                    t_prefill_per_token))

    def _prefill_rows(self, work) -> List[int]:
        return [SimBackend._synth_token(r) for r, _, _ in work]

    def _decode_rows(self, decoding: Sequence[Request]) -> float:
        for r in decoding:
            r.tokens.append(SimBackend._synth_token(r))
        return self._timer.step_cost(len(decoding))


class DenseSimBackend(Backend):
    """Virtual-time twin of :class:`~repro_torch.serve.backends.JaxBackend`'s
    dense-cache semantics — shared sync-strided position, bucketed batch
    capacity with shrink hysteresis, full-prompt prefill charged at the
    padded position, every slot resident at ``max_len`` — emitting
    :class:`SimBackend`'s synthetic tokens.  The waste/goodput baseline
    the paged backends are benchmarked against, with no jax in the
    loop."""

    def __init__(self, max_len: int, sync: int = 16,
                 shrink_patience: int = 4,
                 t_decode_base: float = 5e-3,
                 t_decode_per_seq: float = 1e-3,
                 t_prefill_per_token: float = 2e-4):
        self.max_len = int(max_len)
        self.join_stride = max(int(sync), 1)
        self.shrink_patience = max(int(shrink_patience), 1)
        self._timer = SimBackend(t_decode_base, t_decode_per_seq,
                                 t_prefill_per_token)
        self._slots: List[Request] = []
        self._pos = 0
        self._cap = 0
        self._shrink_streak = 0
        self._resident_sum = 0
        self._live_sum = 0

    @property
    def empty(self) -> bool:
        return not self._slots

    @property
    def position(self) -> int:
        return self._pos

    def joinable(self, req: Request) -> bool:
        if not self._slots:
            return True
        return (req.prefill_len <= self._pos
                and self._pos + req.remaining_new <= self.max_len)

    def join(self, reqs: Sequence[Request], now: float) -> float:
        reqs = list(reqs)
        if not reqs:
            return 0.0
        if not self._slots:
            need = max(r.prefill_len for r in reqs)
            maxr = max(r.remaining_new for r in reqs)
            pos = -(-need // self.join_stride) * self.join_stride
            self._pos = max(min(pos, self.max_len - maxr), need)
        else:
            assert all(self.joinable(r) for r in reqs)
        self._slots.extend(reqs)
        self._cap = max(self._cap, _bucket(len(self._slots)))
        self._shrink_streak = 0
        for r in reqs:
            if not r.done:
                r.tokens.append(SimBackend._synth_token(r))
        # every row prefills to the shared padded position
        return self._timer.t_prefill_per_token * self._pos * len(reqs)

    def decode(self, running: Sequence[Request]) -> float:
        assert set(id(r) for r in running) == \
            set(id(r) for r in self._slots), "engine/backend slot drift"
        assert self._pos < self.max_len, "decode past max_len"
        for r in self._slots:
            if not r.done:
                r.tokens.append(SimBackend._synth_token(r))
        self._pos += 1
        self._resident_sum += self._cap * self.max_len
        self._live_sum += sum(r.context_len for r in self._slots)
        return self._timer.step_cost(len(self._slots))

    def remove(self, reqs: Sequence[Request]) -> None:
        drop = {id(r) for r in reqs}
        self._slots = [r for r in self._slots if id(r) not in drop]
        if not self._slots:
            self._pos, self._cap, self._shrink_streak = 0, 0, 0
            return
        self._cap, self._shrink_streak = _shrink_bucket(
            self._cap, len(self._slots), self._shrink_streak,
            self.shrink_patience)

    def kv_resident_tokens(self) -> int:
        return self._cap * self.max_len

    def kv_live_tokens(self) -> int:
        return sum(r.context_len for r in self._slots)

    def waste_ratio(self) -> float:
        if self._resident_sum <= 0:
            return 0.0
        return 1.0 - self._live_sum / self._resident_sum


class TorchPagedBackend(_PagedScheduler, Backend):
    """Real chunked prefill + paged decode over a shared page pool, in
    PyTorch on ``device`` (the card by default).

    Mirrors the JAX package's ``PagedJaxBackend``: the KV pools
    (``[L, P, page, Hkv, hd]``) are allocated ONCE and never reshaped —
    batch membership churn only changes the small per-row page table /
    length / token tensors, whose batch axis rounds up to a power of two
    (``_bucket``).  Rows are sticky: a request keeps its row until it is
    removed, and freed rows are reused.  Host mirrors of the page tables
    and lengths are authoritative; the device cache's ``table``/``lens``
    entries are rebuilt from them before every call.  The model steps
    update the pools in place.

    ``decode_calls`` counts decode steps and ``decode_seconds`` sums
    their host-clock time (each ends reading the sampled tokens back, so
    the device work is included).
    """

    join_stride = 1

    def __init__(self, cfg, params=None, num_pages: int = 64,
                 page_size: int = 16, prefill_chunk: int = 32,
                 seed: int = 0, step_time: Optional[SimBackend] = None,
                 device="cuda"):
        import torch
        from repro_torch.models import model as model_lib
        from repro_torch.train.step import (build_paged_decode_step,
                                            build_prefill_chunk_step)
        super().__init__(num_pages, page_size, prefill_chunk,
                         step_time or SimBackend())
        self._torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchPagedBackend(device='cuda') but CUDA is not "
                "available; pass device='cpu' to serve on the CPU")
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init(cfg, gen, self.device)
        self.params = params
        self._model_lib = model_lib
        self._decode = build_paged_decode_step(cfg)
        self._chunk = build_prefill_chunk_step(cfg)
        self._rng = np.random.default_rng(seed)
        self._cache = None
        self._cap = 0
        self._rows: Dict[int, int] = {}     # rid -> row index
        self._row_free: List[int] = []
        self._last: Dict[int, int] = {}     # rid -> last sampled token
        self._maxp = self.alloc.usable_pages
        self._table_np = np.zeros((0, self._maxp), np.int32)
        self.decode_calls = 0
        self.decode_seconds = 0.0

    # --- row / cache management -------------------------------------------
    def _ensure_capacity(self, extra_rows: int) -> None:
        need = len(self._rows) + extra_rows
        cap = max(_bucket(need), self._cap)
        if self._cache is None:
            self._cache = self._model_lib.init_paged_cache(
                self.cfg, cap, self.alloc.num_pages, self.page_size,
                device=self.device)
        if cap > self._cap:
            self._row_free.extend(range(self._cap, cap))
            pad = np.zeros((cap - self._cap, self._maxp), np.int32)
            self._table_np = np.concatenate([self._table_np, pad])
            self._cap = cap

    def _register(self, req: Request) -> None:
        if req.prompt is None:
            req.prompt = list(self._rng.integers(
                PAD_ID, self.cfg.vocab_size, req.prompt_len))
        row = self._row_free.pop(0)
        self._rows[req.rid] = row
        self._table_np[row] = 0

    def _unregister(self, req: Request) -> None:
        row = self._rows.pop(req.rid)
        self._table_np[row] = 0
        self._row_free.append(row)
        self._row_free.sort()
        self._last.pop(req.rid, None)

    def join(self, reqs: Sequence[Request], now: float) -> float:
        self._ensure_capacity(len(list(reqs)))
        return super().join(reqs, now)

    def _sync_tables(self) -> np.ndarray:
        """Refresh the host page-table mirror from the allocator (parked
        slots stay on scratch page 0) and per-row KV lengths."""
        lens = np.zeros((self._cap,), np.int32)
        for r in self._slots:
            row = self._rows[r.rid]
            pages = self.alloc.pages_of(r.rid)
            self._table_np[row, :len(pages)] = pages
            self._table_np[row, len(pages):] = 0
            lens[row] = self._live_tokens(r)
        return lens

    def _to_device(self, a: np.ndarray):
        return self._torch.from_numpy(a).to(self.device)

    def _push_cache(self, lens: np.ndarray) -> None:
        self._cache["table"] = self._to_device(self._table_np.copy())
        self._cache["lens"] = self._to_device(lens)

    def _greedy(self, logits) -> np.ndarray:
        """argmax over the vocabulary (first index on ties, like
        ``jnp.argmax``), read back to the host: [B]."""
        return logits.argmax(-1)[:, 0].cpu().numpy()

    # --- compute hooks ----------------------------------------------------
    def _prefill_rows(self, work) -> List[int]:
        C = self.prefill_chunk
        tokens = np.full((self._cap, C), PAD_ID, np.int32)
        start = np.zeros((self._cap,), np.int32)
        chunk_lens = np.zeros((self._cap,), np.int32)
        active = np.zeros((self._cap,), bool)
        for r, s, cl in work:
            row = self._rows[r.rid]
            seq = list(r.prompt) + list(r.tokens)    # recompute view
            tokens[row, :cl] = seq[s:s + cl]
            start[row], chunk_lens[row], active[row] = s, cl, True
        lens = self._sync_tables()
        # mid-chunk rows carry their pre-chunk progress; grow_to already
        # covered the chunk's pages, so the device tables are current
        for r, s, cl in work:
            lens[self._rows[r.rid]] = s
        self._push_cache(lens)
        logits, self._cache = self._chunk(
            self.params, self._cache, self._to_device(tokens).long(),
            self._to_device(start), self._to_device(chunk_lens),
            self._to_device(active))
        toks = self._greedy(logits)
        return [int(toks[self._rows[r.rid]]) for r, _, _ in work]

    def _decode_rows(self, decoding: Sequence[Request]) -> float:
        t0 = time.perf_counter()
        token = np.full((self._cap, 1), PAD_ID, np.int32)
        active = np.zeros((self._cap,), bool)
        for r in decoding:
            row = self._rows[r.rid]
            token[row, 0] = r.tokens[-1]
            active[row] = True
        lens = self._sync_tables()
        # the decode step writes the input token's KV at position len
        # and attends len + 1 entries: pass len EXCLUDING that token
        for r in decoding:
            lens[self._rows[r.rid]] = r.context_len - 1
        self._push_cache(lens)
        logits, self._cache = self._decode(
            self.params, self._cache, self._to_device(token).long(),
            self._to_device(active))
        toks = self._greedy(logits)
        for r in decoding:
            r.tokens.append(int(toks[self._rows[r.rid]]))
        self.decode_calls += 1
        self.decode_seconds += time.perf_counter() - t0
        return self._timer.step_cost(len(decoding))
