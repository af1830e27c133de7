"""Paged prefill attention (``paged_prefill_fwd``): one launch a layer
of each chunk call, each prefilling row's chunk attending causally to
its own live K/V pages, read in place through its page table."""
from __future__ import annotations

from chipbench.roofline.families import bound, widths

PATTERN = r"paged_prefill_(?:wgmma|f32)_kernel"
ENTRIES = {"paged_prefill_fwd": "repro_torch.kernels.paged_prefill.kernel"}

ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def paged_prefill_bound(B, Hq, Hkv, D, page, starts, chunk_lens,
                        dtype="bfloat16"):
    """(ms, bound by, bytes, operations) of one launch over B rows: each
    prefilling row's live K/V pages (``ceil((start + chunk) / page)`` of
    them), its chunk's queries and outputs and its live table slots
    moved once, start and kv_lens read; 4 * D operations per query head
    and (chunk query, attended key) pair: query i of a chunk from
    ``start`` attends ``start + i + 1`` keys.  A row without a chunk
    needs nothing."""
    es = ITEM_BYTES[dtype]
    act = [(int(s), int(c)) for s, c in zip(starts, chunk_lens) if c > 0]
    pages = sum(-(-(s + c) // page) for s, c in act)
    tokens = sum(c for _, c in act)
    nbytes = (pages * page * Hkv * D * 2 * es + 2 * tokens * Hq * D * es
              + pages * 4 + 8 * B)
    pairs = sum(c * s + c * (c + 1) // 2 for s, c in act)
    ops = 4 * Hq * D * pairs
    return (*bound(nbytes, ops, dtype), nbytes, ops)


def serving_ms(cfg, call, launches) -> float:
    """Each launch over the call's ``cap`` rows, its prefilling rows at
    their starts and chunk lengths, in the model's compute dtype."""
    n = launches.get("paged_prefill_fwd", 0)
    if not n:
        return 0.0
    w = widths(cfg)
    starts = [s for s, _ in call.rows]
    chunks = [c for _, c in call.rows]
    return n * paged_prefill_bound(call.cap, w["Hq"], w["Hkv"], w["D"],
                                   call.page, starts, chunks,
                                   cfg.compute_dtype)[0]
