"""Cases of the paged-prefill kernel, shared by the CPU tests (the plain
version against the JAX package's chunk path), the card tests, the kernel
bench and ``chip_smoke.py``.

A case is ``(name, (B, page, Hq, Hkv, D, C, starts, chunk_lens, maxp),
softcap)``: B rows, each with a chunk of ``chunk_lens[b]`` queries from
position ``starts[b]`` (a row with chunk length 0 is one that is not
prefilling: start 0, no keys), a table ``maxp`` pages wide (``None``: just
wide enough for the longest row), C positions a row.
"""
from __future__ import annotations

import numpy as np

#: the CPU cases: ragged starts, partial final chunks, rows that are not
#: prefilling, G 1, 2, 4, 7 and 8, D 16 to 48, and rows whose length ends
#: on a page edge and one a token past it (48, 49 at page 16)
CASES = [
    ("g1-ragged", (3, 8, 4, 4, 16, 16, [0, 5, 19], [16, 11, 7], None), 0.0),
    ("g2-partial", (3, 16, 4, 2, 32, 32, [0, 32, 64], [32, 20, 3], 8), 0.0),
    ("g4-inactive", (4, 8, 8, 2, 16, 16, [0, 0, 24, 0], [16, 0, 9, 0], 7),
     0.0),
    ("g7-d48", (2, 16, 14, 2, 48, 16, [3, 40], [16, 5], None), 0.0),
    ("g8-page-edge", (4, 16, 16, 2, 16, 32, [16, 17, 0, 31], [32, 32, 32, 2],
                      None), 0.0),
    ("g2-softcap50", (2, 8, 4, 2, 32, 16, [7, 30], [16, 9], None), 50.0),
    ("g8-d128", (2, 16, 16, 2, 128, 32, [0, 70], [32, 18], 12), 0.0),
]

#: the chat cell's chunk call (qwen3-moe-30b-a3b: 16 rows, G 8, D 128,
#: page 16, chunk 32): starts 0 to 2,016, chunk lengths 0 to 32, rows that
#: are not prefilling, and a table of 136 pages
CHAT_CALL = ("chat-call", (
    16, 16, 32, 4, 128, 32,
    [0, 32, 64, 96, 511, 512, 700, 1023, 1500, 2016, 0, 0, 150, 1984, 300,
     0],
    [32, 32, 17, 1, 32, 32, 5, 32, 32, 32, 0, 0, 25, 32, 31, 0], 136), 0.0)

#: the card cases: every CPU case, the chat cell's call, G 2 and G 7 at
#: D 128, D 112 (kimi-k2), D 16, softcap 50 at D 128, and a table the
#: width of the chat cell's pool (1,536 pages)
CARD_CASES = CASES + [
    CHAT_CALL,
    ("g2-d128", (4, 16, 16, 8, 128, 128, [0, 128, 384, 0],
                 [128, 100, 128, 0], None), 0.0),
    ("g7-d128", (3, 16, 28, 4, 128, 32, [0, 63, 200], [32, 32, 7], None),
     0.0),
    ("g8-d112", (3, 16, 64, 8, 112, 32, [0, 96, 250], [32, 32, 11], None),
     0.0),
    ("g4-d16", (3, 16, 8, 2, 16, 64, [0, 64, 129], [64, 40, 64], None), 0.0),
    ("g8-d128-softcap50", (3, 16, 32, 4, 128, 32, [0, 40, 300],
                           [32, 32, 32], None), 50.0),
    ("wide-table", (2, 16, 32, 4, 128, 32, [200, 0], [32, 0], 1536), 0.0),
]

#: the launches the kernel is timed at: (path, case, layers).  The chat
#: cell's typical chunk call: 8 rows prefilling at about 700 tokens, 8
#: decoding (not prefilling), the table as wide as its pool; then
#: qwen3-0.6b's serving section (16 rows, chunk 128, G 2), 8 rows
#: prefilling at about 1,500 tokens
TIMED = [
    ("qwen3-moe chat call", (
        16, 16, 32, 4, 128, 32,
        [640, 672, 704, 608, 736, 576, 768, 544] + [0] * 8,
        [32] * 8 + [0] * 8, 1536), 48),
    ("qwen3 chunk 128", (
        16, 16, 16, 8, 128, 128,
        [1408, 1536, 1280, 1664, 1152, 1536, 1408, 1280] + [0] * 8,
        [128] * 8 + [0] * 8, 2048), 28),
]


def kv_lens(starts, chunk_lens) -> np.ndarray:
    return (np.asarray(starts, np.int32) + np.asarray(chunk_lens, np.int32))


def prefill_case(B, page, Hq, Hkv, D, C, starts, chunk_lens, maxp, seed=0,
                 L=1):
    """q ``[B, C, Hq, D]``, pools ``[L, P, page, Hkv, D]`` and a table whose
    live slots are distinct, shuffled pages (physical order != logical
    order) and whose parked slots point at scratch page 0, as numpy
    arrays, with start and kv_lens (int32).  A row that is not prefilling
    holds 3 pages of its own, as a decoding row does."""
    r = np.random.default_rng(seed)
    lens = kv_lens(starts, chunk_lens)
    need = [-(-int(n) // page) if n else 3 for n in lens]
    maxp = max(need) if maxp is None else maxp
    assert maxp >= max(need), (maxp, need)
    P = max(sum(need) + 1, maxp + 1)
    q = r.normal(0, 1, (B, C, Hq, D)).astype(np.float32)
    kp = r.normal(0, 1, (L, P, page, Hkv, D)).astype(np.float32)
    vp = r.normal(0, 1, (L, P, page, Hkv, D)).astype(np.float32)
    perm = list(r.permutation(np.arange(1, P)))
    table = np.zeros((B, maxp), np.int32)
    for b, n in enumerate(need):
        for i in range(n):
            table[b, i] = perm.pop()
    return (q, kp, vp, table, np.asarray(starts, np.int32), lens)


def live_mask(table, lens, page, P) -> np.ndarray:
    """[P, page] bool: the pool slots some row attends (its table's first
    ``lens[b]`` slots); every other slot is stale or padding."""
    live = np.zeros((P, page), bool)
    for b, n in enumerate(lens):
        for j in range(int(n)):
            live[table[b, j // page], j % page] = True
    return live
