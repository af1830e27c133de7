"""The RMSNorm backward kernels' launch plan (``kernels/rmsnorm/kernel.py``
``row_plan`` and ``rope_plan``), on the CPU: no card is needed.

* The plan depends on (rows, d, x's dtype) alone, and its constants are
  the ``constexpr``s of ``csrc/rmsnorm.cu`` that its ``row_plan`` and
  ``rope_plan`` read.
* Walked as the kernels walk it (block b's slot s takes rows (b + k *
  blocks) * slots + s; thread t of a row owns groups t, t + R, ... of
  each chunk), it gives every row to exactly one (block, slot) and every
  group of a row to exactly one thread, which holds at most
  ``BWD_GROUPS`` of a chunk; a head's (i, i + D / 2) pairs to exactly
  one lane of its ``head_lanes``, at most ``ROPE_BWD_PAIRS`` a lane.
* Blocks and partial rows stay within their caps, threads per block
  within the card's 1,024, and the row fits the registers exactly when
  it is not walked in chunks.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as K

SOURCE = Path(K.__file__).resolve().parent / "csrc" / "rmsnorm.cu"
#: kernel.py's mirrored constants, by their name in the source
MIRRORED = {"kWarpRowMaxD": "WARP_ROW_MAX_D",
            "kBwdGroups": "BWD_GROUPS",
            "kBwdMaxRowThreads": "BWD_MAX_ROW_THREADS",
            "kBwdBlockThreads": "BWD_BLOCK_THREADS",
            "kBwdPartials": "BWD_PARTIALS",
            "kRopeBwdPairs": "ROPE_BWD_PAIRS",
            "kRopeBwdWarps": "ROPE_BWD_WARPS",
            "kRopeBwdPartials": "ROPE_BWD_PARTIALS"}
ITEMSIZES = {"f32": 4, "bf16": 2}
#: row widths: every model's, 6 to 8,192, odd ones, and past the register
#: plan (16,400: chunked in both dtypes; 1,030: chunked without the vector)
WIDTHS = [1, 6, 7, 16, 20, 33, 48, 80, 100, 127, 128, 512, 1000, 1024, 1030,
          1280, 1536, 2048, 2560, 3072, 4096, 4608, 5120, 8191, 8192, 16400]
ROWS = [0, 1, 2, 7, 127, 128, 129, 1056, 8192, 100_003]
#: head widths of qk_norm_rope_bwd (even, 2 to 512) and token counts
HEAD_DS = [2, 6, 20, 64, 80, 128, 256, 258, 510, 512]
TOKENS = [1, 3, 4, 5, 2111, 2112, 2113, 8192, 100_000]


def _constexprs() -> dict:
    text = SOURCE.read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_mirrored_constants_equal_the_sources(name):
    assert getattr(K, MIRRORED[name]) == _constexprs()[name]


def test_the_source_computes_the_plan_it_is_mirrored_from():
    """The source's two plan functions read exactly the mirrored
    constants (a constant added there without its mirror fails here)."""
    text = SOURCE.read_text()
    for fn in ("row_plan", "rope_plan"):
        body = re.search(rf"inline \w+ {fn}\(.*?\n}}\n", text, re.S).group(0)
        used = set(re.findall(r"\bk[A-Z]\w+", body))
        assert used <= set(MIRRORED), used - set(MIRRORED)


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", WIDTHS)
def test_row_plan_depends_on_the_shape_and_dtype_alone(d, dtype):
    """The same (rows, d, dtype) gives the same plan, whatever tensors or
    layouts carry it; the plan's fields hold together."""
    size = ITEMSIZES[dtype]
    for rows in ROWS:
        p = K.row_plan(rows, d, size)
        assert p == K.row_plan(rows, d, size)
        R = p.row_threads
        assert R & (R - 1) == 0 and 1 <= R <= K.BWD_MAX_ROW_THREADS
        assert p.threads == max(R, K.BWD_BLOCK_THREADS) <= 1024
        assert p.threads % 32 == 0 and p.slots * R == p.threads
        assert 1 <= p.blocks <= K.BWD_PARTIALS
        assert p.blocks == max(1, min(-(-rows // p.slots), K.BWD_PARTIALS))
        assert p.vec == (16 // size if d % (16 // size) == 0 else 1)


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", WIDTHS)
def test_row_plan_gives_every_group_to_one_thread(d, dtype):
    """Thread t of a row owns groups c * G * R + t + j * R (chunk c, j <
    G): each of the row's d / vec groups exactly once, at most G a chunk.
    The row is walked in chunks exactly when R * G groups do not hold it,
    and R is then the cap; else R is the least power of two that holds
    it."""
    p = K.row_plan(1, d, ITEMSIZES[dtype])
    G, R, n = K.BWD_GROUPS, p.row_threads, d // p.vec
    assert n * p.vec == d
    chunks = -(-n // (G * R))
    assert p.stream == (chunks > 1)
    if not p.stream:
        assert R == 1 or (R // 2) * G < n <= R * G
    owner = {}
    for c in range(chunks):
        for t in range(R):
            held = [c * G * R + t + j * R for j in range(G)]
            for g in held:
                if g < n:
                    assert g not in owner
                    owner[g] = (c, t)
    assert sorted(owner) == list(range(n))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", [16, 128, 1024, 3072, 5120, 16400])
def test_row_plan_gives_every_row_to_one_block_slot(rows, d):
    """Block b's slot s takes rows (b + k * blocks) * slots + s: every row
    exactly once, and every block steps through the same number of
    row groups (its barriers are uniform)."""
    p = K.row_plan(rows, d, 2)
    seen = [0] * rows
    steps = set()
    for b in range(p.blocks):
        base, k = b * p.slots, 0
        while base < rows:
            for s in range(p.slots):
                if base + s < rows:
                    seen[base + s] += 1
            base += p.blocks * p.slots
            k += 1
        steps.add(k)
    assert seen == [1] * rows
    assert max(steps) - min(steps) <= 1


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("D", HEAD_DS)
def test_rope_plan_gives_every_pair_to_one_lane(D, dtype):
    """A head is ``head_lanes`` lanes' work (a power of two up to a warp);
    lane t holds groups t, t + L, ... of ``vec`` pairs, at most
    ROPE_BWD_PAIRS pairs, each of the D / 2 pairs exactly once."""
    size = ITEMSIZES[dtype]
    p = K.rope_plan(1, D, size)
    assert p == K.rope_plan(1, D, size)
    half = D // 2
    L = p.head_lanes
    assert L & (L - 1) == 0 and 1 <= L <= 32
    assert p.vec == (16 // size if half % (16 // size) == 0 else 1)
    n = half // p.vec
    per_lane = K.ROPE_BWD_PAIRS // p.vec
    assert per_lane * p.vec == K.ROPE_BWD_PAIRS
    owner = {}
    for t in range(L):
        mine = [g for g in range(t, n, L)]
        assert len(mine) * p.vec <= K.ROPE_BWD_PAIRS
        for g in mine:
            assert g not in owner
            owner[g] = t
    assert sorted(owner) == list(range(n))
    assert L == 1 or (L // 2) * per_lane < n


@pytest.mark.parametrize("tokens", TOKENS)
def test_rope_plan_gives_every_token_to_one_warp(tokens):
    """Warp w of block b takes tokens (b + k * blocks) * warps + w: each
    exactly once, within the block cap."""
    p = K.rope_plan(tokens, 128, 2)
    W = K.ROPE_BWD_WARPS
    assert 1 <= p.blocks <= K.ROPE_BWD_PARTIALS
    assert p.blocks == min(-(-tokens // W), K.ROPE_BWD_PARTIALS)
    seen = [0] * tokens
    for b in range(p.blocks):
        for w in range(W):
            for tok in range(b * W + w, tokens, p.blocks * W):
                seen[tok] += 1
    assert seen == [1] * tokens


@pytest.mark.parametrize("entry", ["rmsnorm_bwd", "add_rmsnorm_bwd",
                                   "gated_rmsnorm_bwd",
                                   "gated_rmsnorm_scale_bwd",
                                   "qk_norm_rope_bwd"])
def test_launchers_refuse_cpu_tensors_before_any_library_is_loaded(entry):
    """On CPU tensors each backward launcher raises (the ops take the
    plain formula there) and counts nothing."""
    fn = getattr(K, entry)
    before = fn.launches
    x, w = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA device"):
        if entry == "qk_norm_rope_bwd":
            q = torch.zeros(1, 2, 2, 16)
            fn(q, q, q, q, None, None, torch.zeros(2, dtype=torch.int32),
               torch.ones(8), eps=1e-6)
        elif entry == "rmsnorm_bwd":
            fn(x, x, w, eps=1e-6)
        elif entry == "add_rmsnorm_bwd":
            fn(x, None, x, w, eps=1e-6)
        elif entry == "gated_rmsnorm_bwd":
            fn(x, x, x, w, eps=1e-6)
        else:
            s = torch.ones(4)
            fn(x, x, x, w, s, s, d_total=16, eps=1e-6)
    assert fn.launches == before
