"""The RMSNorm forward kernels' launch plans (``kernels/rmsnorm/kernel.py``
``gated_plan`` and ``rope_fwd_plan``), on the CPU: no card is needed.

* The plans' constants are the ``constexpr``s of ``csrc/rmsnorm.cu`` that
  its ``gated_plan`` and ``rope_fwd_plan`` read.
* Walked as the kernels walk them, every row goes to exactly one (block,
  slot) and every group of a row to exactly one thread; every (token,
  head) to exactly one (warp, chunk, head slot), every group of a head to
  exactly one lane, and every RoPE pair (i, i + D / 2) to a lane and its
  shuffle partner, each writing one of the two.
* The sum of squares each layout computes is ``rmsnorm_fwd``'s, compared
  symbolically: a thread's fma chain over its groups in order is a leaf,
  a shuffle or shared-memory add a node (a + b and b + a give the same
  bits, so a node's operands are unordered), and a thread or lane that
  ``rmsnorm_fwd`` gives no group adds an exact zero (a sum of squares is
  never -0), which leaves the other operand as it is.  Where the token
  layout could not keep the tree, the plan falls back to a warp per
  (token, head), ``rmsnorm_fwd``'s own layout.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as K

SOURCE = Path(K.__file__).resolve().parent / "csrc" / "rmsnorm.cu"
#: kernel.py's mirrored constants, by their name in the source
MIRRORED = {"kWarpRowMaxD": "WARP_ROW_MAX_D",
            "kWarpModeThreads": "WARP_MODE_THREADS",
            "kBlockModeThreads": "BLOCK_MODE_THREADS",
            "kGatedGroups": "GATED_GROUPS",
            "kGatedMaxBlocks": "GATED_MAX_BLOCKS",
            "kGatedRingRows": "GATED_RING_ROWS",
            "kRopeFwdWarps": "ROPE_FWD_WARPS",
            "kRopeFwdFill": "ROPE_FWD_FILL"}
ITEMSIZES = {"f32": 4, "bf16": 2}
#: the gated norm's widths on the paths (Mamba2's d_inner and one of two
#: ranks' columns of it), warp-mode and odd widths, and past the register
#: plan (f32 5,120 and the odd 1,030: chunked)
GATED_WIDTHS = [1, 20, 24, 50, 96, 100, 512, 520, 1030, 1536, 2560, 3072,
                4096, 5120, 8192, 16400]
PATH_WIDTHS = [1536, 2560, 3072, 5120]
ROWS = [0, 1, 2, 7, 8, 263, 264, 265, 1056, 2048, 3072]
#: head widths (even, 2 to 512; the paths' 64, 80 and 128) and (tokens,
#: heads): decode, prefill and train launches, and heads that leave a
#: chunk part empty
HEAD_DS = list(range(2, 514, 2))
PATH_HEAD_DS = [64, 80, 128]
LAUNCHES = [(1, 1), (8, 24), (8, 36), (8, 64), (88, 24), (89, 24),
            (96, 24), (1024, 24), (8192, 24), (500, 36), (400, 7), (3, 3),
            (2112, 24), (2113, 24), (100_000, 40)]


def _constexprs() -> dict:
    text = SOURCE.read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("name", sorted(MIRRORED))
def test_mirrored_constants_equal_the_sources(name):
    assert getattr(K, MIRRORED[name]) == _constexprs()[name]


@pytest.mark.parametrize("fn", ["gated_plan", "rope_fwd_plan"])
def test_the_source_computes_the_plan_it_is_mirrored_from(fn):
    """The source's plan function reads exactly the mirrored constants (a
    constant added there without its mirror fails here)."""
    text = SOURCE.read_text()
    body = re.search(rf"inline \w+ {fn}\(.*?\n}}\n", text, re.S).group(0)
    used = set(re.findall(r"\bk[A-Z]\w+", body))
    assert used <= set(MIRRORED), used - set(MIRRORED)


# --- the symbolic sums -------------------------------------------------------

ZERO = None


def _chain(groups):
    """A thread's fma chain over ``groups`` in order, from 0; (key, ...)
    with key the least group it holds (operands are disjoint, so keys
    order them)."""
    return (min(groups), "fma", tuple(groups)) if groups else ZERO


def _add(a, b):
    """a + b: an exact zero leaves the other operand; a + b == b + a."""
    if a is ZERO:
        return b
    if b is ZERO:
        return a
    lo, hi = sorted((a, b), key=lambda t: t[0])
    return (lo[0], "+", lo, hi)


def _butterfly(vals, offsets):
    """Each lane's value after ``v += shfl_xor(v, o)`` for each o."""
    for o in offsets:
        vals = [_add(vals[i], vals[i ^ o]) for i in range(len(vals))]
    return vals


def _one(vals):
    assert all(v == vals[0] for v in vals), "lanes disagree"
    return vals[0]


def _rmsnorm_tree(d: int, itemsize: int):
    """``rmsnorm_fwd``'s sum of a row (norm_kernel's row_sumsq): thread t
    of kRowThreads (a warp up to WARP_ROW_MAX_D, else BLOCK_MODE_THREADS)
    chains groups t, t + kRowThreads, ...; the warp's butterfly; in a
    block, lane l of warp 0 takes warp l's sum (l < the block's warps,
    else 0) and the butterfly again."""
    kv = 16 // itemsize
    n = d // (kv if d % kv == 0 else 1)
    R = 32 if d <= K.WARP_ROW_MAX_D else K.BLOCK_MODE_THREADS
    chains = [_chain(list(range(t, n, R))) for t in range(R)]
    warps = [_one(_butterfly(chains[w * 32:(w + 1) * 32], [16, 8, 4, 2, 1]))
             for w in range(R // 32)]
    if R == 32:
        return warps[0]
    lanes = warps + [ZERO] * (32 - len(warps))
    return _one(_butterfly(lanes, [16, 8, 4, 2, 1]))


def _gated_groups(p: K.GatedPlan, d: int, t: int):
    """The groups thread t of a row holds, in the kernel's loop order
    (chunks c, then j), and the chunk and slot of each."""
    n = d // p.vec
    G = K.GATED_GROUPS if p.stream else p.groups
    chunks = -(-n // (K.GATED_GROUPS * p.rms_threads)) if p.stream else 1
    out = []
    for c in range(chunks):
        for j in range(G):
            g = c * K.GATED_GROUPS * p.rms_threads + t + j * p.rms_threads
            if g < n:
                out.append((g, c, j))
    return out


def _gated_tree(d: int, itemsize: int):
    """gated_norm_kernel's sum of a row: thread t of ``row_threads`` chains
    its groups in loop order; the warp's butterfly; above a warp, each
    lane l < row_threads / 32 takes warp l's sum, the others 0, and the
    butterfly again."""
    p = K.gated_plan(1, d, itemsize)
    chains = [_chain([g for g, _, _ in _gated_groups(p, d, t)])
              for t in range(p.row_threads)]
    warps = [_one(_butterfly(chains[w * 32:(w + 1) * 32], [16, 8, 4, 2, 1]))
             for w in range(p.row_threads // 32)]
    if p.row_threads == 32:
        return warps[0]
    lanes = warps + [ZERO] * (32 - len(warps))
    return _one(_butterfly(lanes, [16, 8, 4, 2, 1]))


def _rope_head_tree(D: int, itemsize: int):
    """qk_norm_rope_kernel's sum of a head (token layout): lane t < n of
    its P lanes holds group t alone, lanes n .. P - 1 nothing; the
    butterfly over offsets P / 2 .. 1."""
    p = K.rope_fwd_plan(8192, 24, D, itemsize)
    n = D // p.vec
    lanes = [_chain([t] if t < n else []) for t in range(p.head_lanes)]
    offsets, o = [], p.head_lanes // 2
    while o:
        offsets.append(o)
        o //= 2
    return _one(_butterfly(lanes, offsets))


# --- the gated row kernel ----------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", GATED_WIDTHS)
def test_gated_plan_holds_together(d, dtype):
    """Fields consistent, the plan a function of (rows, d, dtype) alone:
    ``rmsnorm_fwd``'s threads and grouping; whole warps, no more than V;
    one row a block above a warp's width, four below; the ring and the
    registers hold a row exactly when it is not chunked."""
    size = ITEMSIZES[dtype]
    for rows in ROWS:
        p = K.gated_plan(rows, d, size)
        assert p == K.gated_plan(rows, d, size)
        kv = 16 // size
        assert p.vec == (kv if d % kv == 0 else 1)
        assert p.rms_threads == (32 if d <= K.WARP_ROW_MAX_D
                                 else K.BLOCK_MODE_THREADS)
        assert p.row_threads % 32 == 0 and p.row_threads <= p.rms_threads
        assert p.slots == (4 if p.rms_threads == 32 else 1)
        assert p.threads == p.slots * p.row_threads <= 1024
        assert p.groups == -(-(d // p.vec) // p.rms_threads)
        assert p.stream == (p.groups > K.GATED_GROUPS)
        assert p.blocks == max(1, min(-(-rows // p.slots),
                                      K.GATED_MAX_BLOCKS))


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", GATED_WIDTHS)
def test_gated_plan_gives_every_group_to_one_thread(d, dtype):
    """Thread t < row_threads owns groups c * G * V + t + j * V: each of
    the row's groups exactly once, at most GATED_GROUPS a chunk; no
    thread of rmsnorm_fwd's V past row_threads would hold one (its
    warp's zero is what the kernel leaves out)."""
    p = K.gated_plan(1, d, ITEMSIZES[dtype])
    n = d // p.vec
    owner = {}
    for t in range(p.rms_threads):
        held = _gated_groups(p, d, t)
        if t >= p.row_threads:
            assert not held
        assert len({c for _, c, _ in held}) * K.GATED_GROUPS >= len(held)
        for g, _, _ in held:
            assert g not in owner
            owner[g] = t
    assert sorted(owner) == list(range(n))
    # and groups t, t + V, ... are rmsnorm_fwd's thread t's
    assert all(t == g % p.rms_threads for g, t in owner.items())


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", [96, 1536, 3072, 5120])
def test_gated_plan_gives_every_row_to_one_block_slot(rows, d):
    """Block b's slot s takes rows (b + k * blocks) * slots + s: every row
    exactly once; the blocks of a one-slot plan step through their rows
    in lockstep counts that differ by at most one (its barrier a row is
    uniform within the block)."""
    p = K.gated_plan(rows, d, 2)
    seen = [0] * rows
    for b in range(p.blocks):
        base = b * p.slots
        while base < rows:
            for s in range(p.slots):
                if base + s < rows:
                    seen[base + s] += 1
            base += p.blocks * p.slots
    assert seen == [1] * rows


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", GATED_WIDTHS)
def test_gated_sum_is_rmsnorm_fwds(d, dtype):
    """The gated row kernel's sum of squares is rmsnorm_fwd's tree at
    every width, the paths' 1,536 to 5,120 among them: so
    gated_rmsnorm_fwd stays bit-equal to F.silu + mul + rmsnorm_fwd and
    gated_rmsnorm_sumsq keeps its order."""
    assert _gated_tree(d, ITEMSIZES[dtype]) == _rmsnorm_tree(
        d, ITEMSIZES[dtype])


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("d", PATH_WIDTHS)
def test_gated_paths_hold_their_rows_in_registers(d, dtype):
    """At the paths' widths in bf16 the row is held whole (no chunk: the
    gate once an element); d 1,536 in bf16 takes 192 threads, no idle
    warp."""
    p = K.gated_plan(2048, d, ITEMSIZES[dtype])
    if dtype == "bf16":
        assert not p.stream
    if (d, dtype) == (1536, "bf16"):
        assert p.row_threads == 192 and p.groups == 1


def test_the_comparison_sees_a_changed_order():
    """A group chained by another thread, the warps added left to right,
    or the butterfly's offsets in another order: none is rmsnorm_fwd's
    tree (the comparison is not blind to order)."""
    right = _rmsnorm_tree(3072, 2)
    chains = [_chain(list(range(t, 384, 256))) for t in range(256)]
    chains[0], chains[1] = _chain([0]), _chain([1, 256, 257])
    warps = [_one(_butterfly(chains[w * 32:(w + 1) * 32], [16, 8, 4, 2, 1]))
             for w in range(8)]
    assert _one(_butterfly(warps + [ZERO] * 24, [16, 8, 4, 2, 1])) != right
    chains = [_chain(list(range(t, 384, 256))) for t in range(256)]
    warps = [_one(_butterfly(chains[w * 32:(w + 1) * 32], [16, 8, 4, 2, 1]))
             for w in range(8)]
    seq = warps[0]
    for w in warps[1:]:
        seq = _add(seq, w)
    assert seq != right
    four = [_chain([g]) for g in range(4)]
    assert _butterfly(four, [1, 2])[0] != _butterfly(four, [2, 1])[0]


# --- qk_norm_rope_fwd --------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("D", HEAD_DS)
def test_rope_fwd_tree_is_rmsnorm_fwds_or_the_plan_falls_back(D, dtype):
    """Every even D up to 512: the token layout's head sum equals
    rmsnorm_fwd's warp tree; where the layout cannot hold it (more than
    32 groups, or a group across the two halves) the plan keeps a warp
    per (token, head), rmsnorm_fwd's own layout."""
    size = ITEMSIZES[dtype]
    p = K.rope_fwd_plan(8192, 24, D, size)
    n = D // p.vec
    if p.token:
        assert n <= 32 and (D // 2) % p.vec == 0
        assert _rope_head_tree(D, size) == _rmsnorm_tree(D, size)
    else:
        assert n > 32 or (D // 2) % p.vec
        assert p.head_lanes == 32 and p.split == 1


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("D", PATH_HEAD_DS)
def test_rope_fwd_paths_take_the_token_layout(D, dtype):
    """qwen3's, whisper's and zamba2's heads (128, 64, 80) take the token
    layout in both dtypes; in bf16 at D 128 two heads share a warp's
    lanes (16 lanes a head, one 16-byte group each)."""
    p = K.rope_fwd_plan(8192, 24, D, ITEMSIZES[dtype])
    assert p.token
    if (D, dtype) == (128, "bf16"):
        assert p.head_lanes == 16 and p.vec == 8


@pytest.mark.parametrize("tokens,heads", LAUNCHES)
@pytest.mark.parametrize("D", [6, 20, 64, 80, 128, 256, 258])
def test_rope_fwd_plan_gives_every_head_to_one_warp(tokens, heads, D):
    """Warp item (token, part) of tokens * split takes chunks part, part +
    split, ... of 32 / P heads, head ch * (32 / P) + sub on sub-warp sub:
    every (token, head) exactly once; the blocks cover the
    items, and the split warps of a token take chunk counts that differ
    by at most one.  A launch of at most ROPE_FWD_FILL rows keeps a warp
    a row; a few more tokens spread their heads, many take them all."""
    for size in ITEMSIZES.values():
        p = K.rope_fwd_plan(tokens, heads, D, size)
        assert p == K.rope_fwd_plan(tokens, heads, D, size)
        if tokens * heads <= K.ROPE_FWD_FILL:
            assert not p.token              # decode: a warp a (token, head)
        if not p.token:
            assert p.blocks * K.ROPE_FWD_WARPS >= tokens * heads
            assert p.head_lanes == 32 and p.split == 1
            continue
        assert p.blocks * K.ROPE_FWD_WARPS >= tokens * p.split
        assert p.blocks * K.ROPE_FWD_WARPS - tokens * p.split \
            < K.ROPE_FWD_WARPS
        per = 32 // p.head_lanes
        chunks = -(-heads // per)
        assert 1 <= p.split <= chunks
        counts = []
        seen = [0] * heads
        for part in range(p.split):
            mine = list(range(part, chunks, p.split))
            counts.append(len(mine))
            for ch in mine:
                for sub in range(per):
                    h = ch * per + sub
                    if h < heads:
                        seen[h] += 1
        assert seen == [1] * heads
        assert max(counts) - min(counts) <= 1
        if tokens * chunks <= K.ROPE_FWD_FILL:
            assert p.split == chunks        # a chunk a warp
        if tokens >= K.ROPE_FWD_FILL:
            assert p.split == 1             # train: a token a warp


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("D", [2, 6, 20, 64, 80, 128, 256])
def test_rope_fwd_lanes_write_every_element_once_and_rotate_pairs(D, dtype):
    """A head's lanes as the kernel indexes them: lane t < n writes its
    group's elements, from its own value and its shuffle partner's (src,
    whose partner is t); every element exactly once, and the result is
    RoPE's rotation of the halves (float64, a numpy stand-in).  Where the
    plan falls back, the warp-per-head kernel pairs i with i + D / 2
    itself."""
    p = K.rope_fwd_plan(8192, 24, D, ITEMSIZES[dtype])
    if not p.token:  # more than 32 groups, or a group across the halves
        assert D // p.vec > 32 or (D // 2) % p.vec
        return
    vec, P, n = p.vec, p.head_lanes, D // p.vec
    nh, half = n // 2, D // 2
    r = np.random.default_rng(D)
    x, ang = r.normal(size=D), r.normal(size=half)
    c, s = np.cos(ang), np.sin(ang)
    out = np.full(D, np.nan)
    for t in range(P):
        if t >= n:
            continue
        first = t < nh
        src = t + nh if first else t - nh
        assert 0 <= src < n and (src + nh if src < nh else src - nh) == t
        i0 = (t if first else t - nh) * vec
        for k in range(vec):
            own, other = x[t * vec + k], x[src * vec + k]
            e = t * vec + k
            assert np.isnan(out[e])
            out[e] = (own * c[i0 + k] - other * s[i0 + k] if first
                      else own * c[i0 + k] + other * s[i0 + k])
    want = np.concatenate([x[:half] * c - x[half:] * s,
                           x[half:] * c + x[:half] * s])
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("entry", ["gated_rmsnorm_fwd", "gated_rmsnorm_sumsq",
                                   "gated_rmsnorm_scale", "qk_norm_rope_fwd"])
def test_forward_launchers_refuse_cpu_tensors_before_any_library_is_loaded(
        entry):
    """On CPU tensors each forward launcher of a redesigned kernel raises
    (the ops take the plain version there) and counts nothing."""
    fn = getattr(K, entry)
    before = fn.launches
    x, w = torch.zeros(4, 16), torch.ones(16)
    with pytest.raises(ValueError, match="CUDA device"):
        if entry == "qk_norm_rope_fwd":
            q = torch.zeros(1, 2, 2, 16)
            fn(q, q, None, None, torch.zeros(2, dtype=torch.int32),
               torch.ones(8), eps=1e-6)
        elif entry == "gated_rmsnorm_fwd":
            fn(x, x, w, eps=1e-6)
        elif entry == "gated_rmsnorm_sumsq":
            fn(x, x)
        else:
            fn(x, x, w, torch.ones(4), d_total=16, eps=1e-6)
    assert fn.launches == before
