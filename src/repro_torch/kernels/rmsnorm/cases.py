"""The RMSNorm kernel's checks against its plain version: one case list
and one input generator, shared by ``chip_smoke.py`` and the card-only
tests (``tests/test_torch_gpu.py``), whose CPU counterparts feed the same
numpy inputs to the JAX package."""
from __future__ import annotations

import numpy as np
import torch

#: (name, x shape, layout): every model width (d 128 for the qk-norm; 1024,
#: 1536, 2048 and 2560 for the block and final norms; 3072 and 5120 for
#: Mamba2's gated norm), small d (16, 48, 80), d not a multiple of the
#: 16-byte vector (one element per load, in warp and in block mode), row
#: counts of 1, 7, 8 and 1024, one to three leading axes, and three
#: layouts: "dense"; "row-stride", x the first d columns of a wider
#: tensor (a 2-D view read through its row stride; "+3" makes the stride
#: break the 16-byte vector); "last-token", x = h[:, -1:] of [B, 5, d]
#: (the dense prefill's final norm)
RMSNORM_CASES = [
    ("d16-rows1", (1, 16), "dense"),
    ("d48-rows7", (7, 48), "dense"),
    ("d80-rows8", (8, 80), "dense"),
    ("d128-qk-norm", (8, 1, 16, 128), "dense"),
    ("d128-rows1024", (1024, 128), "dense"),
    ("d1024-rows1024", (1024, 1024), "dense"),
    ("d1536-lead3", (2, 4, 1, 1536), "dense"),
    ("d2048-rows8", (8, 1, 2048), "dense"),
    ("d2560-rows7", (7, 2560), "dense"),
    ("d3072-rows8", (8, 3072), "dense"),
    ("d5120-gated", (8, 128, 5120), "dense"),
    ("d5120-rows1", (1, 5120), "dense"),
    ("d20-odd", (7, 20), "dense"),
    ("d100-odd", (8, 1, 100), "dense"),
    ("d1030-odd-block", (3, 1030), "dense"),
    ("d2048-row-stride", (8, 2048), "row-stride"),
    ("d1024-row-stride+3", (7, 1024), "row-stride+3"),
    ("d1024-last-token", (8, 1, 1024), "last-token"),
]
#: (x dtype, w dtype): the model's bf16 and f32 trees, and both mixes
RMSNORM_DTYPES = [(torch.float32, torch.float32),
                  (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16)]
#: the paths' shapes that ``chip_smoke.py`` times, by name: (x shape)
RMSNORM_TIMED = {
    "qwen3-0.6b decode": (8, 1, 1024),
    "qwen3-0.6b qk-norm": (8, 1, 16, 128),
    "qwen3-moe decode": (8, 1, 2048),
    "qwen3-moe qk-norm": (8, 1, 32, 128),
    "zamba2 gated norm": (8, 128, 5120),
}


def rmsnorm_case(shape, layout="dense", seed=0):
    """x of ``shape`` in the case's layout (numpy f32: the full array it
    is a view of, and how to take the view) and w [d], from a seeded
    generator."""
    r = np.random.default_rng(seed)
    d = shape[-1]
    pad = {"dense": 0, "row-stride": 8, "row-stride+3": 3,
           "last-token": 0}[layout]
    full = shape[:-1] + (d + pad,)
    if layout == "last-token":
        full = (shape[0], 5) + shape[2:]
    x = r.normal(0, 2, full).astype(np.float32)
    w = r.normal(1, 0.1, (d,)).astype(np.float32)
    return x, w


def rmsnorm_case_on(device, x_dtype, w_dtype, shape, layout="dense",
                    seed=0):
    """``rmsnorm_case`` on ``device``: x in ``x_dtype`` as the case's view
    (of shape ``shape``), w in ``w_dtype``."""
    x, w = rmsnorm_case(shape, layout, seed)
    xt = torch.from_numpy(x).to(device, x_dtype)
    if layout == "last-token":
        xt = xt[:, -1:]
    elif layout != "dense":
        xt = xt[..., :shape[-1]]
    assert tuple(xt.shape) == tuple(shape)
    return xt, torch.from_numpy(w).to(device, w_dtype)


def pair_case_on(device, x_dtype, w_dtype, shape, layout="dense", seed=0):
    """The fused row kernels' inputs: (a, b, w), a and b two draws of
    ``rmsnorm_case_on`` in the same layout (x and delta of
    ``add_rmsnorm``; y and z of ``gated_rmsnorm``, z in the model a slice
    of Mamba2's input projection, as the row-stride layouts are)."""
    a, w = rmsnorm_case_on(device, x_dtype, w_dtype, shape, layout, seed)
    b, _ = rmsnorm_case_on(device, x_dtype, w_dtype, shape, layout,
                           seed + 1000)
    return a, b, w


#: (name, (B, S, Hq, Hkv, D), positions, qk-norm, layout) of the fused
#: qk-norm-RoPE kernel: every path's heads (qwen3-0.6b 16/8 of 128,
#: qwen3-moe 32/4 of 128 with qk-norm; zamba2 32/32 of 80, RoPE only) at
#: every path's positions ("rows": [B, S] int32, the paged paths' per-row
#: positions; "seq": [S] int64, a prefill's arange; "one": [1] int32, the
#: dense decode's shared position; "far": [B, S] int64 past 100,000, where
#: cos and sin take their slow argument reduction), D not a multiple of
#: the 16-byte vector (20, 6), q and k as head slices of one fused qkv
#: projection ("fused-qkv": strided heads and tokens), and no rows at all
QK_ROPE_CASES = [
    ("qwen3-paged-decode", (8, 1, 16, 8, 128), "rows", True, "dense"),
    ("qwen3-dense-decode", (8, 1, 16, 8, 128), "one", True, "dense"),
    ("qwen3-prefill", (8, 128, 16, 8, 128), "seq", True, "dense"),
    ("qwen3-paged-chunk", (3, 32, 16, 8, 128), "rows", True, "dense"),
    ("qwen3-moe-decode", (8, 1, 32, 4, 128), "rows", True, "dense"),
    ("zamba2-d80-decode", (8, 1, 32, 32, 80), "one", False, "dense"),
    ("zamba2-d80-prefill", (2, 40, 32, 32, 80), "seq", False, "dense"),
    ("d80-qk-norm", (2, 5, 4, 2, 80), "rows", True, "dense"),
    ("d64-fused-qkv", (2, 7, 4, 2, 64), "rows", True, "fused-qkv"),
    ("d80-fused-qkv-no-norm", (2, 3, 4, 4, 80), "seq", False, "fused-qkv"),
    ("d20-odd-vec", (3, 4, 2, 1, 20), "seq", True, "dense"),
    ("d6-tiny", (1, 3, 1, 1, 6), "one", True, "dense"),
    ("far-positions", (2, 3, 4, 2, 128), "far", True, "dense"),
    ("zero-rows", (0, 4, 2, 1, 16), "seq", True, "dense"),
]
#: RoPE's theta for the cases (qwen3's)
QK_ROPE_THETA = 1e6


def qk_rope_case(dims, positions, norm, seed=0):
    """Numpy inputs of a qk-norm-RoPE case: (q, k, wq, wk, pos), q and k
    f32, wq and wk None without qk-norm, pos in the case's form and
    dtype."""
    B, S, Hq, Hkv, D = dims
    r = np.random.default_rng(seed)
    q = r.normal(0, 2, (B, S, Hq, D)).astype(np.float32)
    k = r.normal(0, 2, (B, S, Hkv, D)).astype(np.float32)
    wq = r.normal(1, 0.1, (D,)).astype(np.float32) if norm else None
    wk = r.normal(1, 0.1, (D,)).astype(np.float32) if norm else None
    start = r.integers(0, 150, (B, 1))
    pos = {"rows": (start + np.arange(S)).astype(np.int32),
           "seq": np.arange(S, dtype=np.int64),
           "one": np.asarray([r.integers(0, 160)], np.int32),
           "far": (start + 100_000 + 977 * np.arange(S)).astype(np.int64),
           }[positions]
    return q, k, wq, wk, pos


def qk_rope_case_on(device, x_dtype, w_dtype, dims, positions, norm,
                    layout="dense", seed=0):
    """``qk_rope_case`` as tensors on ``device``: q and k in ``x_dtype``
    (for "fused-qkv", head views of one [B, S, (Hq + 2 Hkv) * D]
    projection), the weights in ``w_dtype``."""
    B, S, Hq, Hkv, D = dims
    q, k, wq, wk, pos = qk_rope_case(dims, positions, norm, seed)
    qt = torch.from_numpy(q).to(device, x_dtype)
    kt = torch.from_numpy(k).to(device, x_dtype)
    if layout == "fused-qkv":
        qkv = torch.zeros((B, S, (Hq + 2 * Hkv) * D), dtype=x_dtype,
                          device=device)
        qkv[..., :Hq * D] = qt.flatten(2)
        qkv[..., Hq * D:(Hq + Hkv) * D] = kt.flatten(2)
        qt = qkv[..., :Hq * D].unflatten(-1, (Hq, D))
        kt = qkv[..., Hq * D:(Hq + Hkv) * D].unflatten(-1, (Hkv, D))
    ws = [None if a is None else torch.from_numpy(a).to(device, w_dtype)
          for a in (wq, wk)]
    return qt, kt, ws[0], ws[1], torch.from_numpy(pos).to(device)


#: the fused kernels at the paths' launches that ``chip_smoke.py`` times, by
#: entry point: (name, arch, B, S) and, for qk_norm_rope, the positions'
#: form (as in QK_ROPE_CASES); the widths, heads and qk-norm are the
#: arch's (gated_rmsnorm's z is the first d_inner columns of the arch's
#: Mamba2 input projection, as the model passes it)
FUSED_TIMED = {
    "add_rmsnorm_fwd": [
        ("qwen3-0.6b decode", "qwen3-0.6b", 8, 1),
        ("qwen3-moe decode", "qwen3-moe-30b-a3b", 8, 1),
        ("mamba2 decode", "mamba2-780m", 8, 1),
        ("zamba2 decode", "zamba2-2.7b", 8, 1),
        ("qwen3-0.6b prefill", "qwen3-0.6b", 8, 128),
        ("mamba2 prefill", "mamba2-780m", 8, 384),
    ],
    "qk_norm_rope_fwd": [
        ("qwen3-0.6b paged decode", "qwen3-0.6b", 8, 1, "rows"),
        ("qwen3-0.6b dense decode", "qwen3-0.6b", 8, 1, "one"),
        ("qwen3-moe paged decode", "qwen3-moe-30b-a3b", 8, 1, "rows"),
        ("zamba2 decode", "zamba2-2.7b", 8, 1, "one"),
        ("qwen3-0.6b prefill", "qwen3-0.6b", 8, 128, "seq"),
    ],
    "gated_rmsnorm_fwd": [
        ("mamba2 decode", "mamba2-780m", 8, 1),
        ("zamba2 decode", "zamba2-2.7b", 8, 1),
        ("zamba2 prefill", "zamba2-2.7b", 8, 128),
        ("mamba2 prefill", "mamba2-780m", 8, 384),
    ],
}


# --- the unfused card sequences each fused kernel replaces: what the model
# ran before the fusion, the RMSNorm op (its kernel on the card) beside
# torch's own launches.  Each fused kernel must equal its sequence bit for
# bit on the card.  They import the package lazily and use only what an
# earlier tree of it has too, so that ``chip_smoke.py --kernel-times SRC``
# can time them on another checkout's package.

def add_rmsnorm_unfused(x, delta, w, eps=1e-6):
    """torch's add, then the RMSNorm op: (out, r)."""
    from repro_torch.kernels.rmsnorm import ops
    r = x + delta
    return ops.rmsnorm(r, w, eps), r


def gated_rmsnorm_unfused(y, z, w, eps=1e-6):
    """``F.silu``, torch's mul, then the RMSNorm op."""
    from repro_torch.kernels.rmsnorm import ops
    return ops.rmsnorm(y * torch.nn.functional.silu(z), w, eps)


def qk_norm_rope_unfused(q, k, wq, wk, positions, theta, eps=1e-6):
    """The RMSNorm op on q and on k (when weights are given), then
    ``apply_rope``'s eager ops on each: (q', k')."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.models.layers import apply_rope
    if wq is not None:
        q, k = ops.rmsnorm(q, wq, eps), ops.rmsnorm(k, wk, eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


# --- the backward kernels' checks: each ``*_bwd`` kernel on a case of
# RMSNORM_CASES (the row kernels) or QK_ROPE_CASES, against its plain
# formula (``ref.py``'s ``*_bwd_ref``) and against torch.autograd of its
# plain forward, shared by ``chip_smoke.py`` (phase 16) and the card-only
# tests.  The forward's inputs are read in the case's layout; the
# incoming gradients are dense, as autograd hands them over.

#: the backward kernels, in ``chip_smoke.py``'s order
BWD_ENTRIES = ("rmsnorm_bwd", "add_rmsnorm_bwd", "gated_rmsnorm_bwd",
               "qk_norm_rope_bwd")
#: the output names of each backward, in its return order; the weight
#: gradients (compared relative to their largest value) start with "dw"
BWD_OUTPUTS = {"rmsnorm_bwd": ("dx", "dw"),
               "add_rmsnorm_bwd": ("dx", "dw"),
               "gated_rmsnorm_bwd": ("dy", "dz", "dw"),
               "qk_norm_rope_bwd": ("dq", "dk", "dwq", "dwk")}


def _grad_like(t, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(0, 1, tuple(t.shape)).astype(
        np.float32)).to(t.device, t.dtype)


def _autograd(fn, args, cots):
    leaves = [None if a is None else a.detach().clone().requires_grad_(True)
              for a in args]
    with torch.enable_grad():
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(out, cots)
    return tuple(None if a is None else a.grad for a in leaves)


def bwd_case(entry, device, x_dtype, w_dtype, case, seed=0):
    """One backward kernel on one case: (kernel, plain, autograd), three
    zero-argument callables each giving the backward's outputs in
    ``BWD_OUTPUTS[entry]``'s order (None for a weight gradient RoPE alone
    does not have), in the forward inputs' shapes.  ``case`` is an entry
    of RMSNORM_CASES (the three row kernels) or of QK_ROPE_CASES."""
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm import ref as R
    from repro_torch.kernels.rmsnorm.ops import inv_freq, row_view
    eps = 1e-6
    if entry == "qk_norm_rope_bwd":
        _, dims, positions, norm, layout = case
        q, k, wq, wk, pos = qk_rope_case_on(device, x_dtype, w_dtype, dims,
                                            positions, norm, layout, seed)
        dq, dk = _grad_like(q, seed + 7), _grad_like(k, seed + 8)
        freqs = inv_freq(q.device, dims[-1], QK_ROPE_THETA)
        return (lambda: K.qk_norm_rope_bwd(dq, dk, q, k, wq, wk, pos, freqs,
                                           eps=eps),
                lambda: R.qk_norm_rope_bwd_ref(dq, dk, q, k, wq, wk, pos,
                                               QK_ROPE_THETA, eps),
                lambda: _autograd(
                    lambda a, b, c, d: R.qk_norm_rope_ref(
                        a, b, c, d, pos, QK_ROPE_THETA, eps),
                    (q, k, wq, wk), (dq, dk)))
    _, shape, layout = case
    a, b, w = pair_case_on(device, x_dtype, w_dtype, shape, layout, seed)
    g1, g2 = _grad_like(a, seed + 7), _grad_like(a, seed + 8)

    def rows(*outs):  # the kernel's [rows, d] outputs in a's shape
        return tuple(o.reshape(a.shape) if o.dim() == 2 else o
                     for o in outs)
    if entry == "rmsnorm_bwd":
        return (lambda: rows(*K.rmsnorm_bwd(row_view(g1), row_view(a), w,
                                            eps=eps)),
                lambda: R.rmsnorm_bwd_ref(g1, a, w, eps),
                lambda: _autograd(lambda x, ww: R.rmsnorm_ref(x, ww, eps),
                                  (a, w), (g1,)))
    if entry == "add_rmsnorm_bwd":
        # a is r = x + delta; its gradient is the one x and delta share
        return (lambda: rows(*K.add_rmsnorm_bwd(
                    row_view(g1), row_view(g2), row_view(a), w, eps=eps)),
                lambda: R.add_rmsnorm_bwd_ref(g1, g2, a, w, eps),
                lambda: _autograd(lambda r, ww: (R.rmsnorm_ref(r, ww, eps),
                                                 r * 1), (a, w), (g1, g2)))
    if entry == "gated_rmsnorm_bwd":
        return (lambda: rows(*K.gated_rmsnorm_bwd(
                    row_view(g1), row_view(a), row_view(b), w, eps=eps)),
                lambda: R.gated_rmsnorm_bwd_ref(g1, a, b, w, eps),
                lambda: _autograd(
                    lambda y, z, ww: R.gated_rmsnorm_ref(y, z, ww, eps),
                    (a, b, w), (g1,)))
    raise ValueError(f"unknown backward {entry!r}")


def bwd_max_err(got, want, tol, w_tol=None):
    """The largest error of a backward's outputs against a reference's
    (a weight gradient relative to its largest value, at least 1), and
    whether every output is within its tolerance (``torch.allclose`` at
    atol = rtol = ``tol``, x's dtype's; a weight gradient at ``w_tol``
    (default ``tol``), its atol scaled so)."""
    w_tol = tol if w_tol is None else w_tol
    worst, ok = 0.0, True
    for g, r in zip(got, want, strict=True):
        if g is None or r is None:
            ok = ok and g is None and r is None
            continue
        g, r = g.float(), r.float()
        if g.shape != r.shape:
            return float("inf"), False
        if not r.numel():                             # no rows
            continue
        weight = g.dim() == 1
        scale = max(1.0, r.abs().max().item()) if weight else 1.0
        t = w_tol if weight else tol
        worst = max(worst, (g - r).abs().max().item() / scale)
        ok = ok and torch.allclose(g, r, atol=t * scale, rtol=t)
    return worst, ok


#: the train step's launches that ``chip_smoke.py`` times each backward
#: at, by entry point: (name, arch, B, S); the widths, heads and
#: qk-norm are the arch's (the gated norm's z is the first d_inner
#: columns of the arch's Mamba2 input projection, as the model passes it)
BWD_TIMED = {
    "rmsnorm_bwd": [("qwen3-0.6b train", "qwen3-0.6b", 8, 1024)],
    "add_rmsnorm_bwd": [("qwen3-0.6b train", "qwen3-0.6b", 8, 1024)],
    "qk_norm_rope_bwd": [("qwen3-0.6b train", "qwen3-0.6b", 8, 1024)],
    "gated_rmsnorm_bwd": [("mamba2 train", "mamba2-780m", 4, 512)],
}
