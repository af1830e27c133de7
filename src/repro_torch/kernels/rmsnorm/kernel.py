"""Launchers of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``).

``rmsnorm_fwd`` replaces ``rmsnorm_fwd`` of the JAX package's
``kernels/rmsnorm/kernel.py`` (the Pallas ``_rms_kernel``).  The three
fused entry points run the same norm, with the same reduction in the same
order, and take over the launch on either side of it:

* ``add_rmsnorm_fwd``: the residual add before a pre-norm;
* ``qk_norm_rope_fwd``: the qk-norm of q and k (when the config has one)
  and the rotary embedding after it, in one launch;
* ``gated_rmsnorm_fwd``: Mamba2's ``y * silu(z)`` before its norm.

The kernels are memory-bound: each must read its inputs and w once and
write its outputs once.  A row of d <= ``WARP_ROW_MAX_D`` is one warp's
work, a longer row one block's; rows are read through their stride and
never padded (see the source for the design).  Each launcher adds one to
its own ``.launches`` per launch (none for zero rows).

Each entry point has a backward launcher (``*_bwd``): a row kernel
that recomputes the norm's rstd from the forward's input and writes the
input gradients, and a second launch that sums dw's fp32 partial rows in
a fixed order (deterministic: no atomics).  ``ops.py`` binds each pair
into a ``torch.autograd.Function``.  The JAX package's Pallas kernel has
no backward (it trains through the plain norm); these carry the port's
gradient where its forward kernel sits on the training path.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
#: rows up to this width are one warp's work (``kWarpRowMaxD``); the
#: qk-norm-RoPE kernel takes only such rows
WARP_ROW_MAX_D = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POS_DTYPES = (torch.int32, torch.int64)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.rmsnorm_fwd.argtypes = [vp, i64, vp, vp, i32, i32, f32, i32, i32,
                                i32, vp]
    lib.add_rmsnorm_fwd.argtypes = [vp, i64, vp, i64, vp, vp, vp, i32, i32,
                                    f32, i32, i32, i32, vp]
    lib.gated_rmsnorm_fwd.argtypes = [vp, i64, vp, i64, vp, vp, i32, i32,
                                      f32, i32, i32, i32, vp]
    lib.qk_norm_rope_fwd.argtypes = ([vp, i64, i64, i64] * 2
                                     + [vp, vp, vp, i64, i64, i32, vp, vp, vp]
                                     + [i32] * 5 + [f32, i32, i32, vp])
    lib.rmsnorm_bwd.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp] + [i32] * 3 \
        + [f32, i32, i32, vp]
    lib.add_rmsnorm_bwd.argtypes = ([vp, i64] * 3 + [vp, vp, vp, vp]
                                    + [i32] * 3 + [f32, i32, i32, vp])
    lib.gated_rmsnorm_bwd.argtypes = ([vp, i64] * 3 + [vp, vp, vp, vp, vp]
                                      + [i32] * 3 + [f32, i32, i32, vp])
    lib.qk_norm_rope_bwd.argtypes = ([vp, vp] + [vp, i64, i64, i64] * 2
                                     + [vp, vp, vp, i64, i64, i32]
                                     + [vp] * 5 + [i32] * 6
                                     + [f32, i32, i32, vp])
    for fn in (lib.rmsnorm_fwd, lib.add_rmsnorm_fwd, lib.gated_rmsnorm_fwd,
               lib.qk_norm_rope_fwd, lib.rmsnorm_bwd, lib.add_rmsnorm_bwd,
               lib.gated_rmsnorm_bwd, lib.qk_norm_rope_bwd):
        fn.restype = i32
    lib.rmsnorm_error_string.argtypes = [i32]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def vectorized(x2d: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
               *more: torch.Tensor) -> bool:
    """Whether the kernel may read 16 bytes per load: d a multiple of the
    vector, every row stride a multiple of 16 bytes, x, out (and every
    further [rows, d] tensor of the call) 16-byte aligned and w aligned to
    the vector's share of it.  It picks the loads only: the kernel groups
    a row's values by d alone, so the result does not depend on it."""
    es = x2d.element_size()
    vec = 16 // es
    rows = (x2d, out) + more
    return (x2d.shape[1] % vec == 0
            and all(t.stride(0) * es % 16 == 0 and t.data_ptr() % 16 == 0
                    for t in rows)
            and w.data_ptr() % (vec * w.element_size()) == 0)


def _on_device(device, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"({device}), got {t.device}")


def _check_dtypes(x, w) -> None:
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"x and w must each be float32 or bfloat16, got "
                        f"{x.dtype}, {w.dtype}")


def _check_weight(w, d, name="w") -> None:
    if tuple(w.shape) != (d,):
        raise ValueError(f"{name} must be [d={d}], got {tuple(w.shape)}")
    if not w.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(name, t, d) -> None:
    """A [rows, d] operand read through its row stride (an empty one is
    not read)."""
    if t.numel() == 0:
        return
    if d > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}'s rows must be contiguous (stride 1 "
                         f"along d)")
    if t.shape[0] > 1 and t.stride(0) < d:
        raise ValueError(f"{name}'s row stride {t.stride(0)} overlaps rows "
                         f"of {d}")


def _check(x2d, w, **second):
    """x2d [rows, d] and w [d]; ``second`` ({"delta": t} or {"z": t}) a
    further operand of x's shape, dtype and device, read the same way."""
    if x2d.dim() != 2:
        raise ValueError(f"x must be [rows, d], got {tuple(x2d.shape)}")
    rows, d = x2d.shape
    if d < 1 or rows >= 2 ** 31:
        raise ValueError(f"x must have 1 <= d and < 2**31 rows, got "
                         f"{tuple(x2d.shape)}")
    _check_weight(w, d)
    _check_dtypes(x2d, w)
    for name, t in second.items():
        if tuple(t.shape) != tuple(x2d.shape) or t.dtype != x2d.dtype:
            raise ValueError(f"{name} must match x ({tuple(x2d.shape)}, "
                             f"{x2d.dtype}), got {tuple(t.shape)}, "
                             f"{t.dtype}")
    _on_device(x2d.device, x=x2d, w=w, **second)
    for name, t in dict(x=x2d, **second).items():
        _check_rows(name, t, d)


def _launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current
    stream of ``device``, and raise if the launch failed."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def rmsnorm_fwd(x2d: torch.Tensor, w: torch.Tensor, *,
                eps: float) -> torch.Tensor:
    """x2d [rows, d] (rows contiguous, any row stride); w [d]; both on
    one CUDA device.  -> contiguous [rows, d] in x's dtype.

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``rmsnorm_fwd.launches`` per launch (none for zero rows)."""
    refuse_grad("rmsnorm_fwd", x2d, w)
    _check(x2d, w)
    rows, d = x2d.shape
    out = torch.empty((rows, d), dtype=x2d.dtype, device=x2d.device)
    if rows == 0:
        return out
    _launch("rmsnorm_fwd", x2d.device,
            x2d.data_ptr(), x2d.stride(0), w.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x2d.dtype],
            _DTYPE_CODES[w.dtype], int(vectorized(x2d, w, out)))
    rmsnorm_fwd.launches += 1
    return out


def add_rmsnorm_fwd(x2d: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                    *, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d, delta [rows, d] (one dtype, rows contiguous, any row strides);
    w [d].  -> (out, r), both contiguous [rows, d] in x's dtype: r = x +
    delta rounded to x's dtype, out = rmsnorm(r) * w.

    One launch in place of torch's add and ``rmsnorm_fwd``, bit-identical
    to them.  Same stream, grad and counting rules as ``rmsnorm_fwd``
    (``add_rmsnorm_fwd.launches``)."""
    refuse_grad("add_rmsnorm_fwd", x2d, delta, w)
    _check(x2d, w, delta=delta)
    rows, d = x2d.shape
    out = torch.empty((rows, d), dtype=x2d.dtype, device=x2d.device)
    r = torch.empty_like(out)
    if rows == 0:
        return out, r
    _launch("add_rmsnorm_fwd", x2d.device,
            x2d.data_ptr(), x2d.stride(0), delta.data_ptr(), delta.stride(0),
            w.data_ptr(), out.data_ptr(), r.data_ptr(), rows, d, float(eps),
            _DTYPE_CODES[x2d.dtype], _DTYPE_CODES[w.dtype],
            int(vectorized(x2d, w, out, delta, r)))
    add_rmsnorm_fwd.launches += 1
    return out, r


def gated_rmsnorm_fwd(y2d: torch.Tensor, z2d: torch.Tensor, w: torch.Tensor,
                      *, eps: float) -> torch.Tensor:
    """y2d, z2d [rows, d] (one dtype, rows contiguous, any row strides:
    z is a slice of Mamba2's input projection); w [d].  -> contiguous
    [rows, d] in y's dtype: rmsnorm(y * silu(z)) * w, with silu(z) and
    the product each rounded to y's dtype as torch rounds them.

    One launch in place of ``F.silu``, torch's mul and ``rmsnorm_fwd``,
    bit-identical to them.  Same stream, grad and counting rules as
    ``rmsnorm_fwd`` (``gated_rmsnorm_fwd.launches``)."""
    refuse_grad("gated_rmsnorm_fwd", y2d, z2d, w)
    _check(y2d, w, z=z2d)
    rows, d = y2d.shape
    out = torch.empty((rows, d), dtype=y2d.dtype, device=y2d.device)
    if rows == 0:
        return out
    _launch("gated_rmsnorm_fwd", y2d.device,
            y2d.data_ptr(), y2d.stride(0), z2d.data_ptr(), z2d.stride(0),
            w.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _DTYPE_CODES[y2d.dtype], _DTYPE_CODES[w.dtype],
            int(vectorized(y2d, w, out, z2d)))
    gated_rmsnorm_fwd.launches += 1
    return out


def _check_heads(q, k) -> None:
    for name, t in (("q", q), ("k", k)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.numel() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s heads must be contiguous (stride 1 "
                             f"along D)")
    B, S, _, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or k.dtype != q.dtype:
        raise ValueError(f"k must be [B={B}, S={S}, Hkv, D={D}] in q's "
                         f"dtype {q.dtype}, got {tuple(k.shape)} {k.dtype}")
    if D < 2 or D % 2 or D > WARP_ROW_MAX_D:
        raise ValueError(f"D must be even and 2 <= D <= {WARP_ROW_MAX_D}, "
                         f"got {D}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q and k must be float32 or bfloat16, got "
                        f"{q.dtype}")


def qk_norm_rope_fwd(q: torch.Tensor, k: torch.Tensor,
                     wq: Optional[torch.Tensor], wk: Optional[torch.Tensor],
                     positions: torch.Tensor, inv_freq: torch.Tensor, *,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, Hq, D] and k [B, S, Hkv, D] (one dtype, D contiguous, any
    other strides); wq, wk [D] (the qk-norm weights), or both None for
    RoPE alone; positions (int32 or int64) that broadcast to [B, S]
    ([B, S], [S] or [1]; read through the broadcast strides); inv_freq
    [D // 2] fp32, ``layers.rope_freqs`` on the card.  -> (q', k'),
    contiguous, in q's dtype: each head normed (rounded to q's dtype)
    and then rotated by ``apply_rope``'s halves at its position.

    One launch in place of two ``rmsnorm_fwd`` and RoPE's eager ops on q
    and k, bit-identical to them.  Same stream, grad and counting rules
    as ``rmsnorm_fwd`` (``qk_norm_rope_fwd.launches``)."""
    refuse_grad("qk_norm_rope_fwd", q, k, wq, wk, inv_freq)
    _check_heads(q, k)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if (wq is None) != (wk is None):
        raise ValueError("wq and wk must both be given or both be None")
    if wq is not None:
        _check_weight(wq, D, "wq")
        _check_weight(wk, D, "wk")
        _check_dtypes(q, wq)
        if wk.dtype != wq.dtype:
            raise TypeError(f"wq and wk must share a dtype, got {wq.dtype}, "
                            f"{wk.dtype}")
    if positions.dtype not in _POS_DTYPES:
        raise TypeError(f"positions must be int32 or int64, got "
                        f"{positions.dtype}")
    try:
        pos = positions.expand(B, S)
    except RuntimeError:
        raise ValueError(f"positions {tuple(positions.shape)} do not "
                         f"broadcast to [B={B}, S={S}]") from None
    if (inv_freq.dtype != torch.float32
            or tuple(inv_freq.shape) != (D // 2,)
            or not inv_freq.is_contiguous()):
        raise ValueError(f"inv_freq must be contiguous float32 [D/2="
                         f"{D // 2}], got {tuple(inv_freq.shape)} "
                         f"{inv_freq.dtype}")
    weights = {} if wq is None else {"wq": wq, "wk": wk}
    _on_device(q.device, q=q, k=k, positions=positions, inv_freq=inv_freq,
               **weights)
    q_out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    k_out = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    if B * S * (Hq + Hkv) == 0:
        return q_out, k_out
    _launch("qk_norm_rope_fwd", q.device,
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            None if wq is None else wq.data_ptr(),
            None if wk is None else wk.data_ptr(),
            pos.data_ptr(), *pos.stride(), int(pos.dtype == torch.int64),
            inv_freq.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
            B, S, Hq, Hkv, D, float(eps), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[wq.dtype] if wq is not None else 0)
    qk_norm_rope_fwd.launches += 1
    return q_out, k_out


# --- the backward -----------------------------------------------------------

#: the most partial rows of dw a backward sums (one per block of its row
#: kernel)
BWD_PARTIALS = 256


def partials(rows: int, d: int) -> int:
    """Blocks of a backward's row kernel, each writing one fp32 partial
    row of dw: the rows over a block's row slots (four warps up to d
    ``WARP_ROW_MAX_D``, else one block per row), at most
    ``BWD_PARTIALS``.  The shape alone decides it, so the order in which
    dw is summed is fixed."""
    per_block = 4 if d <= WARP_ROW_MAX_D else 1
    return max(1, min(-(-rows // per_block), BWD_PARTIALS))


def _partial_rows(rows: int, d: int, device) -> torch.Tensor:
    return torch.empty((partials(rows, d), d), dtype=torch.float32,
                       device=device)


def rmsnorm_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, w: torch.Tensor, *,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``rmsnorm_fwd``: dy2d (the gradient of its output)
    and x2d [rows, d] (one dtype, rows contiguous, any row strides), w
    [d].  -> (dx contiguous [rows, d] in x's dtype, dw [d] in w's dtype),
    rstd recomputed from x, everything summed in fp32.

    Two launches (the row kernel, then the fixed-order sum of dw's
    partial rows), counted as one in ``rmsnorm_bwd.launches``; the same
    stream and grad rules as ``rmsnorm_fwd``."""
    refuse_grad("rmsnorm_bwd", dy2d, x2d, w)
    _check(x2d, w, dy=dy2d)
    rows, d = x2d.shape
    dx = torch.empty((rows, d), dtype=x2d.dtype, device=x2d.device)
    if rows == 0:
        return dx, torch.zeros((d,), dtype=w.dtype, device=w.device)
    dw = torch.empty((d,), dtype=w.dtype, device=w.device)
    part = _partial_rows(rows, d, x2d.device)
    _launch("rmsnorm_bwd", x2d.device,
            dy2d.data_ptr(), dy2d.stride(0), x2d.data_ptr(), x2d.stride(0),
            w.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
            part.shape[0], rows, d, float(eps), _DTYPE_CODES[x2d.dtype],
            _DTYPE_CODES[w.dtype])
    rmsnorm_bwd.launches += 1
    return dx, dw


def add_rmsnorm_bwd(dh2d: torch.Tensor, dr2d: Optional[torch.Tensor],
                    r2d: torch.Tensor, w: torch.Tensor, *,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``add_rmsnorm_fwd``: dh2d and dr2d (the gradients
    of its two outputs, out and r; dr2d may be None) and r2d (its r)
    [rows, d], w [d].  -> (g, dw): g = dr + rmsnorm_bwd(dh, r)'s dx in
    r's dtype (dx rounded to it first, as torch's add of the two would
    take it), the gradient of both x and delta; dw in w's dtype.

    One row kernel and the sum of dw's partial rows, counted as one in
    ``add_rmsnorm_bwd.launches``."""
    refuse_grad("add_rmsnorm_bwd", dh2d, dr2d, r2d, w)
    _check(r2d, w, dh=dh2d, **({} if dr2d is None else {"dr": dr2d}))
    rows, d = r2d.shape
    g = torch.empty((rows, d), dtype=r2d.dtype, device=r2d.device)
    if rows == 0:
        return g, torch.zeros((d,), dtype=w.dtype, device=w.device)
    dw = torch.empty((d,), dtype=w.dtype, device=w.device)
    part = _partial_rows(rows, d, r2d.device)
    _launch("add_rmsnorm_bwd", r2d.device,
            dh2d.data_ptr(), dh2d.stride(0),
            None if dr2d is None else dr2d.data_ptr(),
            0 if dr2d is None else dr2d.stride(0),
            r2d.data_ptr(), r2d.stride(0), w.data_ptr(), g.data_ptr(),
            dw.data_ptr(), part.data_ptr(), part.shape[0], rows, d,
            float(eps), _DTYPE_CODES[r2d.dtype], _DTYPE_CODES[w.dtype])
    add_rmsnorm_bwd.launches += 1
    return g, dw


def gated_rmsnorm_bwd(dout2d: torch.Tensor, y2d: torch.Tensor,
                      z2d: torch.Tensor, w: torch.Tensor, *,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The backward of ``gated_rmsnorm_fwd``: dout2d (the gradient of its
    output), y2d and z2d [rows, d] (its inputs; z may be a strided slice),
    w [d].  -> (dy, dz contiguous [rows, d] in y's dtype, dw [d] in w's
    dtype): the gradient reaches y through silu(z) and z through
    y * silu'(z), the gate's gradients rounded to y's dtype where torch's
    ops would hold them.

    One row kernel and the sum of dw's partial rows, counted as one in
    ``gated_rmsnorm_bwd.launches``."""
    refuse_grad("gated_rmsnorm_bwd", dout2d, y2d, z2d, w)
    _check(y2d, w, z=z2d, dout=dout2d)
    rows, d = y2d.shape
    dy = torch.empty((rows, d), dtype=y2d.dtype, device=y2d.device)
    dz = torch.empty_like(dy)
    if rows == 0:
        return dy, dz, torch.zeros((d,), dtype=w.dtype, device=w.device)
    dw = torch.empty((d,), dtype=w.dtype, device=w.device)
    part = _partial_rows(rows, d, y2d.device)
    _launch("gated_rmsnorm_bwd", y2d.device,
            dout2d.data_ptr(), dout2d.stride(0), y2d.data_ptr(),
            y2d.stride(0), z2d.data_ptr(), z2d.stride(0), w.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), dw.data_ptr(), part.data_ptr(),
            part.shape[0], rows, d, float(eps), _DTYPE_CODES[y2d.dtype],
            _DTYPE_CODES[w.dtype])
    gated_rmsnorm_bwd.launches += 1
    return dy, dz, dw


def qk_norm_rope_bwd(dq: torch.Tensor, dk: torch.Tensor, q: torch.Tensor,
                     k: torch.Tensor, wq: Optional[torch.Tensor],
                     wk: Optional[torch.Tensor], positions: torch.Tensor,
                     inv_freq: torch.Tensor, *, eps: float):
    """The backward of ``qk_norm_rope_fwd``: dq, dk (the gradients of q'
    and k', contiguous, in q's shape and dtype) and the forward's inputs
    as it took them.  -> (dq_in, dk_in, dwq, dwk): RoPE's transpose (the
    rotation by the negative angle) and, with weights, the per-head norm's
    backward, dwq and dwk summed over every (token, head) in fp32 and cast
    to the weights' dtype; without weights the rotation alone and dwq,
    dwk None.

    One row kernel (a warp per head) and, with weights, the sum of the
    dw partial rows, counted as one in ``qk_norm_rope_bwd.launches``."""
    refuse_grad("qk_norm_rope_bwd", dq, dk, q, k, wq, wk, inv_freq)
    _check_heads(q, k)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    for name, g, t in (("dq", dq, q), ("dk", dk, k)):
        if (tuple(g.shape) != tuple(t.shape) or g.dtype != t.dtype
                or not g.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {tuple(t.shape)} "
                             f"{t.dtype}, got {tuple(g.shape)} {g.dtype}")
    if (wq is None) != (wk is None):
        raise ValueError("wq and wk must both be given or both be None")
    weights = {} if wq is None else {"wq": wq, "wk": wk}
    for name, t in weights.items():
        _check_weight(t, D, name)
    if wq is not None:
        _check_dtypes(q, wq)
        if wk.dtype != wq.dtype:
            raise TypeError(f"wq and wk must share a dtype, got {wq.dtype}, "
                            f"{wk.dtype}")
    pos = positions.expand(B, S)
    _on_device(q.device, q=q, k=k, dq=dq, dk=dk, positions=positions,
               inv_freq=inv_freq, **weights)
    dq_in = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    dk_in = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    rows = B * S * (Hq + Hkv)
    dw = (None if wq is None else
          torch.empty((2, D), dtype=wq.dtype, device=q.device))
    if rows == 0:
        return dq_in, dk_in, *((None, None) if dw is None
                               else dw.zero_().unbind())
    nb = partials(rows, D)
    part = (None if wq is None else
            torch.empty((nb, 2, D), dtype=torch.float32, device=q.device))
    _launch("qk_norm_rope_bwd", q.device,
            dq.data_ptr(), dk.data_ptr(), q.data_ptr(), *q.stride()[:3],
            k.data_ptr(), *k.stride()[:3],
            None if wq is None else wq.data_ptr(),
            None if wk is None else wk.data_ptr(),
            pos.data_ptr(), *pos.stride(), int(pos.dtype == torch.int64),
            inv_freq.data_ptr(), dq_in.data_ptr(), dk_in.data_ptr(),
            None if part is None else part.data_ptr(),
            None if dw is None else dw.data_ptr(), nb, B, S, Hq, Hkv, D,
            float(eps), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[wq.dtype] if wq is not None else 0)
    qk_norm_rope_bwd.launches += 1
    return dq_in, dk_in, *((None, None) if dw is None else dw.unbind())


rmsnorm_fwd.launches = 0
add_rmsnorm_fwd.launches = 0
gated_rmsnorm_fwd.launches = 0
qk_norm_rope_fwd.launches = 0
rmsnorm_bwd.launches = 0
add_rmsnorm_bwd.launches = 0
gated_rmsnorm_bwd.launches = 0
qk_norm_rope_bwd.launches = 0
