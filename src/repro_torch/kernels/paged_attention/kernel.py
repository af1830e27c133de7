"""Launcher of the CUDA paged flash-decode kernel (``csrc/paged_attention.cu``).

Replaces ``paged_attention_fwd`` of the JAX package's
``kernels/paged_attention/kernel.py`` (the Pallas ``_paged_kernel``).
The kernel is memory-bound: it must read the live K and V pages,
``sum_b ceil(len_b / page) * page * Hkv * D * 2`` elements, once.  One
thread-block cluster per (kv head, row) splits the row over
``split_plan(maxp, page).splits`` blocks, each serving all query heads of
the group so each page is read once, and merges the partials through
distributed shared memory (see the source for the design).  The number of
splits depends on shapes alone; each block cuts the row's attended range
from ``lens[b]`` on the device (``split_ranges`` mirrors that cut), so the
wrapper never reads ``lens`` back.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.decode_attention.kernel import (
    MAX_SPLITS, MIN_SPLIT_TOKENS, smem_bytes as split_smem_bytes)

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_fwd.argtypes = (
        [vp] * 6 + [i32] * 6 + [f32, i32, f32, i32, i32, vp])
    lib.paged_attention_fwd.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def split_plan(maxp: int, page: int) -> int:
    """Blocks per (kv head, row), from shapes alone: ``min(8, ceil(maxp *
    page / 32))`` (8 at every served pool; ``lens`` stays on the
    device)."""
    return max(1, min(MAX_SPLITS, -(-(maxp * page) // MIN_SPLIT_TOKENS)))


def split_ranges(length: int, slots: int, window: int,
                 splits: int) -> List[Tuple[int, int]]:
    """The tokens ``[t0, t_end)`` each block of a row's cluster takes: the
    kernel's cut (``SplitOver::kAttended`` in
    ``include/attention_common.cuh``), written out in Python.  The row's
    attended range is ``[max(0, len - window) if window else 0, min(len,
    slots))``, cut into ``splits`` shares of ``ceil(n / splits)``; a share
    may be empty (``t_end <= t0``)."""
    hi = min(max(length, 0), slots)
    lo = max(0, length - window) if window > 0 else 0
    chunk = -(-max(hi - lo, 0) // splits)
    return [(lo + r * chunk, min(lo + (r + 1) * chunk, hi))
            for r in range(splits)]


def smem_bytes(G: int, D: int) -> int:
    """Dynamic shared memory of one block: the split's partials for a
    head tile (``decode_attention.kernel.smem_bytes``), at most 41 KB at
    D 256; the row's first 256 page ids and its length take 1 KB more of
    static shared memory."""
    return split_smem_bytes(G, D)


def _check(q, k_pool, v_pool, page_table, lens):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, Hq, 1, D], got {tuple(q.shape)}")
    B, Hq, _, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must both be [P, page, Hkv, D], got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    Hkv, Dk = k_pool.shape[2:]
    if Dk != D:
        raise ValueError(f"head dim of q ({D}) != pools' ({Dk})")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} unsupported (need D <= "
                         f"{MAX_HEAD_DIM} and D % 8 == 0)")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [B={B}, maxp], got "
                         f"{tuple(page_table.shape)}")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lens must be [B={B}], got {tuple(lens.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share one of float32/bfloat16, "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lens must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lens", lens)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads pages with 16-byte loads)")


def paged_attention_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lens: torch.Tensor, *, scale: float, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, 1, D]; pools [P, page, Hkv, D]; page_table [B, maxp]
    int32 (unused slots -> page 0); lens [B] int32 (valid tokens incl. the
    current one).  All on one CUDA device.  -> [B, Hq, 1, D] in q's dtype.

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``paged_attention_fwd.launches`` per launch."""
    refuse_grad("paged_attention_fwd", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, page_table, lens)
    B, Hq, _, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    maxp = page_table.shape[1]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, page, maxp, float(scale), int(window),
            float(softcap), split_plan(maxp, page), _DTYPE_CODES[q.dtype],
            stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    paged_attention_fwd.launches += 1
    return out


paged_attention_fwd.launches = 0
