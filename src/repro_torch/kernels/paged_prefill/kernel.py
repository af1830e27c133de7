"""Launcher of the CUDA paged-prefill kernel (``csrc/paged_prefill.cu``).

The chunk call of paged serving: each row's C chunk queries attend
causally to that row's own live K/V pages, read in place through the
page table.  The JAX package's chunk path is plain XLA (a gather of every
row's whole table, then the masked softmax), so this kernel has no TPU
counterpart.  At the served shapes it is memory-bound: it must read each
prefilling row's live pages, ``ceil((start + chunk) / page) * page``
slots a row (``read_slots``), and q, and write the output, once.  One
block per (tile of 64 (position, head) rows, kv head, row): the G query
heads of a kv head share each K/V tile.  bf16 runs on the tensor cores
(``wgmma``, a two-stage cp.async ring of paged K/V tiles), f32 on the CUDA
cores; see the source for the design.  ``start`` and ``kv_lens`` stay on
the device: the wrapper never reads them back.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_prefill.cu"
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: bytes of one 128-byte swizzled panel of 64 rows (the bf16 route's unit
#: of shared memory)
PANEL_BYTES = 64 * 128


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_prefill_fwd.argtypes = (
        [vp] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 7
        + [f32, f32, i32, vp])
    lib.paged_prefill_fwd.restype = i32
    lib.paged_prefill_error_string.argtypes = [i32]
    lib.paged_prefill_error_string.restype = ctypes.c_char_p
    return lib


def tiles(D: int, dtype: torch.dtype = torch.float32):
    """(packed rows, keys) of one block's tile for head dim D (the
    kernel's dispatch): 64 x 64 on the bf16 route (wgmma's M and N), 64 x
    32 or 32 x 32 on the f32 route.  The launch takes one block per tile
    of C * G packed (position, head) rows, kv head and row."""
    if dtype == torch.bfloat16:
        return (64, 64)
    return (64, 32) if D <= 128 else (32, 32)


def smem_bytes(D: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block.  bf16: 1 KB to align the
    swizzle atoms, then the Q tile and two ring stages of K and V tiles,
    each ceil(D / 64) panels.  f32: Q and K tiles transposed with one
    column of padding, the V tile and the probability tile."""
    if dtype == torch.bfloat16:
        return 1024 + 5 * -(-D // 64) * PANEL_BYTES
    BQ, BK = tiles(D, dtype)
    return 4 * (D * (BQ + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1))


def read_slots(start, chunk_lens, page: int) -> int:
    """KV slots one layer's launch reads, from the host's arrays: each
    row with a chunk reads its live pages, ``ceil((start + chunk_len) /
    page) * page`` slots; a row without one (chunk length 0) reads none."""
    end = (np.asarray(start, np.int64) + np.asarray(chunk_lens, np.int64))
    end = end[np.asarray(chunk_lens) > 0]
    return int((-(-end // page) * page).sum())


def _check(q, k_pool, v_pool, table, start, kv_lens):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, C, Hq, D], got {tuple(q.shape)}")
    B, C, Hq, D = q.shape
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
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"table must be [B={B}, maxp], got "
                         f"{tuple(table.shape)}")
    for name, t in (("start", start), ("kv_lens", kv_lens)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [B={B}], got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share one of float32/bfloat16, "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if any(t.dtype != torch.int32 for t in (table, start, kv_lens)):
        raise TypeError("table, start and kv_lens must be int32")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("start", start),
                    ("kv_lens", kv_lens)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {t.device}")
    if q.stride(3) != 1 or any(q.stride(i) % vec for i in range(3)) \
            or q.data_ptr() % 16:
        raise ValueError(f"q must have a contiguous last dim and 16-byte "
                         f"aligned rows (the kernel reads them with 16-byte "
                         f"loads), got strides {q.stride()}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("kv_lens", kv_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads pages with 16-byte loads)")
    if smem_bytes(D, q.dtype) > MAX_SMEM:
        raise ValueError(f"D={D} needs {smem_bytes(D, q.dtype)} bytes of "
                         f"shared memory (> {MAX_SMEM})")


def paged_prefill_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table: torch.Tensor,
                      start: torch.Tensor, kv_lens: torch.Tensor, *,
                      scale: float, softcap: float = 0.0) -> torch.Tensor:
    """q [B, C, Hq, D] (the model's layout, any strides with a contiguous
    last dim); pools [P, page, Hkv, D]; table [B, maxp] int32 (unused
    slots -> page 0); start [B] int32, any stride (the position of each
    row's first chunk query); kv_lens [B] int32 (valid tokens after the
    chunk's write).  All on one CUDA device.  -> [B, C, Hq, D] in q's
    dtype, contiguous; a row with ``kv_lens == 0`` comes out as zeros.

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``paged_prefill_fwd.launches`` per launch."""
    refuse_grad("paged_prefill_fwd", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, table, start, kv_lens)
    B, C, Hq, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    out = torch.empty((B, C, Hq, D), dtype=q.dtype, device=q.device)
    # (b, s, h) strides of q and out, then start's, in elements
    strides = (ctypes.c_longlong * 7)(
        *q.stride()[:3], *out.stride()[:3], start.stride(0))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_prefill_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), start.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), strides, B, C, Hq, Hkv, D, page,
            table.shape[1], float(scale), float(softcap),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.paged_prefill_error_string(err).decode()
        raise RuntimeError(f"paged_prefill_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    paged_prefill_fwd.launches += 1
    return out


paged_prefill_fwd.launches = 0
