"""Launcher of the CUDA paged flash-decode kernel (``csrc/paged_attention.cu``).

Replaces ``paged_attention_fwd`` of the JAX package's
``kernels/paged_attention/kernel.py`` (the Pallas ``_paged_kernel``).
The kernel is memory-bound: it must read the live K and V pages,
``sum_b ceil(len_b / page) * page * Hkv * D * 2`` elements, once; one
thread block per (kv head, row) serves all query heads of the group so
each page is read once (see the source for the design).

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_fwd.argtypes = (
        [vp] * 6 + [i32] * 6 + [f32, i32, f32, i32, vp])
    lib.paged_attention_fwd.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(G: int, D: int, page: int) -> int:
    """Dynamic shared memory of one block: fp32 K and V pages, q and acc
    for the G heads, the G x page scores and (m, l, alpha)."""
    return 4 * (2 * page * D + 2 * G * D + G * page + 3 * G)


def _check(q, k_pool, v_pool, page_table, lens):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, Hq, 1, D], got {tuple(q.shape)}")
    B, Hq, _, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must both be [P, page, Hkv, D], got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    P, page, Hkv, Dk = k_pool.shape
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
    smem = smem_bytes(Hq // Hkv, D, page)
    if smem > MAX_SMEM:
        raise ValueError(f"page={page}, D={D}, G={Hq // Hkv} needs {smem} "
                         f"bytes of shared memory (> {MAX_SMEM})")


def paged_attention_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lens: torch.Tensor, *, scale: float, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, 1, D]; pools [P, page, Hkv, D]; page_table [B, maxp]
    int32 (unused slots -> page 0); lens [B] int32 (valid tokens incl. the
    current one).  All on one CUDA device.  -> [B, Hq, 1, D] in q's dtype.

    Launches on the current stream and does not synchronise.  Adds one
    to ``paged_attention_fwd.launches`` per launch."""
    _check(q, k_pool, v_pool, page_table, lens)
    B, Hq, _, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, page, page_table.shape[1], float(scale),
            int(window), float(softcap), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    paged_attention_fwd.launches += 1
    return out


paged_attention_fwd.launches = 0
