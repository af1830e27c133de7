"""Launcher of the CUDA dense flash-decode kernel
(``csrc/decode_attention.cu``).

Replaces ``decode_attention_fwd`` of the JAX package's
``kernels/decode_attention/kernel.py`` (the Pallas ``_decode_kernel``).
The kernel is memory-bound: it must read the live K and V rows,
``sum_b lens[b] * Hkv * D * 2`` elements, once.  One thread-block
cluster per (kv head, row) splits the row's S token slots over
``split_plan(S).splits`` blocks, each serving all query heads of the
group so each row is read once, and merges the partials through
distributed shared memory (see the source for the design).  The plan
depends on S alone: the wrapper never reads ``lens`` back.  The cache
is not padded.  On request the kernel also writes each head's
log-sum-exp (``lse``), by which the sharded serving steps merge the
partial attention of the ranks' ranges of a sequence-split cache.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
#: most blocks in one cluster (the portable cluster size), and the fewest
#: token slots per split
MAX_SPLITS = 8
MIN_SPLIT_TOKENS = 32
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_fwd.argtypes = (
        [vp] * 7 + [i32] * 5 + [f32, i32, f32, i32, i32, vp])
    lib.decode_attention_fwd.restype = i32
    lib.decode_attention_error_string.argtypes = [i32]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


class SplitPlan(NamedTuple):
    """How one call splits the cache: ``splits`` blocks per (kv head, row)
    form one cluster of ``cluster`` blocks, each taking ``tokens``
    consecutive token slots; ``blocks`` in the grid."""
    splits: int
    cluster: int
    tokens: int
    blocks: int


def split_plan(S: int, B: int = 1, Hkv: int = 1) -> SplitPlan:
    """The launch's split of S cache slots: ``min(8, ceil(S / 32))`` blocks
    per (kv head, row), from S alone (``lens`` stays on the device)."""
    splits = max(1, min(MAX_SPLITS, -(-S // MIN_SPLIT_TOKENS)))
    return SplitPlan(splits, splits, -(-S // splits), splits * Hkv * B)


def head_tile(G: int) -> int:
    """Query heads one block holds at a time: G rounded up to 1, 2, 4 or
    8 (a larger G takes several passes)."""
    return next(t for t in (1, 2, 4, 8) if t >= min(G, 8))


def smem_bytes(G: int, D: int) -> int:
    """Dynamic shared memory of one block (fp32): the 4 warps' partial
    (acc, max, sum) for a head tile, then the block's partial, which the
    cluster reads."""
    GT = head_tile(G)
    return 4 * (4 * GT * D + 2 * 4 * GT + GT * D + 2 * GT)


def _check(q, k_cache, v_cache, lens, ends):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, Hq, 1, D], got {tuple(q.shape)}")
    B, Hq, _, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"caches must both be [B={B}, S, Hkv, D={D}], got "
                         f"{tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    Hkv = k_cache.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} unsupported (need D <= "
                         f"{MAX_HEAD_DIM} and D % 8 == 0)")
    for name, t in (("lens", lens), ("ends", ends)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [B={B}], got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q and caches must share one of float32/bfloat16, "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lens.dtype != torch.int32 or ends.dtype != torch.int32:
        raise TypeError("lens and ends must be int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lens", lens), ("ends", ends)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads rows with 16-byte loads)")


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lens: torch.Tensor, *,
                         scale: float, window: int = 0,
                         softcap: float = 0.0,
                         ends: Optional[torch.Tensor] = None,
                         lse: bool = False):
    """q [B, Hq, 1, D]; caches [B, S, Hkv, D]; lens [B] int32 (valid
    entries incl. the current token, each in [0, S]); ends [B] int32 (the
    query's position + 1, from which a window is measured; ``lens`` when
    None, and above it only where the decode write was clamped onto the
    last slot; on a rank's range of a sequence-split cache, shifted by
    the range's first slot, so any int32).  All on one CUDA device.
    -> [B, Hq, 1, D] in q's dtype; with ``lse`` also each head's
    log-sum-exp over the attended slots, fp32 [B, Hq] (-inf, and a zero
    output, where a row attends none).

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``decode_attention_fwd.launches`` per launch."""
    refuse_grad("decode_attention_fwd", q, k_cache, v_cache)
    ends = lens if ends is None else ends
    _check(q, k_cache, v_cache, lens, ends)
    B, Hq, _, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    lse_out = torch.empty((B, Hq), dtype=torch.float32,
                          device=q.device) if lse else None
    splits = split_plan(S).splits
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), ends.data_ptr(), out.data_ptr(),
            None if lse_out is None else lse_out.data_ptr(), B, S, Hq, Hkv,
            D, float(scale),
            int(window), float(softcap), splits, _DTYPE_CODES[q.dtype],
            stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    decode_attention_fwd.launches += 1
    return out if lse_out is None else (out, lse_out)


decode_attention_fwd.launches = 0
