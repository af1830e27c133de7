"""Launcher of the CUDA flash-attention prefill kernel
(``csrc/flash_attention.cu``).

Replaces ``flash_attention_fwd`` of the JAX package's
``kernels/flash_attention/kernel.py`` (the Pallas ``_flash_kernel``).
At serving shapes the kernel is memory-bound: it must read q, k and v
and write o once.  bf16 runs on the tensor cores (``wgmma``, with a
two-stage cp.async ring of K/V tiles), f32 on the CUDA cores; see the
source for the design.  It reads its inputs
through their strides, so a ``[B, S, H, D]`` tensor viewed as
``[B, H, S, D]`` is taken as it is, with no copy.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = (
        [vp] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 5
        + [f32, i32, i32, f32, i32, vp])
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


#: bytes of one 128-byte swizzled panel of 64 rows (the bf16 route's
#: unit of shared memory: 64 bf16 columns of a 64-row tile)
PANEL_BYTES = 64 * 128


def tiles(D: int, dtype: torch.dtype = torch.float32):
    """(q rows, keys) of one block's tile for head dim D (the kernel's
    dispatch): 64 x 64 on the bf16 route (wgmma's M and N), 64 x 32 or
    32 x 32 on the f32 route."""
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


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, S, D] and k, v both [B, Hkv, "
                         f"S, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if (Bk, Sk, Dk) != (B, S, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} unsupported (need D <= "
                         f"{MAX_HEAD_DIM} and D % 8 == 0)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device "
                             f"({q.device}), got {t.device}")
        if t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a contiguous last dim and "
                             f"16-byte aligned rows (the kernel reads them "
                             f"with 16-byte loads), got strides "
                             f"{t.stride()}")
    if smem_bytes(D, q.dtype) > MAX_SMEM:
        raise ValueError(f"D={D} needs {smem_bytes(D, q.dtype)} bytes of "
                         f"shared memory (> {MAX_SMEM})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0
                        ) -> torch.Tensor:
    """q [B, Hq, S, D]; k, v [B, Hkv, S, D], any strides with a contiguous
    last dim; all on one CUDA device.  -> [B, Hq, S, D] in q's dtype and
    with q's strides.

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``flash_attention_fwd.launches`` per launch."""
    refuse_grad("flash_attention_fwd", q, k, v)
    _check(q, k, v)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    out = torch.empty_like(q)
    # (b, s, h) strides of q, k, v and out, in elements
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, S, Hq, Hkv, D, float(scale), int(bool(causal)),
            int(window), float(softcap), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
