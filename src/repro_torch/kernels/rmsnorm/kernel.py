"""Launcher of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``rmsnorm_fwd`` of the JAX package's ``kernels/rmsnorm/kernel.py``
(the Pallas ``_rms_kernel``).  The kernel is memory-bound: it must read x
and w once and write the output once.  A row of d <= ``WARP_ROW_MAX_D``
is one warp's work, a longer row one block's; rows are read through
their stride and never padded (see the source for the design).

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
#: rows up to this width are one warp's work (``kWarpRowMaxD``)
WARP_ROW_MAX_D = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = ([vp, ctypes.c_longlong, vp, vp, i32, i32,
                                 ctypes.c_float, i32, i32, i32, vp])
    lib.rmsnorm_fwd.restype = i32
    lib.rmsnorm_error_string.argtypes = [i32]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def vectorized(x2d: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may read 16 bytes per load: d a multiple of the
    vector, the row stride a multiple of 16 bytes, x and out 16-byte
    aligned and w aligned to the vector's share of it."""
    es = x2d.element_size()
    vec = 16 // es
    return (x2d.shape[1] % vec == 0 and x2d.stride(0) * es % 16 == 0
            and x2d.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and w.data_ptr() % (vec * w.element_size()) == 0)


def _check(x2d, w):
    if x2d.dim() != 2:
        raise ValueError(f"x must be [rows, d], got {tuple(x2d.shape)}")
    rows, d = x2d.shape
    if d < 1 or rows >= 2 ** 31:
        raise ValueError(f"x must have 1 <= d and < 2**31 rows, got "
                         f"{tuple(x2d.shape)}")
    if tuple(w.shape) != (d,):
        raise ValueError(f"w must be [d={d}], got {tuple(w.shape)}")
    if x2d.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"x and w must each be float32 or bfloat16, got "
                        f"{x2d.dtype}, {w.dtype}")
    for name, t in (("x", x2d), ("w", w)):
        if not t.is_cuda or t.device != x2d.device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"({x2d.device}), got {t.device}")
    if d > 1 and x2d.stride(1) != 1:
        raise ValueError("x's rows must be contiguous (stride 1 along d)")
    if rows > 1 and x2d.stride(0) < d:
        raise ValueError(f"x's row stride {x2d.stride(0)} overlaps rows "
                         f"of {d}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


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
    lib = _library()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_fwd(
            x2d.data_ptr(), x2d.stride(0), w.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x2d.dtype],
            _DTYPE_CODES[w.dtype], int(vectorized(x2d, w, out)), stream)
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0
