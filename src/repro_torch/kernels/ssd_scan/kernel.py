"""Launcher of the CUDA Mamba2 SSD chunked-scan kernel
(``csrc/ssd_scan.cu``).

Replaces ``ssd_scan_fwd`` of the JAX package's
``kernels/ssd_scan/kernel.py`` (the Pallas ``_ssd_kernel``), and with it
what that package's ``ops.py`` does around the kernel: B and C stay
grouped (the kernel reads group ``h // (H // G)``), S is not padded to
the chunk (the kernel masks the ragged last chunk), and an initial state
is the state the first chunk starts from.  One thread block per (head,
row) walks the chunks in order with the P x N fp32 state on chip.  Two
routes, chosen by ``route`` from the dtype and shapes alone: bf16 up to
chunk 128, P 64 and N 128 (both served launches) on the tensor cores
(``wgmma``, the state in accumulator registers), everything else on the
CUDA cores in fp32 (the state in shared memory); see the source for the
designs.  Inputs are read through their batch and sequence strides, so
the model's views of one projection are taken as they are, with no copy.

The library is compiled with ``nvcc`` on first use and bound with
``ctypes``; this module imports nothing CUDA-specific until then.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
#: query rows per score tile (``kRows`` in the source)
ROWS = 32
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's two routes (``route`` 0 and 1 in the source)
CUDA_CORES, TENSOR_CORES = "cuda cores", "tensor cores"
#: the tensor-core route's limits: the chunk fills at most one tile of 128
#: rows, P one panel of 64 columns, N two
TC_MAX_CHUNK, TC_MAX_P, TC_MAX_N = 128, 64, 128


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = (
        [vp] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 11
        + [vp])
    lib.ssd_scan_fwd.restype = i32
    lib.ssd_scan_error_string.argtypes = [i32]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def route(dtype: torch.dtype, chunk: int, P: int, N: int) -> str:
    """Which route a launch takes, by dtype and shape alone (never by a
    failed build or launch): bf16 with chunk <= 128, P <= 64 and N <= 128
    on the tensor cores; f32, and bf16 past those limits, on the CUDA
    cores."""
    if dtype == torch.bfloat16 and chunk <= TC_MAX_CHUNK \
            and P <= TC_MAX_P and N <= TC_MAX_N:
        return TENSOR_CORES
    return CUDA_CORES


def smem_bytes(chunk: int, P: int, N: int, path: str = CUDA_CORES) -> int:
    """Dynamic shared memory of one block, the one count of the layout
    the kernel carves on route ``path`` (the launcher passes it).  CUDA
    cores: the fp32 state, the chunk's B (rows padded to N + 1) and xb,
    one tile of C rows and of scores, and the chunk's cumsum and decay
    weights.  Tensor
    cores (N rounded up to Np = 64 or 128): 1 KB to align the swizzle
    atoms, two ring stages of bf16 C and B ([128, Np]) and xb ([128,
    64]), the scaled xb, the state's bf16 copy ([64, Np]), and a and its
    cumsum."""
    if path == TENSOR_CORES:
        Np = 64 if N <= 64 else 128
        return (1024 + 2 * (2 * 128 * Np * 2 + 128 * 128) + 128 * 128
                + 64 * Np * 2 + 2 * 128 * 4)
    return 4 * (P * (N + 1) + chunk * (N + 1) + chunk * P
                + ROWS * (N + 1) + ROWS * chunk + 2 * chunk)


def vectorized(xb: torch.Tensor, B_mat: torch.Tensor,
               C_mat: torch.Tensor) -> bool:
    """Whether the tensor-core route may fill its tiles by 16-byte
    ``cp.async``: every row of xb, B and C starts on 16 bytes (P, N and the
    batch and sequence strides multiples of 16 bytes, the pointers 16-byte
    aligned); else it loads them element by element."""
    vec = 16 // xb.element_size()
    return (xb.shape[3] % vec == 0 and B_mat.shape[3] % vec == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % vec == 0
                    and t.stride(1) % vec == 0 for t in (xb, B_mat, C_mat)))


def _check(xb, a, B_mat, C_mat, chunk, initial_state):
    if xb.dim() != 4:
        raise ValueError(f"xb must be [B, S, H, P], got {tuple(xb.shape)}")
    Bsz, S, H, P = xb.shape
    if tuple(a.shape) != (Bsz, S, H):
        raise ValueError(f"a must be [B={Bsz}, S={S}, H={H}], got "
                         f"{tuple(a.shape)}")
    if B_mat.dim() != 4 or B_mat.shape != C_mat.shape \
            or tuple(B_mat.shape[:2]) != (Bsz, S):
        raise ValueError(f"B and C must both be [B={Bsz}, S={S}, G, N], got "
                         f"{tuple(B_mat.shape)} and {tuple(C_mat.shape)}")
    G, N = B_mat.shape[2], B_mat.shape[3]
    if G == 0 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if xb.dtype not in _DTYPE_CODES or B_mat.dtype != xb.dtype \
            or C_mat.dtype != xb.dtype:
        raise TypeError(f"xb, B and C must share one of float32/bfloat16, "
                        f"got {xb.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    smem = smem_bytes(chunk, P, N, route(xb.dtype, chunk, P, N))
    if smem > MAX_SMEM:
        raise ValueError(f"chunk={chunk}, P={P}, N={N} needs {smem} bytes of "
                         f"shared memory (> {MAX_SMEM})")
    tensors = [("xb", xb), ("a", a), ("B", B_mat), ("C", C_mat)]
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"initial_state must be [B={Bsz}, H={H}, P={P}, "
                             f"N={N}], got {tuple(initial_state.shape)}")
        if initial_state.dtype != torch.float32:
            raise TypeError(f"initial_state must be float32, got "
                            f"{initial_state.dtype}")
        if not initial_state.is_contiguous():
            raise ValueError("initial_state must be contiguous")
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if not t.is_cuda or t.device != xb.device:
            raise ValueError(f"{name} must lie on xb's CUDA device "
                             f"({xb.device}), got {t.device}")
    inner = [("xb", xb, (P, 1)), ("a", a, (1,)), ("B", B_mat, (N, 1)),
             ("C", C_mat, (N, 1))]
    for name, t, want in inner:
        if any(st != w and size > 1 for st, w, size
               in zip(t.stride()[2:], want, t.shape[2:])):
            raise ValueError(f"{name}'s axes after the sequence axis must be "
                             f"contiguous (strides {want}), got "
                             f"{t.stride()[2:]}")


def ssd_scan_fwd(xb: torch.Tensor, a: torch.Tensor, B_mat: torch.Tensor,
                 C_mat: torch.Tensor, *, chunk: int,
                 initial_state: torch.Tensor = None):
    """xb [B, S, H, P] (float32 or bfloat16); a [B, S, H] float32 log
    decay; B_mat, C_mat [B, S, G, N] grouped, in xb's type;
    initial_state [B, H, P, N] float32 or None (zeros).  All on one CUDA
    device.  -> (y [B, S, H, P] in xb's type, final state [B, H, P, N]
    float32).

    Launches on the current stream and does not synchronise.  Raises
    ``RuntimeError`` when grad is enabled and an input requires grad
    (the kernel has no backward).  Adds one to
    ``ssd_scan_fwd.launches`` per launch."""
    refuse_grad("ssd_scan_fwd", xb, a, B_mat, C_mat, initial_state)
    _check(xb, a, B_mat, C_mat, chunk, initial_state)
    Bsz, S, H, P = xb.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=xb.dtype, device=xb.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                        device=xb.device)
    strides = (ctypes.c_longlong * 8)(
        xb.stride(0), xb.stride(1), a.stride(0), a.stride(1),
        B_mat.stride(0), B_mat.stride(1), C_mat.stride(0), C_mat.stride(1))
    path = route(xb.dtype, chunk, P, N)
    tc = path == TENSOR_CORES
    lib = _library()
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            xb.data_ptr(), a.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), strides, Bsz, S, H, G, P, N,
            int(chunk), _DTYPE_CODES[xb.dtype], int(tc),
            int(tc and vectorized(xb, B_mat, C_mat)),
            smem_bytes(chunk, P, N, path), stream)
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan_fwd launch failed: {msg} "
                           f"(cudaError {err})")
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0
