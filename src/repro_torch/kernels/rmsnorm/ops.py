"""RMSNorm over the last axis, any leading dims.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  Unlike the JAX wrapper, rows
are not padded to a block: the kernel's row is a warp or a block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def row_view(x: torch.Tensor) -> torch.Tensor:
    """x [..., d] as [rows, d] with dense rows at one row stride: a view
    wherever the leading dims collapse into one stride (every call of the
    model's, ``h[:, -1:]`` included), a copy only where they do not or
    where the rows are not dense (a strided last axis, an expand)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if (d > 1 and x2.stride(1) != 1) or (x2.shape[0] > 1
                                         and x2.stride(0) < d):
        x2 = x2.contiguous()
    return x2


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d], w [d] -> x / rms(x) * w in x's dtype, x's shape."""
    if x.is_cuda:
        return rmsnorm_fwd(row_view(x), w, eps=eps).reshape(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    raise ValueError(f"rmsnorm runs on cuda or cpu, got {x.device}")
