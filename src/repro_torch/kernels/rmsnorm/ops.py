"""RMSNorm and its fusions over the last axis, any leading dims.

On a CUDA tensor each op always launches its CUDA kernel (or raises); on
a CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  Unlike the JAX wrapper, rows
are not padded to a block: the kernel's row is a warp or a block.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.rmsnorm.kernel import (add_rmsnorm_fwd,
                                                gated_rmsnorm_fwd,
                                                qk_norm_rope_fwd, rmsnorm_fwd)
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_ref,
                                             gated_rmsnorm_ref,
                                             qk_norm_rope_ref, rmsnorm_ref,
                                             rope_freqs)


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


def _device_of(x: torch.Tensor, op: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, got {x.device}")
    return x.device.type


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d], w [d] -> x / rms(x) * w in x's dtype, x's shape."""
    if _device_of(x, "rmsnorm") == "cuda":
        return rmsnorm_fwd(row_view(x), w, eps=eps).reshape(x.shape)
    return rmsnorm_ref(x, w, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, delta [..., d] (one shape), w [d] -> (rmsnorm(x + delta) * w,
    x + delta), both in x's shape and dtype."""
    if _device_of(x, "add_rmsnorm") == "cuda":
        out, r = add_rmsnorm_fwd(row_view(x), row_view(delta), w, eps=eps)
        return out.reshape(x.shape), r.reshape(x.shape)
    return add_rmsnorm_ref(x, delta, w, eps)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """y, z [..., d] (one shape), w [d] -> rmsnorm(y * silu(z)) * w in y's
    shape and dtype."""
    if _device_of(y, "gated_rmsnorm") == "cuda":
        return gated_rmsnorm_fwd(row_view(y), row_view(z), w,
                                 eps=eps).reshape(y.shape)
    return gated_rmsnorm_ref(y, z, w, eps)


@functools.lru_cache(maxsize=None)
def inv_freq(device: torch.device, head_dim: int,
             theta: float) -> torch.Tensor:
    """``rope_freqs`` computed once per (device, head_dim, theta) on the
    device: the same ops on the same device as ``apply_rope`` runs, so
    the same values."""
    return rope_freqs(head_dim, theta, device=device)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor,
                 wq: Optional[torch.Tensor], wk: Optional[torch.Tensor],
                 positions: torch.Tensor, theta: float,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, Hq, D], k [B, S, Hkv, D]: the qk-norm (wq, wk [D]; None
    for RoPE alone) and RoPE at ``positions`` ([B, S], [S] or [1] int)
    -> (q', k') in q's shape and dtype."""
    if _device_of(q, "qk_norm_rope") == "cuda":
        return qk_norm_rope_fwd(q, k, wq, wk, positions,
                                inv_freq(q.device, q.shape[-1], theta),
                                eps=eps)
    return qk_norm_rope_ref(q, k, wq, wk, positions, theta, eps)
