"""RMSNorm and its fusions over the last axis, any leading dims.

On a CUDA tensor each op always launches its CUDA kernel (or raises); on
a CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  Unlike the JAX wrapper, rows
are not padded to a block: the kernel's row is a warp or a block.

On the card each op is a ``torch.autograd.Function``: its forward
launches the forward kernel (with grad off, as autograd runs a Function's
forward) and its backward the backward kernel (``kernel.py``'s
``*_bwd``), so every norm of a train step runs a hand-written kernel both
ways.  On the CPU autograd traces the plain version.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.rmsnorm.kernel import (add_rmsnorm_bwd,
                                                add_rmsnorm_fwd,
                                                gated_rmsnorm_bwd,
                                                gated_rmsnorm_fwd,
                                                qk_norm_rope_bwd,
                                                qk_norm_rope_fwd, rmsnorm_bwd,
                                                rmsnorm_fwd)
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


def _records(*tensors) -> bool:
    """Whether autograd would record the op: grad enabled and an input
    that requires grad.  Where it would not (serving), the op calls the
    forward launcher directly, without a Function around it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm_fwd`` / ``rmsnorm_bwd`` on x2d [rows, d], w [d]."""

    @staticmethod
    def forward(ctx, x2d, w, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        return rmsnorm_fwd(x2d, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(row_view(dy), x2d, w, eps=ctx.eps)
        return dx, dw, None


class AddRMSNormFn(torch.autograd.Function):
    """``add_rmsnorm_fwd`` / ``add_rmsnorm_bwd``: (out, r) of x2d, delta2d
    [rows, d] and w [d]; x and delta receive the same gradient."""

    @staticmethod
    def forward(ctx, x2d, delta2d, w, eps):
        out, r = add_rmsnorm_fwd(x2d, delta2d, w, eps=eps)
        ctx.save_for_backward(r, w)
        ctx.eps = eps
        return out, r

    @staticmethod
    def backward(ctx, dout, dr):
        r, w = ctx.saved_tensors
        if dout is None:                   # only r was used
            return dr, dr, None, None
        g, dw = add_rmsnorm_bwd(row_view(dout),
                                None if dr is None else row_view(dr), r, w,
                                eps=ctx.eps)
        return g, g, dw, None


class GatedRMSNormFn(torch.autograd.Function):
    """``gated_rmsnorm_fwd`` / ``gated_rmsnorm_bwd`` on y2d, z2d [rows, d]
    and w [d]."""

    @staticmethod
    def forward(ctx, y2d, z2d, w, eps):
        ctx.save_for_backward(y2d, z2d, w)
        ctx.eps = eps
        return gated_rmsnorm_fwd(y2d, z2d, w, eps=eps)

    @staticmethod
    def backward(ctx, dout):
        y2d, z2d, w = ctx.saved_tensors
        dy, dz, dw = gated_rmsnorm_bwd(row_view(dout), y2d, z2d, w,
                                       eps=ctx.eps)
        return dy, dz, dw, None


class QKNormRopeFn(torch.autograd.Function):
    """``qk_norm_rope_fwd`` / ``qk_norm_rope_bwd``: (q', k') of q [B, S,
    Hq, D], k [B, S, Hkv, D], wq and wk [D] (or both None) at
    ``positions``, with ``inv_freq`` on the card."""

    @staticmethod
    def forward(ctx, q, k, wq, wk, positions, inv_freq, eps):
        ctx.save_for_backward(q, k, wq, wk, positions, inv_freq)
        ctx.eps = eps
        return qk_norm_rope_fwd(q, k, wq, wk, positions, inv_freq, eps=eps)

    @staticmethod
    def backward(ctx, dq, dk):
        q, k, wq, wk, positions, inv_freq = ctx.saved_tensors
        dq = torch.zeros_like(q) if dq is None else dq.contiguous()
        dk = torch.zeros_like(k) if dk is None else dk.contiguous()
        dq_in, dk_in, dwq, dwk = qk_norm_rope_bwd(
            dq, dk, q, k, wq, wk, positions, inv_freq, eps=ctx.eps)
        return dq_in, dk_in, dwq, dwk, None, None, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d], w [d] -> x / rms(x) * w in x's dtype, x's shape."""
    if _device_of(x, "rmsnorm") == "cuda":
        x2d = row_view(x)
        out = (RMSNormFn.apply(x2d, w, eps) if _records(x, w)
               else rmsnorm_fwd(x2d, w, eps=eps))
        return out.reshape(x.shape)
    return rmsnorm_ref(x, w, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, delta [..., d] (one shape), w [d] -> (rmsnorm(x + delta) * w,
    x + delta), both in x's shape and dtype."""
    if _device_of(x, "add_rmsnorm") == "cuda":
        x2d, d2d = row_view(x), row_view(delta)
        out, r = (AddRMSNormFn.apply(x2d, d2d, w, eps)
                  if _records(x, delta, w)
                  else add_rmsnorm_fwd(x2d, d2d, w, eps=eps))
        return out.reshape(x.shape), r.reshape(x.shape)
    return add_rmsnorm_ref(x, delta, w, eps)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """y, z [..., d] (one shape), w [d] -> rmsnorm(y * silu(z)) * w in y's
    shape and dtype."""
    if _device_of(y, "gated_rmsnorm") == "cuda":
        y2d, z2d = row_view(y), row_view(z)
        out = (GatedRMSNormFn.apply(y2d, z2d, w, eps) if _records(y, z, w)
               else gated_rmsnorm_fwd(y2d, z2d, w, eps=eps))
        return out.reshape(y.shape)
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
        freqs = inv_freq(q.device, q.shape[-1], theta)
        if _records(q, k, wq, wk):
            return QKNormRopeFn.apply(q, k, wq, wk, positions, freqs, eps)
        return qk_norm_rope_fwd(q, k, wq, wk, positions, freqs, eps=eps)
    return qk_norm_rope_ref(q, k, wq, wk, positions, theta, eps)
