"""Plain PyTorch RMSNorm, the rotary embedding, and the three fusions.

``rmsnorm_ref`` mirrors the JAX package's ``models/layers.py::rms_norm``
(which ``kernels/rmsnorm/ref.py`` there wraps): the mean of squares in
fp32, ``rsqrt``, times ``w`` in fp32, cast back to x's dtype.
``rope_freqs`` and ``apply_rope`` mirror that module's RoPE (halves, not
interleaved pairs); the port's ``layers.py`` takes them from here.  Each
fused plain version is the eager sequence its kernel replaces, op for op,
so on the CPU the model computes what it computed before the fusion.
This module does not import the port's ``layers``, which dispatches to
this package.  The CPU path of the wrappers, the CPU tests and the
card-side checks in ``chip_smoke.py`` use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x [..., d], w [d] -> x / rms(x) * w in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (rmsnorm(x + delta) * w, x + delta)."""
    r = x + delta
    return rmsnorm_ref(r, w, eps), r


def gated_rmsnorm_ref(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated norm: rmsnorm(y * silu(z)) * w."""
    return rmsnorm_ref(y * F.silu(z), w, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, fp32, shape [head_dim // 2]."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]).

    x: [B, S, H, D]; positions: [B, S] (or [S]) int.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # [d/2]
    angles = positions.float()[..., None] * inv  # [B, S, d/2]
    cos = torch.cos(angles)[..., None, :]        # [B, S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def qk_norm_rope_ref(q: torch.Tensor, k: torch.Tensor,
                     wq: Optional[torch.Tensor], wk: Optional[torch.Tensor],
                     positions: torch.Tensor, theta: float,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The qk-norm of q and k (skipped when wq and wk are None), then RoPE
    of both at ``positions``."""
    if wq is not None:
        q, k = rmsnorm_ref(q, wq, eps), rmsnorm_ref(k, wk, eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)
