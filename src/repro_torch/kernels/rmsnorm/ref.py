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

The ``*_bwd_ref`` functions are the backward kernels' plain versions:
the explicit formulas, in fp32, that the CUDA backward kernels compute.
Only the tests and ``chip_smoke.py`` call them; on the CPU the ops take
the gradient by autograd of the plain forward.

The gated norm split over ranks by columns (Mamba2 under tensor
parallelism) has four plain versions, one per CUDA entry point:
``gated_rmsnorm_sumsq_ref`` (a row's partial sum of squares) and
``gated_rmsnorm_scale_ref`` (the norm given the summed one) forward,
``gated_rmsnorm_dot_ref`` and ``gated_rmsnorm_scale_bwd_ref`` backward;
the sums over the ranks lie between them, in the caller.
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


def gated_rmsnorm_sumsq_ref(y: torch.Tensor,
                            z: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares over the last axis of the gated product
    ``y * silu(z)`` (each rounded to y's dtype): one rank's partial of a
    row whose columns lie on several ranks -> [...] fp32."""
    g = (y * F.silu(z)).float()
    return torch.sum(g * g, dim=-1)


def gated_rmsnorm_scale_ref(y: torch.Tensor, z: torch.Tensor,
                            w: torch.Tensor, ss: torch.Tensor, d: int,
                            eps: float = 1e-6) -> torch.Tensor:
    """The gated norm of this rank's columns of rows of ``d``, given the
    whole rows' sum of squares ``ss`` [...] (fp32, summed over the
    ranks): ``(g * rsqrt(ss / d + eps)) * w`` in y's dtype, g = y *
    silu(z).  With ``ss`` this rank's own sum and ``d`` its width it is
    ``gated_rmsnorm_ref`` (the mean taken as sum / d)."""
    g = (y * F.silu(z)).float()
    out = g * torch.rsqrt(ss[..., None] / d + eps)
    return (out * w.float()).to(y.dtype)


def gated_rmsnorm_split_ref(y: torch.Tensor, z: torch.Tensor,
                            w: torch.Tensor, d: int, reduce,
                            eps: float = 1e-6) -> torch.Tensor:
    """The split gated norm as autograd traces it on the CPU: the
    partial sum of squares, ``reduce`` (the sum over the ranks holding
    the row's other columns, differentiable), then the scale."""
    return gated_rmsnorm_scale_ref(y, z, w, reduce(
        gated_rmsnorm_sumsq_ref(y, z)), d, eps)


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


# --- the backward kernels' plain versions ------------------------------------

def rmsnorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm_ref``: dy, x [..., d], w [d] -> (dx in
    x's dtype, dw in w's dtype).  rstd = rsqrt(mean(x^2) + eps), xhat =
    x * rstd, g = dy * w, dx = rstd * (g - xhat * mean(g * xhat)), dw =
    the sum over rows of dy * xhat, all in fp32."""
    d = x.shape[-1]
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dyf = dy.float()
    g = dyf * w.float()
    dx = rstd * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def add_rmsnorm_bwd_ref(dh: torch.Tensor, dr: Optional[torch.Tensor],
                        r: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``add_rmsnorm_ref`` from those of its outputs (out
    and r = x + delta; dr None: 0): (the gradient of x and of delta, dw).
    The norm's dx is in r's dtype before torch's add of dr, as autograd
    of the unfused add and norm has it."""
    dx, dw = rmsnorm_bwd_ref(dh, r, w, eps)
    return (dx if dr is None else dx + dr), dw


def gated_rmsnorm_bwd_ref(dout: torch.Tensor, y: torch.Tensor,
                          z: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The gradient of ``gated_rmsnorm_ref``: (dy, dz, dw).  With s =
    silu(z) and g = y * s (each in y's dtype, as the forward rounds
    them): dg = rmsnorm's dx at g, dy = dg * s, dz = (dg * y) * silu'(z),
    silu'(z) = sig * (1 + z * (1 - sig)) with sig = 1 / (1 + exp(-z)) in
    fp32."""
    s = F.silu(z)
    dg, dw = rmsnorm_bwd_ref(dout, y * s, w, eps)
    zf = z.float()
    sig = 1.0 / (1.0 + torch.exp(-zf))
    dz = (dg * y).float() * (sig * (1.0 + zf * (1.0 - sig)))
    return dg * s, dz.to(z.dtype), dw


def gated_rmsnorm_dot_ref(dout: torch.Tensor, y: torch.Tensor,
                          z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The split backward's partial: ``sum(dout * w * g)`` over the last
    axis in fp32, g = y * silu(z) as the forward rounds it -> [...]."""
    g = (y * F.silu(z)).float()
    return torch.sum(dout.float() * w.float() * g, dim=-1)


def gated_rmsnorm_scale_bwd_ref(dout: torch.Tensor, y: torch.Tensor,
                                z: torch.Tensor, w: torch.Tensor,
                                ss: torch.Tensor, dot: torch.Tensor, d: int,
                                eps: float = 1e-6
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The gradient of ``gated_rmsnorm_scale_ref`` at the whole rows' sum
    of squares ``ss`` and sum ``dot`` of ``dout * w * g`` (both summed
    over the ranks): (dy, dz, dw of this rank's columns).  With rstd =
    rsqrt(ss / d + eps) and c = rstd^2 * dot / d: dg = rstd * (dout * w -
    g * c) in y's dtype, then the gate's chain as
    ``gated_rmsnorm_bwd_ref``; dw = the sum over rows of dout * g *
    rstd."""
    s = F.silu(z)
    g = (y * s).float()
    rstd = torch.rsqrt(ss[..., None] / d + eps)
    c = rstd * rstd * dot[..., None] / d
    dof = dout.float()
    dg = (rstd * (dof * w.float() - g * c)).to(y.dtype)
    dw = (dof * (g * rstd)).reshape(-1, w.shape[0]).sum(0)
    zf = z.float()
    sig = 1.0 / (1.0 + torch.exp(-zf))
    dz = (dg * y).float() * (sig * (1.0 + zf * (1.0 - sig)))
    return dg * s, dz.to(z.dtype), dw.to(w.dtype)


def rope_bwd_ref(dout: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """The gradient of ``apply_rope``: the rotation of dout [B, S, H, D]
    by the negative angle (RoPE's transpose), in dout's dtype."""
    d = dout.shape[-1]
    inv = rope_freqs(d, theta, device=dout.device)
    angles = positions.float()[..., None] * inv
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    d1, d2 = dout[..., : d // 2].float(), dout[..., d // 2:].float()
    return torch.cat([d1 * cos + d2 * sin, d2 * cos - d1 * sin],
                     dim=-1).to(dout.dtype)


def qk_norm_rope_bwd_ref(dq: torch.Tensor, dk: torch.Tensor, q: torch.Tensor,
                         k: torch.Tensor, wq: Optional[torch.Tensor],
                         wk: Optional[torch.Tensor], positions: torch.Tensor,
                         theta: float, eps: float = 1e-6):
    """The gradient of ``qk_norm_rope_ref`` from those of q' and k': RoPE's
    transpose, then (with weights) the norm's backward per head -> (dq,
    dk, dwq, dwk), dwq and dwk None without weights."""
    dnq, dnk = rope_bwd_ref(dq, positions, theta), rope_bwd_ref(
        dk, positions, theta)
    if wq is None:
        return dnq, dnk, None, None
    dq_in, dwq = rmsnorm_bwd_ref(dnq, q, wq, eps)
    dk_in, dwk = rmsnorm_bwd_ref(dnk, k, wk, eps)
    return dq_in, dk_in, dwq, dwk
