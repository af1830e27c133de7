"""Core layers: norms, rotary embeddings, activations, MLP."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
# RoPE's formula lives beside the plain version of the fused qk-norm-RoPE
# kernel that computes it
from repro_torch.kernels.rmsnorm.ref import (  # noqa: F401
    apply_rope, rope_freqs)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype. (1+w) convention NOT used.

    The device decides, not a flag, here and in the fused norms below: a
    CUDA tensor goes through the CUDA kernel, a CPU tensor through its
    plain version (the JAX package's formula, ``kernels/rmsnorm/ref.py``)."""
    return rmsnorm_ops.rmsnorm(x, weight, eps)


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 weight: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add of a pending block output and the next pre-norm:
    -> (rms_norm(x + delta), x + delta), one launch on the card.  With no
    pending ``delta`` (the stack's first norm) -> (rms_norm(x), x)."""
    if delta is None:
        return rms_norm(x, weight, eps), x
    return rmsnorm_ops.add_rmsnorm(x, delta, weight, eps)


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated norm, rms_norm(y * silu(z)): one launch on the
    card."""
    return rmsnorm_ops.gated_rmsnorm(y, z, weight, eps)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor,
                 wq: Optional[torch.Tensor], wk: Optional[torch.Tensor],
                 positions: torch.Tensor, theta: float,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The qk-norm of q [B,S,Hq,D] and k [B,S,Hkv,D] (skipped when wq and
    wk are None), then ``apply_rope`` of both at ``positions`` ([B, S],
    [S] or [1]): one launch on the card."""
    return rmsnorm_ops.qk_norm_rope(q, k, wq, wk, positions, theta, eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # the JAX default, not erf
    raise ValueError(f"unknown activation {kind!r}")


def sinusoidal_positions(seq_len: int, d_model: int) -> torch.Tensor:
    """Whisper-encoder style sinusoidal positional embedding [S, D]
    (fp32, on the CPU): sin of each position times ``d_model // 2``
    frequencies spaced geometrically from 1 to 1/10000, then their cos."""
    half = d_model // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, dtype=torch.float64))
                      * torch.arange(half, dtype=torch.float64)
                      / max(half - 1, 1))
    pos = torch.arange(seq_len, dtype=torch.float64)[:, None] * freqs[None]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=1).float()


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
        wo: torch.Tensor, act: str) -> torch.Tensor:
    """x: [..., d]; wi_*: [d, f]; wo: [f, d]."""
    g = activation(x @ wi_gate, act)
    u = x @ wi_up
    return (g * u) @ wo
