"""Core layers: norms, rotary embeddings, activations, MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype. (1+w) convention NOT used."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
        wo: torch.Tensor, act: str) -> torch.Tensor:
    """x: [..., d]; wi_*: [d, f]; wo: [f, d]."""
    g = activation(x @ wi_gate, act)
    u = x @ wi_up
    return (g * u) @ wo
