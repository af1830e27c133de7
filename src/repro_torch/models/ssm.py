"""Mamba2 (state-space duality) blocks: chunked prefill + O(1) decode.

Mirrors the JAX package's ``models/ssm.py``.  The chunked scan goes to
``kernels/ssd_scan``: the hand-written CUDA kernel on a CUDA tensor, the
plain mirror of the JAX jnp branch on a CPU tensor.  The gate and its norm
(``y * silu(z)``, then RMSNorm) are one fused RMSNorm launch on the card.
The depthwise conv and the one-step decode update stay plain PyTorch, as
in the JAX package (no kernel there either).  The train mode
(``differentiable=True``, set by the model's mode) takes the plain scan
on any device: the kernel has no backward, and the JAX package trains
through its plain ``ssd_chunked``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.layers import gated_rms_norm


class SSMState(NamedTuple):
    ssm: torch.Tensor    # [B, H, P, N]
    conv: torch.Tensor   # [B, W-1, conv_channels]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B,S,ch], w: [W,ch], b: [ch]."""
    W = w.shape[0]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        shift = W - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]]
        out = out + xi.float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_step(cache: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv.
    cache: [B, W-1, ch], x_t: [B, ch]."""
    window = torch.cat([cache, x_t[:, None]], dim=1)  # [B, W, ch]
    y = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b.float()
    new_cache = window[:, 1:]
    return new_cache, y.to(x_t.dtype)


def ssd_chunked(
    xb: torch.Tensor,      # [B, S, H, P] dt-weighted inputs (x * dt)
    a: torch.Tensor,       # [B, S, H] log-decay per step (dt * A, A < 0)
    B_mat: torch.Tensor,   # [B, S, G, N]
    C_mat: torch.Tensor,   # [B, S, G, N]
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
    use_pallas: bool = False,
    differentiable: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,S,H,P], final_state [B,H,P,N]).

    The tensor's device decides: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor; ``differentiable`` (the model's train
    mode) takes the plain version on any device, which autograd can
    differentiate.  ``use_pallas`` is kept for the callers' signature
    and has no effect."""
    if differentiable:
        return ssd_scan_ref(xb, a, B_mat, C_mat, chunk=chunk,
                            initial_state=initial_state)
    return ssd_ops.ssd_scan(xb, a, B_mat, C_mat, chunk=chunk,
                            initial_state=initial_state)


def ssd_decode_step(
    state: torch.Tensor,   # [B, H, P, N] fp32
    x: torch.Tensor,       # [B, H, P]
    dt: torch.Tensor,      # [B, H] (post-softplus)
    A: torch.Tensor,       # [H] (negative)
    B_vec: torch.Tensor,   # [B, G, N]
    C_vec: torch.Tensor,   # [B, G, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent update. Returns (new_state, y [B,H,P])."""
    B, H, P, N = state.shape
    G = B_vec.shape[1]
    rep = H // G
    Bh = torch.repeat_interleave(B_vec, rep, dim=1).float()   # [B,H,N]
    Ch = torch.repeat_interleave(C_vec, rep, dim=1).float()
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())                         # [B,H]
    xdt = x.float() * dtf[..., None]                           # [B,H,P]
    new_state = (state * decay[:, :, None, None]
                 + xdt[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return new_state, y


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg) -> dict:
    di = cfg.d_inner
    H = cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = di + 2 * G * N
    return dict(di=di, H=H, G=G, N=N, P=cfg.ssm_head_dim, conv_ch=conv_ch,
                in_dim=2 * di + 2 * G * N + H)


def mamba2_block(p: dict, cfg, x: torch.Tensor,
                 state: Optional[SSMState] = None,
                 *, decode: bool = False, differentiable: bool = False):
    """Mamba2 block. x: [B,S,d] (S=1 when decode=True).  In a prefill,
    ``state.ssm`` may be None: the scan then starts from a zero state.
    The train mode passes ``state=None`` and ``differentiable=True`` (the
    plain scan; no state is returned).

    Returns (y [B,S,d], new_state | None).
    """
    d = mamba2_dims(cfg)
    di, H, G, N, P = d["di"], d["H"], d["G"], d["N"], d["P"]
    Bsz, S, _ = x.shape

    proj = x @ p["in_proj"]
    z, xBC_raw, dt_raw = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)

    if decode:
        assert state is not None and S == 1
        new_conv, xBC_t = conv_step(state.conv, xBC_raw[:, 0], p["conv_w"],
                                    p["conv_b"])
        xBC = F.silu(xBC_t)[:, None]                 # [B,1,conv_ch]
    else:
        xBC = F.silu(causal_conv1d(xBC_raw, p["conv_w"], p["conv_b"]))

    x_ssm, B_mat, C_mat = torch.split(xBC, [di, G * N, G * N], dim=-1)
    x_ssm = x_ssm.reshape(Bsz, S, H, P)
    B_mat = B_mat.reshape(Bsz, S, G, N)
    C_mat = C_mat.reshape(Bsz, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())    # [B,S,H]
    A = -torch.exp(p["A_log"].float())                        # [H]

    if decode:
        new_ssm, y = ssd_decode_step(
            state.ssm, x_ssm[:, 0], dt[:, 0], A, B_mat[:, 0], C_mat[:, 0])
        y = y[:, None]                                         # [B,1,H,P]
        new_state = SSMState(ssm=new_ssm, conv=new_conv)
    else:
        xb = x_ssm * dt[..., None].to(x_ssm.dtype)
        a = dt * A                                             # [B,S,H]
        init = state.ssm if state is not None else None
        y, final = ssd_chunked(xb, a, B_mat, C_mat, chunk=cfg.ssm_chunk,
                               initial_state=init,
                               use_pallas=cfg.use_pallas,
                               differentiable=differentiable)
        if state is not None:
            new_state = SSMState(ssm=final,
                                 conv=_conv_tail(xBC_raw, cfg.conv_width))
        else:
            new_state = None

    y = y + x_ssm.float() * p["D"].float()[:, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], new_state


def _conv_tail(xBC_raw, width: int) -> torch.Tensor:
    """Last (width-1) *raw* (pre-conv, pre-silu) inputs — exactly what
    ``conv_step`` expects as its rolling cache during decode."""
    return xBC_raw[:, -(width - 1):]


def init_ssm_state(cfg, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    d = mamba2_dims(cfg)
    return SSMState(
        ssm=torch.zeros((batch, d["H"], cfg.ssm_head_dim, d["N"]),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, d["conv_ch"]),
                         dtype=dtype, device=device),
    )
