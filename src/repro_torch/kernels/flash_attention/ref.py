"""Plain PyTorch version of flash attention (prefill), fp32 softmax.

Mirrors the JAX oracle (``repro`` package,
``kernels/flash_attention/ref.py``) in the kernel layout ``[B, H, S, D]``.
The CPU path of the wrapper, the CPU tests and the card-side check in
``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                  seq_len=0):
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D]; keys at or past ``seq_len``
    (0 -> S) are masked.  Returns [B, Hq, S, D] in q's dtype."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    true_len = seq_len or S
    qg = q.reshape(B, Hkv, G, S, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = k_pos < true_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, S, D).to(q.dtype)
