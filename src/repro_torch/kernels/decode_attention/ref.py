"""Plain PyTorch version of flash-decode against a dense KV cache.

Mirrors the JAX oracle (``repro`` package,
``kernels/decode_attention/ref.py``).  The CPU path of the wrapper, the
CPU tests and the card-side check in ``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_attention_ref(q, k_cache, v_cache, lens, *, scale, window=0,
                         softcap=0.0, ends=None):
    """q: [B, Hq, 1, D]; caches [B, S, Hkv, D]; lens [B] (valid entries
    incl. the current token); ends [B] (the query's position + 1, from
    which a window is measured; ``lens`` when None).  -> [B, Hq, 1, D] in
    q's dtype."""
    B, Hq, _, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    kf = k_cache.movedim(2, 1).float()         # [B, Hkv, S, D]
    vf = v_cache.movedim(2, 1).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)[None, :]
    lens = lens.to(q.device)
    mask = k_pos < lens[:, None]
    if window > 0:
        ends = lens if ends is None else ends.to(q.device)
        mask = mask & (k_pos > (ends[:, None] - 1 - window))
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    return o.reshape(B, Hq, 1, D).to(q.dtype)
