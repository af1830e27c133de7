"""Plain PyTorch version of flash-decode against a dense KV cache.

Mirrors the JAX oracle (``repro`` package,
``kernels/decode_attention/ref.py``) on every row that attends a slot.
A row that attends none (``lens == 0``, or a window that ends before the
row's first slot, as on a rank's range of a sequence-split cache) comes
out as zeros with a log-sum-exp of -inf, as the CUDA kernel writes it,
where the JAX oracle averages its values uniformly.  The CPU path of the
wrapper, the CPU tests and the card-side check in ``chip_smoke.py`` use
it.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_attention_ref(q, k_cache, v_cache, lens, *, scale, window=0,
                         softcap=0.0, ends=None, return_lse=False):
    """q: [B, Hq, 1, D]; caches [B, S, Hkv, D]; lens [B] (valid entries
    incl. the current token); ends [B] (the query's position + 1, from
    which a window is measured; ``lens`` when None).  -> [B, Hq, 1, D] in
    q's dtype; with ``return_lse`` also each head's log-sum-exp over the
    attended slots, fp32 [B, Hq] (-inf where the row attends none)."""
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
    m4 = mask[:, None, None]
    p = torch.softmax(torch.where(m4, s, torch.tensor(NEG_INF,
                                                      device=q.device)), -1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    o = torch.where(mask.any(-1)[:, None, None, None], o, 0.0)
    o = o.reshape(B, Hq, 1, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(torch.where(m4, s, -torch.inf), -1)
    return o, lse.reshape(B, Hq)
