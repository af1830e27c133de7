"""Plain PyTorch version of paged decode attention.

Gathers each sequence's pages into a dense per-request view and runs the
same masked-softmax math as the JAX oracle (``repro`` package,
``kernels/paged_attention/ref.py``).  The CPU path of the wrapper, the
CPU tests and the card-side check in ``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[P, page, Hkv, D] pool + [B, maxp] table -> dense [B, maxp*page,
    Hkv, D] view (junk beyond each sequence's length; callers mask)."""
    B, maxp = page_table.shape
    page, Hkv, D = pool.shape[1:]
    out = pool[page_table.long()]              # [B, maxp, page, Hkv, D]
    return out.reshape(B, maxp * page, Hkv, D)


def paged_attention_ref(q, k_pool, v_pool, page_table, lens, *, scale,
                        window=0, softcap=0.0):
    """q: [B, Hq, 1, D]; pools [P, page, Hkv, D]; page_table [B, maxp]
    int32; lens [B] int32 (valid tokens incl. the current one).
    -> [B, Hq, 1, D]."""
    B, Hq, _, D = q.shape
    k = gather_pages(k_pool, page_table)       # [B, S, Hkv, D]
    v = gather_pages(v_pool, page_table)
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    kf = k.movedim(2, 1).float()               # [B, Hkv, S, D]
    vf = v.movedim(2, 1).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)[None, :]
    lens = lens.to(q.device)
    mask = k_pos < lens[:, None]
    if window > 0:
        mask = mask & (k_pos > (lens[:, None] - 1 - window))
    s = torch.where(mask[:, None, None], s, torch.tensor(NEG_INF,
                                                         device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vf)
    return o.reshape(B, Hq, 1, D).to(q.dtype)
