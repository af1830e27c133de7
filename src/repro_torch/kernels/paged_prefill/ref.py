"""Plain PyTorch version of paged prefill attention.

Gathers each row's whole page table into a dense view and runs the
masked softmax of the JAX package's chunk path (``repro`` package,
``models/model.py::_paged_attn_block`` with ``chunk_attend``: the page
gather, then ``attention`` with ``q_positions = start + i`` and
``kv_len``), fp32 logits, in the model's layout.  The CPU path of the
wrapper, the CPU tests and the card-side checks use it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ref import NEG_INF, gather_pages


def paged_prefill_ref(q, k_pool, v_pool, table, start, kv_lens, *, scale,
                      softcap=0.0):
    """q: [B, C, Hq, D]; pools [P, page, Hkv, D]; table [B, maxp] int32;
    start [B] int32 (position of each row's first chunk query); kv_lens
    [B] int32 (valid tokens after the chunk's write).  Query i of row b
    attends key j where j <= start[b] + i and j < kv_lens[b].  -> [B, C,
    Hq, D] in q's dtype; a row with ``kv_lens == 0`` averages every slot
    of its table uniformly (the kernel writes zeros; callers never read
    such rows)."""
    B, C, Hq, D = q.shape
    k = gather_pages(k_pool, table)            # [B, S, Hkv, D]
    v = gather_pages(v_pool, table)
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, C, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    start = start.to(q.device).long()
    q_pos = start[:, None] + torch.arange(C, device=q.device)[None, :]
    k_pos = torch.arange(S, device=q.device)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) \
        & (k_pos[None, None, :] < kv_lens.to(q.device)[:, None, None])
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, C, Hq, D).to(q.dtype)
