"""Paged flash-decode in the model's layout.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_fwd
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(
    q: torch.Tensor,           # [B, 1, Hq, D] (model layout)
    k_pool: torch.Tensor,      # [P, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp] int32 (unused slots -> 0)
    lens,                      # [B] int32: valid tokens incl. current
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    lens = torch.as_tensor(lens, dtype=torch.int32,
                           device=q.device).expand(B).contiguous()
    qt = q.transpose(1, 2)                     # [B, Hq, 1, D], same memory
    if q.is_cuda:
        out = paged_attention_fwd(qt, k_pool, v_pool, page_table, lens,
                                  scale=scale, window=window,
                                  softcap=attn_softcap)
    elif q.device.type == "cpu":
        out = paged_attention_ref(qt, k_pool, v_pool, page_table, lens,
                                  scale=scale, window=window,
                                  softcap=attn_softcap)
    else:
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return out.transpose(1, 2)
