"""Paged prefill attention in the model's layout.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_prefill.kernel import paged_prefill_fwd
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref


def paged_prefill(
    q: torch.Tensor,           # [B, C, Hq, D] (model layout)
    k_pool: torch.Tensor,      # [P, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,
    table: torch.Tensor,       # [B, maxp] int32 (unused slots -> 0)
    start: torch.Tensor,       # [B] int32: each row's first position
    kv_lens: torch.Tensor,     # [B] int32: valid tokens after the write
    *,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.is_cuda:
        return paged_prefill_fwd(q, k_pool, v_pool, table, start, kv_lens,
                                 scale=scale, softcap=attn_softcap)
    if q.device.type == "cpu":
        return paged_prefill_ref(q, k_pool, v_pool, table, start, kv_lens,
                                 scale=scale, softcap=attn_softcap)
    raise ValueError(f"paged_prefill runs on cuda or cpu, got {q.device}")
