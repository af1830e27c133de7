"""Dense flash-decode in the model's layout.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  Unlike the JAX wrapper, the
cache is not padded to the kernel's chunk (that would copy the whole
cache in every layer of every step): the kernel masks the tail itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, D] (model layout)
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,
    cache_len,              # scalar or [B]: position of the current token
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, _, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    # on q's device (no read-back), broadcast to [B]: ends = the position
    # + 1, and lens = min(ends, S), the valid slots.  A position past the
    # last slot (its token written onto slot S - 1, as JAX's
    # dynamic_update_slice clamps the write) sees every slot valid and
    # measures a window from the position itself, as JAX's plain path.
    ends = (torch.as_tensor(cache_len, device=q.device).to(torch.int32)
            + 1).expand(B).contiguous()
    lens = torch.clamp(ends, max=k_cache.shape[1])
    qt = q.transpose(1, 2)                     # [B, Hq, 1, D], same memory
    if q.is_cuda:
        out = decode_attention_fwd(qt, k_cache, v_cache, lens, scale=scale,
                                   window=window, softcap=attn_softcap,
                                   ends=ends)
    elif q.device.type == "cpu":
        out = decode_attention_ref(qt, k_cache, v_cache, lens, scale=scale,
                                   window=window, softcap=attn_softcap,
                                   ends=ends)
    else:
        raise ValueError(f"decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return out.transpose(1, 2)
