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
    slot_offset: int = 0,
    return_lse: bool = False,
):
    """-> [B, 1, Hq, D] in q's dtype; with ``return_lse`` also each head's
    log-sum-exp, fp32 [B, Hq].  ``slot_offset`` is the global slot of
    ``k_cache``'s first: the caches are then one rank's range of a cache split over the sequence,
    and the attention covers the attended slots inside the range (none:
    zeros, lse -inf)."""
    B, _, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    # on q's device (no read-back), broadcast to [B]: ends = the position
    # + 1, and lens = min(ends, S), the valid slots, each shifted by the
    # range's first slot and lens clamped into [0, S].  A position past
    # the last slot (its token written onto slot S - 1, as JAX's
    # dynamic_update_slice clamps the write) sees every slot valid and
    # measures a window from the position itself, as JAX's plain path.
    # The last rank's range ends at the whole cache's last slot, so no
    # range needs the whole cache's length.
    ends = (torch.as_tensor(cache_len, device=q.device).to(torch.int32)
            + (1 - slot_offset)).expand(B).contiguous()
    lens = torch.clamp(ends, 0, k_cache.shape[1])
    qt = q.transpose(1, 2)                     # [B, Hq, 1, D], same memory
    kw = dict(window=window, softcap=attn_softcap, ends=ends)
    if q.is_cuda:
        res = decode_attention_fwd(qt, k_cache, v_cache, lens, scale=scale,
                                   lse=return_lse, **kw)
    elif q.device.type == "cpu":
        res = decode_attention_ref(qt, k_cache, v_cache, lens, scale=scale,
                                   return_lse=return_lse, **kw)
    else:
        raise ValueError(f"decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)
