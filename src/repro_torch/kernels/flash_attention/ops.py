"""Flash-attention prefill in the model's layout.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  The JAX wrapper's transpose
and padding serve the TPU's tiling; here both tensors are views, the
kernel masks the ragged tail itself, and nothing is copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,  # [B, S, Hq, D] (model layout)
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D] views
    if q.is_cuda:
        out = flash_attention_fwd(qt, kt, vt, scale=scale, causal=causal,
                                  window=window, softcap=attn_softcap)
    elif q.device.type == "cpu":
        out = attention_ref(qt, kt, vt, scale=scale, causal=causal,
                            window=window, softcap=attn_softcap)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return out.transpose(1, 2)
