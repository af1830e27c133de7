"""Mamba2 SSD chunked scan in the model's layout.

On a CUDA tensor this always launches the CUDA kernel (or raises); on a
CPU tensor it runs the plain PyTorch version.  No flag and no fallback
routes a CUDA tensor to the plain version.  Unlike the JAX wrapper, B
and C are not repeated to heads, S is not padded to the chunk and an
initial state is not folded in after the kernel: the kernel does all
three itself (see ``kernel.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(
    xb: torch.Tensor,      # [B, S, H, P]
    a: torch.Tensor,       # [B, S, H]
    B_mat: torch.Tensor,   # [B, S, G, N]
    C_mat: torch.Tensor,   # [B, S, G, N]
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P] in xb's dtype, final_state [B,H,P,N] fp32)."""
    if xb.is_cuda:
        init = (None if initial_state is None
                else initial_state.float().contiguous())
        return ssd_scan_fwd(xb, a.float(), B_mat, C_mat, chunk=chunk,
                            initial_state=init)
    if xb.device.type == "cpu":
        return ssd_scan_ref(xb, a, B_mat, C_mat, chunk=chunk,
                            initial_state=initial_state)
    raise ValueError(f"ssd_scan runs on cuda or cpu, got {xb.device}")
