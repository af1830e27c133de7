"""Plain PyTorch RMSNorm.

Mirrors the JAX package's ``models/layers.py::rms_norm`` (which
``kernels/rmsnorm/ref.py`` there wraps): the mean of squares in fp32,
``rsqrt``, times ``w`` in fp32, cast back to x's dtype.  It does not
import the port's ``layers``, which dispatches to this package.  The CPU
path of the wrapper, the CPU tests and the card-side check in
``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x [..., d], w [d] -> x / rms(x) * w in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)
