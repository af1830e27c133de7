"""Int8 error-feedback gradient compression, mirroring the JAX package's
``train/compression.py``.

Models the accuracy path of a compressed data-parallel all-reduce:
gradients are quantized to int8 with a per-tensor scale before the
(conceptual) reduce and dequantized after; the quantization residual is
carried in an error buffer and added back next step.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def init_error_buffer(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x.float()))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads_ef(grads, error_buf):
    """Apply int8 EF compression to a gradient tree.

    Returns (decompressed_grads, new_error_buf)."""
    def one(g, e):
        gf = g.float() + e
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                      tree_leaves(error_buf), strict=True)]
    new_g = tree_unflatten(grads, [o[0] for o in outs])
    new_e = tree_unflatten(grads, [o[1] for o in outs])
    return new_g, new_e
