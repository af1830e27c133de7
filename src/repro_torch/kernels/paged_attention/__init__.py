"""Paged decode attention: page-table KV pool, CUDA kernel + plain version."""
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: F401
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    gather_pages,
    paged_attention_ref,
)
