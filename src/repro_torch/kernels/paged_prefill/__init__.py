"""Paged prefill: a chunk's queries over each row's own pages, CUDA
kernel + plain version."""
from repro_torch.kernels.paged_prefill.ops import paged_prefill  # noqa: F401
from repro_torch.kernels.paged_prefill.ref import (  # noqa: F401
    paged_prefill_ref,
)
