"""Dense flash-decode: contiguous KV cache, CUDA kernel + plain version."""
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_ref,
)
