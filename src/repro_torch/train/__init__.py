from repro_torch.train.step import (  # noqa: F401
    build_paged_decode_step,
    build_prefill_chunk_step,
)
