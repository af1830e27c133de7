from repro_torch.train.step import (  # noqa: F401
    build_decode_step,
    build_loss_fn,
    build_paged_decode_step,
    build_prefill_chunk_step,
    build_prefill_step,
    build_train_step,
    build_train_step_compressed,
)
