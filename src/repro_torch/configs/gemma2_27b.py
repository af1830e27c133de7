"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma2-27b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=36_864, vocab_size=256_000,
        local_global=True, sliding_window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        use_post_norm=True, embed_scale=True, attn_scale_dim=144,
        tie_embeddings=True, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, sliding_window=8, attn_scale_dim=16,
    )
