"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA, tied embeddings. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-0.6b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=3072, vocab_size=151_936,
        use_qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
    )
