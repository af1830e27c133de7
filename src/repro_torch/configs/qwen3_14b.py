"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-14b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17_408, vocab_size=151_936,
        use_qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
    )
