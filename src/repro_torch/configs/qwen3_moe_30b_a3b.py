"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=0, vocab_size=151_936,
        num_experts=128, experts_per_token=8, moe_d_ff=768,
        use_qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=256, num_experts=8, experts_per_token=2, moe_d_ff=96,
    )
