"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) moe_d_ff=2048
vocab=163840, MoE 384 experts top-8. Trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=112, d_ff=0, vocab_size=163_840,
        num_experts=384, experts_per_token=8, moe_d_ff=2048,
        rope_theta=50_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=256, num_experts=8, experts_per_token=2, moe_d_ff=96,
    )
