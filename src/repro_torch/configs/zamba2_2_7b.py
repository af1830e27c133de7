"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 blocks + one SHARED attention+MLP block
applied every 6 blocks (9 applications, per-application KV cache).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "zamba2-2.7b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=10_240, vocab_size=32_000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        ssm_chunk=128, conv_width=4, attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, attn_every=2,
    )
