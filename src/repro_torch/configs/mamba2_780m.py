"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, vocab=50280,
ssm_state=128; SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-780m"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=50_280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        ssm_chunk=128, conv_width=4,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    )
