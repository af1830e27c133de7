"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch. [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-coder-33b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=19_200, vocab_size=32_256,
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
    )
