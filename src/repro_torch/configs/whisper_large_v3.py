"""whisper-large-v3 [audio] — 32L (per stack) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866; enc-dec; conv/mel frontend STUBBED — input_specs()
provides precomputed frame embeddings. [arXiv:2212.04356; unverified]

Note: decode shapes use the assigned 32k self-KV length (exceeds real
whisper's 448-token decoder ctx; exercises the backbone as instructed)
plus a fixed 1500-frame cross-attention KV."""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-large-v3"
CROSS_LEN = 1500


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        head_dim=64, d_ff=5120, vocab_size=51_866,
        is_encdec=True, act="gelu", tie_embeddings=True,
        frontend="audio_stub",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=192, vocab_size=256,
    )
