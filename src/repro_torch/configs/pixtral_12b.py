"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend STUBBED (input_specs() provides patch
embeddings) + mistral-nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "pixtral-12b"
PATCH_FRACTION = 4  # 1/4 of the sequence is image patches (stub convention)


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14_336, vocab_size=131_072,
        rope_theta=1_000_000.0, frontend="vision_stub",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name=ARCH_ID + "-smoke",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
    )
