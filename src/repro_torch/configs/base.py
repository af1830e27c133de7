"""Model/run configuration dataclasses.

One ``ModelConfig`` describes any architecture in the assigned pool:
dense / MoE / SSM / hybrid / enc-dec / vlm. Per-arch files under
``repro/configs/`` instantiate the exact published configs plus a reduced
smoke config of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- attention details ---
    use_qk_norm: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 0        # gemma2 local layers: 4096
    local_global: bool = False     # gemma2 alternating local/global
    rope_theta: float = 10_000.0
    use_post_norm: bool = False    # gemma2 sandwich norms
    embed_scale: bool = False      # gemma2: multiply embeddings by sqrt(d)
    attn_scale_dim: int = 0        # 0 -> head_dim; gemma2-27b: d/H = 144
    # perf levers (EXPERIMENTS.md §Perf): f32 attention logits are the
    # numerically-safe default; bf16 (with max-subtraction) halves the
    # S^2 softmax traffic and kills materialized bf16->f32 dot converts
    attn_f32_logits: bool = True

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    conv_width: int = 4

    # --- hybrid (zamba2): shared attention block every N ssm blocks ---
    attn_every: int = 0

    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    # vlm/audio frontends are stubs: input_specs() provides embeddings.
    frontend: str = "none"  # "none" | "audio_stub" | "vision_stub"

    # --- generic ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"  # "silu" | "gelu"
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots"
    use_pallas: bool = False  # swap in Pallas kernels (TPU target)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports the long_500k decode shape (SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / runtime knobs for the training driver."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    adam_dtype: str = "float32"   # "bfloat16" for the 1T-class archs
    microbatch: Optional[int] = None  # gradient accumulation microbatch
    seed: int = 0
    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    keep_checkpoints: int = 3
    # distributed-optimization tricks
    grad_compression: str = "none"  # "none" | "int8_ef" (error feedback)
