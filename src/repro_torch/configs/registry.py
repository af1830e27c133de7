"""Architecture registry: ``--arch <id>`` resolution and shape
applicability.  (The abstract input stand-ins of the dry-run,
``input_specs`` / ``concrete_inputs``, come with the dry-run slice.)"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

WHISPER_CROSS_LEN = 1500


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.smoke_config() if smoke else mod.full_config()


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """The assigned shape cells this arch participates in.

    long_500k only for sub-quadratic archs (SSM/hybrid); all archs here have
    a decoder, so decode shapes apply everywhere (see DESIGN.md §4)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes


def all_cells() -> List[tuple]:
    """All assigned (arch_id, shape_name) cells (40 total)."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in applicable_shapes(cfg):
            cells.append((a, s))
    return cells


def smoke_shape(kind: str) -> ShapeConfig:
    """Tiny shape cells for CPU smoke tests."""
    return {
        "train": ShapeConfig("smoke_train", "train", 32, 2),
        "prefill": ShapeConfig("smoke_prefill", "prefill", 32, 2),
        "decode": ShapeConfig("smoke_decode", "decode", 32, 2),
    }[kind]
