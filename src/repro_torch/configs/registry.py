"""Architecture registry: ``--arch <id>`` resolution, shape applicability,
and ``input_specs()`` (``device="meta"`` stand-ins, no allocation)."""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                max_decode_len: int = 0) -> Dict[str, object]:
    """``device="meta"`` stand-ins for every input of the step (the JAX
    package's ``ShapeDtypeStruct``s): shapes and dtypes, no storage.

    * train:   batch dict for train_step
    * prefill: batch dict for prefill_step
    * decode:  {"token", "cache"} for decode_step (cache holds seq_len KV)
    """
    from repro_torch.models.params import torch_dtype
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f32 = torch.float32
    cdt = torch_dtype(cfg.compute_dtype)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.family == "encdec":
            half = S // 2
            return {
                "enc_embeds": sds((B, half, cfg.d_model), cdt),
                "tokens": sds((B, half), i32),
                "labels": sds((B, half), i32),
                "loss_mask": sds((B, half), f32),
            }
        if cfg.family == "vlm":
            s_img = S // 4
            s_text = S - s_img
            return {
                "patch_embeds": sds((B, s_img, cfg.d_model), cdt),
                "tokens": sds((B, s_text), i32),
                "labels": sds((B, S), i32),
                "loss_mask": sds((B, S), f32),
            }
        return {
            "tokens": sds((B, S), i32),
            "labels": sds((B, S), i32),
            "loss_mask": sds((B, S), f32),
        }

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            half = S // 2
            return {"enc_embeds": sds((B, half, cfg.d_model), cdt),
                    "tokens": sds((B, half), i32)}
        if cfg.family == "vlm":
            s_img = S // 4
            return {"patch_embeds": sds((B, s_img, cfg.d_model), cdt),
                    "tokens": sds((B, S - s_img), i32)}
        return {"tokens": sds((B, S), i32)}

    # decode: one new token against a seq_len-deep cache
    from repro_torch.models import model as model_lib
    cache = model_lib.init_cache(cfg, B, max_decode_len or S,
                                 abstract_only=True,
                                 cross_len=WHISPER_CROSS_LEN)
    return {"token": sds((B, 1), i32), "cache": cache}


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig, rng=None,
                    device=None):
    """Small-scale *allocated* inputs matching input_specs (smoke tests):
    the JAX package's draws from ``np.random.default_rng`` in the same
    order, so both packages give the same values; on the CPU unless
    ``device`` is given."""
    import numpy as np
    rng = np.random.default_rng(0 if rng is None else rng)
    specs = input_specs(cfg, shape)

    def make(path, s):
        if s.dtype == torch.int32:
            return torch.from_numpy(
                rng.integers(0, max(cfg.vocab_size - 1, 2), s.shape)
            ).to(device=device, dtype=torch.int32)
        if "mask" in str(path):
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        return torch.from_numpy(rng.normal(0, 0.02, s.shape)).to(
            device=device, dtype=s.dtype)

    out = {}
    for k, v in specs.items():
        if k == "cache":
            from repro_torch.models import model as model_lib
            out[k] = model_lib.init_cache(cfg, shape.global_batch,
                                          shape.seq_len,
                                          cross_len=WHISPER_CROSS_LEN,
                                          device=device)
        else:
            out[k] = make(k, v)
    return out


def smoke_shape(kind: str) -> ShapeConfig:
    """Tiny shape cells for CPU smoke tests."""
    return {
        "train": ShapeConfig("smoke_train", "train", 32, 2),
        "prefill": ShapeConfig("smoke_prefill", "prefill", 32, 2),
        "decode": ShapeConfig("smoke_decode", "decode", 32, 2),
    }[kind]
