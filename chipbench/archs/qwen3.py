"""Qwen3 and Qwen3-MoE: the port's config of a configuration file (the
keys of the published ``config.json``), the plain reference
(``chipbench/reference/qwen3.py``) and the useful FLOPs.

The FLOPs: 2 per active parameter and token (the MoE at its routed
experts, the router included), plus attention over the live context
(4 * Hq * D per attended (query, key) pair and layer), plus the LM head
for each row whose logits are read; training is 3 times the forward
(the recomputation is not useful work)."""
from __future__ import annotations

from typing import Iterable, Tuple

from chipbench.reference import qwen3 as reference  # noqa: F401

MODEL_TYPES = ("qwen3", "qwen3_moe")


def model_config(config: dict, training: bool = False, **overrides):
    """The port's ``ModelConfig`` of a qwen3 / qwen3_moe configuration
    file; with ``training``, the file's training settings (parameter
    dtype, recomputation)."""
    from repro_torch.configs.base import ModelConfig
    moe = config["model_type"] == "qwen3_moe"
    kw = dict(
        name=config["name"], family="moe" if moe else "dense",
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"],
        d_ff=0 if moe else config["intermediate_size"],
        vocab_size=config["vocab_size"],
        use_qk_norm=True, rope_theta=float(config["rope_theta"]),
        tie_embeddings=bool(config["tie_word_embeddings"]),
        norm_eps=float(config["rms_norm_eps"]),
        act=config["hidden_act"],
        param_dtype=config["torch_dtype"],
        compute_dtype=config["torch_dtype"])
    if moe:
        kw.update(num_experts=config["num_experts"],
                  experts_per_token=config["num_experts_per_tok"],
                  moe_d_ff=config["moe_intermediate_size"],
                  capacity_factor=float(config["capacity_factor"]))
    if training:
        kw.update(param_dtype=config["training"]["param_dtype"],
                  remat=config["training"]["remat"])
    kw.update(overrides)
    return ModelConfig(**kw)


def body_params_per_token(cfg) -> int:
    """Parameters of the layers one token multiplies (embedding lookup
    and LM head apart)."""
    d, D = cfg.d_model, cfg.head_dim
    attn = d * D * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    if cfg.family == "moe":
        ffn = (3 * d * cfg.moe_d_ff * cfg.experts_per_token
               + d * cfg.num_experts)
    else:
        ffn = 3 * d * cfg.d_ff
    return cfg.num_layers * (attn + ffn)


def attention_pairs(rows: Iterable[Tuple[int, int]]) -> int:
    """(query, key) pairs of rows given as (first position, tokens): a
    token at position p attends p + 1 keys."""
    total = 0
    for start, n in rows:
        total += n * start + n * (n + 1) // 2
    return total


def forward_flops(cfg, rows: Iterable[Tuple[int, int]],
                  logits_rows: int) -> float:
    """FLOPs of a forward over ``rows`` ((first position, tokens) each)
    with ``logits_rows`` rows of logits."""
    rows = list(rows)
    tokens = sum(n for _, n in rows)
    pairs = attention_pairs(rows)
    return (2.0 * body_params_per_token(cfg) * tokens
            + 4.0 * cfg.num_heads * cfg.head_dim * cfg.num_layers * pairs
            + 2.0 * cfg.d_model * cfg.vocab_size * logits_rows)


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Useful FLOPs of one train step of ``batch`` rows of ``seq``."""
    return 3.0 * forward_flops(cfg, [(0, seq)] * batch, batch * seq)
