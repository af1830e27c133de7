"""Model assembly: parameter specs for every family, and the paged-serving
forward passes.

Mirrors the JAX package's ``models/model.py``.  ``param_specs``,
``abstract`` and ``init_cache(abstract_only=True)`` cover every family
(dense / moe / encdec / vlm / ssm / hybrid), so the footprint estimator
sees the same byte counts.  The forward passes here are the paged subset
that serving runs (``prefill_chunk`` / ``decode_step_paged``) for the
dense and vlm families; the rest (MoE blocks, the dense cache, training,
SSM and the remaining families) comes in later slices of the port.

Design rules:
  * Plain functions over a nested dict of tensors, stacked ``[L, ...]``
    per layer; a Python loop over layers replaces ``lax.scan``.
  * Same spec tree drives abstract (``device="meta"``) and concrete init.
  * Weights keep the JAX layouts (``wq`` is ``[d, Hq*hd]``; ``x @ W``).
  * The paged KV pools are updated in place (see ``_paged_kv_write``):
    a step consumes the cache it is given, like a donated JAX buffer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention, paged_decode_attention
from repro_torch.models.layers import apply_rope, mlp, rms_norm, softcap
from repro_torch.models.params import (P, abstract_params, init_params,
                                       torch_dtype)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _stack(specs: Dict[str, P], n: int) -> Dict[str, P]:
    return {k: P((n,) + v.shape, v.init, v.axis, v.scale, v.dtype)
            for k, v in specs.items()}


def _attn_specs(cfg: ModelConfig) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.head_dim
    s: Dict[str, P] = {
        "ln_w": P((d,), "ones"),
        "wq": P((d, cfg.num_heads * hd)),
        "wk": P((d, cfg.num_kv_heads * hd)),
        "wv": P((d, cfg.num_kv_heads * hd)),
        "wo": P((cfg.num_heads * hd, d)),
    }
    if cfg.use_qk_norm:
        s["q_norm"] = P((hd,), "ones")
        s["k_norm"] = P((hd,), "ones")
    if cfg.use_post_norm:
        s["post_ln_w"] = P((d,), "ones")
    return s


def _mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, P]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "ln_w": P((d,), "ones"),
        "wi_gate": P((d, f)),
        "wi_up": P((d, f)),
        "wo": P((f, d)),
    }
    if cfg.use_post_norm:
        s["post_ln_w"] = P((d,), "ones")
    return s


def _moe_specs(cfg: ModelConfig) -> Dict[str, P]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "ln_w": P((d,), "ones"),
        "w_router": P((d, E), "small", scale=0.02, dtype="float32"),
        "w_gate": P((E, d, f)),
        "w_up": P((E, d, f)),
        "w_down": P((E, f, d), axis=-2),
    }


def _mamba_specs(cfg: ModelConfig) -> Dict[str, P]:
    dm = ssm_mod.mamba2_dims(cfg)
    d = cfg.d_model
    return {
        "ln_w": P((d,), "ones"),
        "in_proj": P((d, dm["in_dim"])),
        "conv_w": P((cfg.conv_width, dm["conv_ch"]), "small", scale=0.1),
        "conv_b": P((dm["conv_ch"],), "zeros"),
        "dt_bias": P((dm["H"],), "zeros", dtype="float32"),
        "A_log": P((dm["H"],), "ones", dtype="float32"),
        "D": P((dm["H"],), "ones", dtype="float32"),
        "norm_w": P((dm["di"],), "ones"),
        "out_proj": P((dm["di"], d)),
    }


def param_specs(cfg: ModelConfig) -> Params:
    d, V = cfg.d_model, cfg.vocab_size
    specs: Params = {
        "embed": P((V, d), "embed", scale=0.02),
        "final_ln_w": P((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, V), "small", scale=0.02)

    if cfg.family in ("dense", "vlm"):
        if cfg.local_global:  # gemma2: (local, global) layer pairs
            npairs = cfg.num_layers // 2
            specs["local"] = {"attn": _stack(_attn_specs(cfg), npairs),
                              "mlp": _stack(_mlp_specs(cfg), npairs)}
            specs["global"] = {"attn": _stack(_attn_specs(cfg), npairs),
                               "mlp": _stack(_mlp_specs(cfg), npairs)}
        else:
            L = cfg.num_layers
            specs["blocks"] = {"attn": _stack(_attn_specs(cfg), L),
                               "mlp": _stack(_mlp_specs(cfg), L)}
    elif cfg.family == "moe":
        L = cfg.num_layers
        specs["blocks"] = {"attn": _stack(_attn_specs(cfg), L),
                           "moe": _stack(_moe_specs(cfg), L)}
        if cfg.d_ff > 0:  # shared dense expert (kimi-k2)
            specs["blocks"]["shared_mlp"] = _stack(
                _mlp_specs(cfg, cfg.d_ff), L)
    elif cfg.family == "encdec":
        L = cfg.num_layers
        specs["enc_blocks"] = {"attn": _stack(_attn_specs(cfg), L),
                               "mlp": _stack(_mlp_specs(cfg), L)}
        specs["dec_blocks"] = {"self_attn": _stack(_attn_specs(cfg), L),
                               "cross_attn": _stack(_attn_specs(cfg), L),
                               "mlp": _stack(_mlp_specs(cfg), L)}
        specs["enc_final_ln_w"] = P((d,), "ones")
    elif cfg.family == "ssm":
        specs["blocks"] = {"mamba": _stack(_mamba_specs(cfg),
                                           cfg.num_layers)}
    elif cfg.family == "hybrid":
        assert cfg.num_layers % cfg.attn_every == 0
        specs["blocks"] = {"mamba": _stack(_mamba_specs(cfg),
                                           cfg.num_layers)}
        specs["shared"] = {"attn": _attn_specs(cfg),
                           "mlp": _mlp_specs(cfg)}
    else:
        raise ValueError(cfg.family)
    return specs


def abstract(cfg: ModelConfig) -> Params:
    """Parameter tree of ``device="meta"`` tensors (no allocation)."""
    return abstract_params(param_specs(cfg), cfg.param_dtype)


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Initialized parameters on ``device``, drawn from ``generator``."""
    return init_params(param_specs(cfg), generator, cfg.param_dtype, device)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               abstract_only: bool = False, cross_len: int = 1500,
               device=None):
    """Dense KV/SSM cache tree for every family: zeros on ``device``, or
    ``device="meta"`` tensors with ``abstract_only`` (what the footprint
    estimator sizes)."""
    dt = torch_dtype(cfg.compute_dtype)
    dev = "meta" if abstract_only else device

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    hd, Hkv = cfg.head_dim, cfg.num_kv_heads
    cache: Dict[str, Any] = {"len": mk((), torch.int32)}
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.local_global:
            npairs = cfg.num_layers // 2
            for pre in ("local", "global"):
                cache[f"{pre}_k"] = mk((npairs, batch, max_len, Hkv, hd), dt)
                cache[f"{pre}_v"] = mk((npairs, batch, max_len, Hkv, hd), dt)
        else:
            L = cfg.num_layers
            cache["k"] = mk((L, batch, max_len, Hkv, hd), dt)
            cache["v"] = mk((L, batch, max_len, Hkv, hd), dt)
    elif cfg.family == "encdec":
        L = cfg.num_layers
        cache["k"] = mk((L, batch, max_len, Hkv, hd), dt)
        cache["v"] = mk((L, batch, max_len, Hkv, hd), dt)
        cache["cross_k"] = mk((L, batch, cross_len, Hkv, hd), dt)
        cache["cross_v"] = mk((L, batch, cross_len, Hkv, hd), dt)
    elif cfg.family == "ssm":
        dm = ssm_mod.mamba2_dims(cfg)
        L = cfg.num_layers
        cache["ssm"] = mk((L, batch, dm["H"], dm["P"], dm["N"]),
                          torch.float32)
        cache["conv"] = mk((L, batch, cfg.conv_width - 1, dm["conv_ch"]), dt)
    elif cfg.family == "hybrid":
        dm = ssm_mod.mamba2_dims(cfg)
        L, n_apps = cfg.num_layers, cfg.num_layers // cfg.attn_every
        cache["ssm"] = mk((L, batch, dm["H"], dm["P"], dm["N"]),
                          torch.float32)
        cache["conv"] = mk((L, batch, cfg.conv_width - 1, dm["conv_ch"]), dt)
        cache["k"] = mk((n_apps, batch, max_len, Hkv, hd), dt)
        cache["v"] = mk((n_apps, batch, max_len, Hkv, hd), dt)
    return cache


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(
            "paged serving of the moe family comes with slice 2 of the "
            "PyTorch port (MoE blocks)")
    if cfg.family not in ("dense", "vlm") or cfg.local_global:
        raise NotImplementedError(
            f"paged KV cache supports dense-stack families, got "
            f"{cfg.family} (local_global={cfg.local_global})")


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, abstract_only: bool = False,
                     device=None):
    """Page-pool KV cache: a shared pool of fixed-size token pages plus a
    per-request page table and length.  Page 0 is the scratch page —
    unused table slots (and padding rows) point at it, so every gather
    hits a valid page and garbage writes land harmlessly.

    Layout: {"lens": [B], "table": [B, maxp], "k"/"v": [L, P, page, Hkv,
    hd]} where maxp = num_pages - 1 upper-bounds any one request.
    """
    _check_paged(cfg)
    dt = torch_dtype(cfg.compute_dtype)
    dev = "meta" if abstract_only else device
    L, hd, Hkv = cfg.num_layers, cfg.head_dim, cfg.num_kv_heads
    maxp = max(num_pages - 1, 1)
    return {
        "lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "table": torch.zeros((batch, maxp), dtype=torch.int32, device=dev),
        "k": torch.zeros((L, num_pages, page_size, Hkv, hd), dtype=dt,
                         device=dev),
        "v": torch.zeros((L, num_pages, page_size, Hkv, hd), dtype=dt,
                         device=dev),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    x = params["embed"][tokens]  # gather [B,S,d]
    if getattr(cfg, "embed_scale", False) or cfg.local_global:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(params, cfg, h):
    """Final norm + LM head (+ gemma2 final softcap). h: [..., d].
    Logits are fp32: the products of the weights' dtype, summed in fp32."""
    h = rms_norm(h, params["final_ln_w"], cfg.norm_eps)
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = h.float() @ w.float()
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _qk_normed(p, cfg, q, k):
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def _attn_scale(cfg) -> float:
    dim = getattr(cfg, "attn_scale_dim", 0) or cfg.head_dim
    return float(dim) ** -0.5


def mlp_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln_w"], cfg.norm_eps)
    out = mlp(h, p["wi_gate"], p["wi_up"], p["wo"], cfg.act)
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_ln_w"], cfg.norm_eps)
    return x + out


# ---------------------------------------------------------------------------
# Paged serving
# ---------------------------------------------------------------------------

def _paged_kv_write(pool, new, table, positions, page_size):
    """Scatter per-token k/v into the page pool, IN PLACE.

    pool: [P, page, Hkv, hd]; new: [B, S, Hkv, hd]; positions: [B, S]
    absolute token positions; table: [B, maxp].  Rows whose position
    maps to the scratch page (id 0) overwrite garbage only, and so do
    positions past the table's last slot (the JAX version drops those
    writes).  Unlike the JAX version, which returns an updated copy, this
    writes into ``pool`` (a view of the stacked cache) and returns it.
    """
    slot = (positions // page_size).long()
    inside = slot < table.shape[1]
    pids = torch.where(inside, torch.gather(
        table, 1, torch.clamp(slot, max=table.shape[1] - 1)), 0)
    offs = positions % page_size
    pool[pids.long(), offs.long()] = new.to(pool.dtype)
    return pool


def _paged_attn_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      pools, table, write_table, positions, kv_lens, *,
                      chunk_attend: bool):
    """Pre-norm attention with residual over the page pool.

    x: [B, S, d]; positions: [B, S] absolute positions of these tokens;
    kv_lens: [B] total valid tokens after this write.  KV writes route
    through ``write_table`` (inactive rows' tables are zeroed there, so
    their writes land on the scratch page); gathers use the real
    ``table``.  With ``chunk_attend`` the S chunk tokens attend causally
    through the gathered pages (prefill chunks); otherwise S == 1 decode.
    """
    from repro_torch.kernels.paged_attention.ref import gather_pages
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["ln_w"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (h @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (h @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    q, k = _qk_normed(p, cfg, q, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    page = pools[0].shape[1]
    kp = _paged_kv_write(pools[0], k, write_table, positions, page)
    vp = _paged_kv_write(pools[1], v, write_table, positions, page)
    if chunk_attend:
        kd = gather_pages(kp, table)           # [B, maxp*page, Hkv, hd]
        vd = gather_pages(vp, table)
        out = attention(
            q, kd, vd, causal=True, q_positions=positions,
            k_positions=torch.arange(kd.shape[1], device=x.device),
            kv_len=kv_lens, attn_softcap=cfg.attn_softcap,
            scale=_attn_scale(cfg), f32_logits=cfg.attn_f32_logits)
    else:
        out = paged_decode_attention(
            q, kp, vp, table, kv_lens,
            attn_softcap=cfg.attn_softcap, scale=_attn_scale(cfg),
            f32_logits=cfg.attn_f32_logits)
    out = out.reshape(B, S, cfg.num_heads * hd) @ p["wo"]
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_ln_w"], cfg.norm_eps)
    return x + out


def _layer(tree, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` param tree (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _paged_stack(params, cfg, x, cache, positions, kv_lens, active, *,
                 chunk_attend: bool):
    """Dense/vlm stack over the page pool, one layer at a time; layer
    ``l`` reads and writes the pools ``cache["k"][l]`` / ``[l]``."""
    _check_paged(cfg)
    table = cache["table"]
    if active is None:
        write_table = table
    else:
        write_table = torch.where(
            torch.as_tensor(active, dtype=torch.bool,
                            device=table.device)[:, None],
            table, torch.zeros((), dtype=table.dtype, device=table.device))
    for i in range(cfg.num_layers):
        pb = _layer(params["blocks"], i)
        pools = (cache["k"][i], cache["v"][i])
        x = _paged_attn_block(pb["attn"], cfg, x, pools, table, write_table,
                              positions, kv_lens, chunk_attend=chunk_attend)
        x = mlp_block(pb["mlp"], cfg, x)
    return x, {"k": cache["k"], "v": cache["v"], "table": table}


def decode_step_paged(params: Params, cfg: ModelConfig, cache,
                      token: torch.Tensor, active=None):
    """One-token decode over the paged cache; every row is at its own
    position ``lens[b]``.  token: [B, 1] int; active: optional [B]
    bool — inactive rows (mid-prefill / padding) write to the scratch
    page, keep their length, and produce garbage logits callers must
    not read.  Returns (logits [B, 1, V] fp32, updated cache); the pools
    of ``cache`` are updated in place."""
    x = _embed(params, cfg, token)
    lens = cache["lens"]
    positions = lens[:, None]                   # [B, 1]
    h, nc = _paged_stack(params, cfg, x, cache, positions, lens + 1,
                         active, chunk_attend=False)
    nl = lens + 1
    if active is not None:
        nl = torch.where(torch.as_tensor(active, dtype=torch.bool,
                                         device=lens.device), nl, lens)
    nc["lens"] = nl
    return _unembed(params, cfg, h), nc


def prefill_chunk(params: Params, cfg: ModelConfig, cache,
                  tokens: torch.Tensor, start: torch.Tensor,
                  chunk_lens: torch.Tensor, active=None):
    """Process one prompt chunk per row, writing KV into the rows' pages.

    tokens: [B, C] int (PAD-filled past each row's chunk); start: [B]
    int32 absolute position of each row's first chunk token;
    chunk_lens: [B] int32 valid tokens this chunk (<= C; short final
    chunks PAD-fill the tail — those writes land beyond the row's
    length inside its own pages, masked now and overwritten by the next
    chunk or decode); active: optional [B] bool — inactive rows
    (decoding / idle) write to the scratch page and keep their length.
    Returns (logits at each row's last valid chunk token [B, 1, V],
    cache with lens = start + chunk_lens for active rows); the pools of
    ``cache`` are updated in place.
    """
    x = _embed(params, cfg, tokens)
    B, C = tokens.shape
    dev = x.device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int32, device=dev)
    positions = start[:, None] + torch.arange(C, dtype=torch.int32,
                                              device=dev)[None, :]
    h, nc = _paged_stack(params, cfg, x, cache, positions,
                         start + chunk_lens, active, chunk_attend=True)
    nl = start + chunk_lens
    if active is not None:
        nl = torch.where(torch.as_tensor(active, dtype=torch.bool,
                                         device=dev), nl, cache["lens"])
    nc["lens"] = nl
    last = h[torch.arange(B, device=dev),
             torch.clamp(chunk_lens - 1, min=0).long()][:, None]
    return _unembed(params, cfg, last), nc
