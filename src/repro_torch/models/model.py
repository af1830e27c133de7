"""Model assembly: parameter specs for every family, and the serving and
training forward passes.

Mirrors the JAX package's ``models/model.py``.  ``param_specs``,
``abstract`` and ``init_cache(abstract_only=True)`` cover every family
(dense / moe / encdec / vlm / ssm / hybrid), so the footprint estimator
sees the same byte counts.  The forward passes are the ones serving
runs: the paged pair (``prefill_chunk`` / ``decode_step_paged``) for the
dense (but gemma2's local/global layers), moe and vlm families, as in the
JAX package, which refuses the others there; the dense-cache pair
(``prefill`` / ``decode_step``) for every family; and ``forward_train``
for every family.  Under ``moe_ep.ep_mesh_context`` the MoE layers take
the expert-parallel path (``models/moe_ep.py``), as in the JAX package.
Under ``tp.tp_mesh_context`` the attention, MLP and Mamba2 blocks and
the vocabulary compute on this rank's shards over 'model' wherever they
are given shards (``models/tp.py``); the norms and the router always
compute whole.

The train mode (``forward_train``) keeps no cache and writes no state.
Its attention and SSD scan take their plain versions on any device (the
JAX package trains with ``use_pallas=False``; the port's attention and
scan kernels have no backward), while every norm runs its CUDA kernel on
the card, forward and backward (``kernels/rmsnorm/ops.py``).  Each layer
runs under ``cfg.remat`` (``_maybe_remat``).

Design rules:
  * Plain functions over a nested dict of tensors, stacked ``[L, ...]``
    per layer; a Python loop over layers replaces ``lax.scan``.
  * Same spec tree drives abstract (``device="meta"``) and concrete init.
  * Weights keep the JAX layouts (``wq`` is ``[d, Hq*hd]``; ``x @ W``).
  * The KV caches are updated in place (``_paged_kv_write``, and the
    dense write in ``attn_block``), and so are the SSM and conv states
    (``_mamba_layer``): a step consumes the cache it is given, like a
    donated JAX buffer.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention, decode_attention,
                                          paged_decode_attention,
                                          paged_prefill_attention)
from repro_torch.models.layers import (add_rms_norm, mlp, qk_norm_rope,
                                       rms_norm, softcap)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.moe_ep import (current_ep_mesh, ep_mesh_context,
                                       moe_ffn_ep)
from repro_torch.models.tp import (copy_to, current_tp, gather_heads,
                                   kv_layout, local_kv_heads,
                                   merge_partials, reduce_from, seq_range,
                                   split, tp_mesh_context, vocab_embed)
from repro_torch.models.params import (P, abstract_params, init_params,
                                       torch_dtype)
from repro_torch.obs.spans import spanned

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
               device=None, ssm_heads: Optional[int] = None):
    """Dense KV/SSM cache tree for every family: zeros on ``device``, or
    ``device="meta"`` tensors with ``abstract_only`` (what the footprint
    estimator sizes).  Under the tensor-parallel context each KV leaf
    holds this rank's share as ``tp.kv_layout`` lays it: its Hkv/M heads
    (``[L, batch, max_len, Hkv/M, hd]``), its range of ``max_len / M``
    slots of every head, or the whole leaf.  ``batch`` is the rank's own
    rows; ``ssm_heads`` the Mamba2 heads the rank computes (default all):
    the SSM state holds those and the conv state their channels ``[x_r |
    B | C]``."""
    dt = torch_dtype(cfg.compute_dtype)
    dev = "meta" if abstract_only else device

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    hd, Hkv = cfg.head_dim, cfg.num_kv_heads

    def kv(kind, n, slots):
        lay = kv_layout(kind)
        M = current_tp().size if lay else 1
        return mk((n, batch, slots // M if lay == "sequence" else slots,
                   Hkv // M if lay == "heads" else Hkv, hd), dt)
    cache: Dict[str, Any] = {"len": mk((), torch.int32)}
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.local_global:
            npairs = cfg.num_layers // 2
            for pre in ("local", "global"):
                cache[f"{pre}_k"] = kv("self", npairs, max_len)
                cache[f"{pre}_v"] = kv("self", npairs, max_len)
        else:
            L = cfg.num_layers
            cache["k"] = kv("self", L, max_len)
            cache["v"] = kv("self", L, max_len)
    elif cfg.family == "encdec":
        L = cfg.num_layers
        cache["k"] = kv("self", L, max_len)
        cache["v"] = kv("self", L, max_len)
        cache["cross_k"] = kv("cross", L, cross_len)
        cache["cross_v"] = kv("cross", L, cross_len)
    elif cfg.family == "ssm":
        dm = ssm_mod.mamba2_dims(cfg, ssm_heads)
        L = cfg.num_layers
        cache["ssm"] = mk((L, batch, dm["H"], dm["P"], dm["N"]),
                          torch.float32)
        cache["conv"] = mk((L, batch, cfg.conv_width - 1, dm["conv_ch"]), dt)
    elif cfg.family == "hybrid":
        dm = ssm_mod.mamba2_dims(cfg, ssm_heads)
        L, n_apps = cfg.num_layers, cfg.num_layers // cfg.attn_every
        cache["ssm"] = mk((L, batch, dm["H"], dm["P"], dm["N"]),
                          torch.float32)
        cache["conv"] = mk((L, batch, cfg.conv_width - 1, dm["conv_ch"]), dt)
        cache["k"] = kv("self", n_apps, max_len)
        cache["v"] = kv("self", n_apps, max_len)
    return cache


def _check_paged(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm") or cfg.local_global:
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
    # gather [B,S,d]; vocab-parallel where the embedding is a shard
    x = vocab_embed(params["embed"], tokens, cfg.vocab_size)
    if getattr(cfg, "embed_scale", False) or cfg.local_global:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


@spanned("model.unembed")
def _unembed(params, cfg, h, delta=None):
    """Final norm + LM head (+ gemma2 final softcap). h: [..., d], and the
    last block's pending output ``delta`` (added in the final norm's
    launch).  Logits are fp32: the products of the weights' dtype, summed
    in fp32; under the tensor-parallel context, of this rank's vocabulary
    columns where the weight is a shard."""
    h, _ = add_rms_norm(h, delta, params["final_ln_w"], cfg.norm_eps)
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    if split(w.shape[-1], cfg.vocab_size):
        h = copy_to(h)
    logits = h.float() @ w.float()
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _qk_normed(p, cfg, q, k):
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def _qk_rope(p, cfg, q, k, positions):
    """The qk-norm (if the config has one) and RoPE of q and k: one launch
    on the card."""
    wq, wk = ((p["q_norm"], p["k_norm"]) if cfg.use_qk_norm
              else (None, None))
    return qk_norm_rope(q, k, wq, wk, positions, cfg.rope_theta,
                        cfg.norm_eps)


def _attn_scale(cfg) -> float:
    dim = getattr(cfg, "attn_scale_dim", 0) or cfg.head_dim
    return float(dim) ** -0.5


def _decode_write(ck, cv, k, v, posv, seq: bool) -> None:
    """Write the token's ``k``/``v`` ``[B, 1, H, hd]`` into the cache
    slice IN PLACE at the position ``posv`` ``[1]`` clamped onto the last
    slot (as ``jax.lax.dynamic_update_slice`` clamps its start), on the
    device.  ``seq``: the slice is this rank's range of a cache split over
    the sequence, and only the rank that owns the slot changes it (the
    others write back what the slot holds)."""
    Sl = ck.shape[1]
    if not seq:
        slot = torch.clamp(posv, max=Sl - 1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        return
    tp = current_tp()
    local = torch.clamp(posv, max=Sl * tp.size - 1) - tp.rank * Sl
    owned = ((local >= 0) & (local < Sl)).reshape(1, 1, 1, 1)
    slot = torch.clamp(local, 0, Sl - 1).long()
    for c, new in ((ck, k), (cv, v)):
        c.index_copy_(1, slot, torch.where(owned, new.to(c.dtype),
                                           c.index_select(1, slot)))


def _seq_split_decode(q, ck, cv, pos, cfg, window: int):
    """One-token attention of this rank's q heads ``[B, 1, Hq/M, hd]``
    (or every head, where ``wq`` is whole) over a cache split over the
    sequence, of which ``ck``/``cv`` are this rank's range: every q head
    gathered over 'model', the decode kernel (plain on the CPU) over the
    range's attended slots with its log-sum-exp, the ranks' partials
    merged (``tp.merge_partials``)."""
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention as decode_range
    tp = current_tp()
    heads_split = q.shape[2] != cfg.num_heads
    qa = gather_heads(q) if heads_split else q
    o, lse = decode_range(
        qa, ck, cv, pos, window=window, attn_softcap=cfg.attn_softcap,
        scale=_attn_scale(cfg), slot_offset=tp.rank * ck.shape[1],
        return_lse=True)
    return merge_partials(o, lse, heads_split)


@spanned("model.attn")
def attn_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
               delta: Optional[torch.Tensor] = None, *,
               mode: str,                    # train | prefill | decode
               causal: bool = True,
               window: int = 0,
               layer_kv=None,
               pos: Optional[torch.Tensor] = None,
               cross_kv=None,
               cross_split: bool = False,
               rope: bool = True):
    """Pre-norm attention.  ``delta`` is the previous block's pending
    output, added to x in the pre-norm's launch.  Returns (x + delta, the
    block's output, still to be added to the residual, new_kv | None).

    * train:   full self-attention by the plain (differentiable) path on
               any device, new_kv=None
    * prefill: full self-attention, returns (k, v) [B,S,Hkv,hd]
    * decode:  layer_kv is the full cache slice; the new token's k/v is
               written at index ``pos`` IN PLACE (the JAX version returns
               an updated copy); returns the same cache slice.
    * cross_kv set -> cross-attention (no rope, non-causal, ignores cache).

    ``pos`` is the cache's 0-dim position tensor and stays on its device
    (no read-back).  A position past the cache's last slot writes onto
    slot S - 1, as ``jax.lax.dynamic_update_slice`` clamps its start (the
    vlm's cache ``len`` counts its patch embeddings, so the backend's
    shared position lags it and the last decode steps land there); the
    attention then sees every slot valid and measures a window from the
    unclamped position, as the JAX package's plain path does.

    Given this rank's q heads under the tensor-parallel context
    (``models/tp.py``), the block computes them and their kv heads (every
    kv head where ``wk``/``wv`` are whole, of which the attention reads
    the ones its q heads read: ``local_kv_heads``), and sums ``wo``'s
    partial products over 'model' before the post-norm.  The cache slice
    it is given says how the cache lies over 'model' (``tp.kv_layout``):
    this rank's kv heads, which it writes and reads; every kv head of the
    whole cache, which every rank writes and reads its heads of; or every
    kv head of this rank's slot range of a cache split over the sequence:
    the token's k/v are written only by the rank that owns its slot, and
    the attention gathers the q heads, attends every head over the
    rank's slots and merges the ranks' partials (``_seq_split_decode``).
    A prefill returns every kv head it computed, and ``prefill`` keeps
    the rank's share of them.  ``cross_split``: ``cross_kv`` is the
    rank's slot range of a cross-attention cache split over the sequence
    (a decode step), merged in the same way.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    h, x = add_rms_norm(x, delta, p["ln_w"], cfg.norm_eps)
    Hq = p["wq"].shape[-1] // hd
    tp = split(Hq, cfg.num_heads)
    if tp:
        h = copy_to(h)
    q = (h @ p["wq"]).reshape(B, S, Hq, hd)

    new_kv = None
    if cross_kv is not None:
        k, v = cross_kv
        if cross_split:
            # every slot valid: the query at the whole cache's last one
            q, k = _qk_normed(p, cfg, q, k)
            out = _seq_split_decode(q, k, v, k.shape[1] * current_tp().size
                                    - 1, cfg, 0)
        else:
            if tp and k.shape[2] == cfg.num_kv_heads:
                k, v = local_kv_heads(k, v, cfg.num_heads)
            q, k = _qk_normed(p, cfg, q, k)
            out = attention(q, k, v, causal=False, scale=_attn_scale(cfg),
                            attn_softcap=cfg.attn_softcap,
                            use_pallas=cfg.use_pallas,
                            f32_logits=cfg.attn_f32_logits,
                            differentiable=mode == "train")
    else:
        k = (h @ p["wk"]).reshape(B, S, -1, hd)
        v = (h @ p["wv"]).reshape(B, S, -1, hd)
        # every kv head (from a gathered wk/wv) while this rank computes
        # only its q heads: the attention reads the kv heads they read,
        # the cache keeps every head
        every = tp and k.shape[2] == cfg.num_kv_heads
        if not rope:
            q, k = _qk_normed(p, cfg, q, k)
        if mode == "decode":
            assert layer_kv is not None and pos is not None and S == 1
            posv = torch.as_tensor(pos, dtype=torch.int32,
                                   device=x.device).reshape(1)
            if rope:
                q, k = _qk_rope(p, cfg, q, k, posv)
            ck, cv = layer_kv
            seq = kv_layout("self") == "sequence"
            _decode_write(ck, cv, k, v, posv, seq)
            if seq:
                out = _seq_split_decode(q, ck, cv, pos, cfg, window)
            else:
                ka, va = ck, cv
                if every:
                    # a whole cache (M divides neither Hkv nor S): a copy
                    # of this rank's heads, which the kernel reads
                    # contiguous
                    ka, va = (t.contiguous() for t in local_kv_heads(
                        ck, cv, cfg.num_heads))
                out = decode_attention(
                    q, ka, va, pos, window=window,
                    attn_softcap=cfg.attn_softcap, scale=_attn_scale(cfg),
                    use_pallas=cfg.use_pallas,
                    f32_logits=cfg.attn_f32_logits)
            new_kv = (ck, cv)
        else:
            if rope:
                q, k = _qk_rope(p, cfg, q, k,
                                torch.arange(S, device=x.device))
            ka, va = (local_kv_heads(k, v, cfg.num_heads) if every
                      else (k, v))
            out = attention(q, ka, va, causal=causal, window=window,
                            attn_softcap=cfg.attn_softcap,
                            scale=_attn_scale(cfg),
                            use_pallas=cfg.use_pallas,
                            f32_logits=cfg.attn_f32_logits,
                            differentiable=mode == "train")
            if mode == "prefill":
                new_kv = (k, v)

    out = out.reshape(B, S, Hq * hd) @ p["wo"]
    if tp:
        out = reduce_from(out)
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_ln_w"], cfg.norm_eps)
    return x, out, new_kv


def _mlp(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The gated MLP of ``p`` on the normed ``h``: column- and row-parallel
    where it is given this rank's columns of ``wi_*`` and rows of ``wo``
    under the tensor-parallel context."""
    tp = split(p["wi_gate"].shape[-1], cfg.d_ff)
    out = mlp(copy_to(h) if tp else h, p["wi_gate"], p["wi_up"], p["wo"],
              cfg.act)
    return reduce_from(out) if tp else out


@spanned("model.mlp")
def mlp_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              delta: Optional[torch.Tensor] = None):
    """Pre-norm gated MLP: -> (x + delta, the block's pending output)."""
    h, x = add_rms_norm(x, delta, p["ln_w"], cfg.norm_eps)
    out = _mlp(p, cfg, h)
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_ln_w"], cfg.norm_eps)
    return x, out


@spanned("model.moe")
def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              shared_mlp: Optional[Params] = None,
              delta: Optional[torch.Tensor] = None, *,
              with_aux: bool = False):
    """Pre-norm MoE FFN (plus a shared dense expert, if given), its
    pre-norm adding the pending ``delta`` to x.  Returns (x + delta, the
    block's pending output, aux_loss), the loss None unless ``with_aux``
    (serving never reads it).  Under ``ep_mesh_context`` the expert-
    parallel ``moe_ffn_ep`` runs, on this rank's tokens and expert
    shards, as in the JAX version."""
    B, S, d = x.shape
    h, x = add_rms_norm(x, delta, p["ln_w"], cfg.norm_eps)
    impl = moe_ffn_ep if current_ep_mesh() is not None else moe_ffn
    out = impl(h.reshape(B * S, d), p["w_router"], p["w_gate"],
               p["w_up"], p["w_down"], k=cfg.experts_per_token,
               capacity_factor=cfg.capacity_factor, act=cfg.act,
               with_aux=with_aux)
    y = out.y.reshape(B, S, d)
    if shared_mlp is not None:
        hs = rms_norm(x, shared_mlp["ln_w"], cfg.norm_eps)
        y = y + _mlp(shared_mlp, cfg, hs)
    return x, y, out.aux_loss


def _ffn_block(pb: Params, cfg: ModelConfig, x: torch.Tensor, delta, *,
               with_aux: bool = False):
    """Layer ``pb``'s FFN: the MoE block (and its shared expert) for the
    moe family, else the dense MLP block.  Returns (x + delta, the
    block's pending output, aux_loss or None)."""
    if "moe" in pb:
        return moe_block(pb["moe"], cfg, x, pb.get("shared_mlp"), delta,
                         with_aux=with_aux)
    return (*mlp_block(pb["mlp"], cfg, x, delta), None)


def mamba_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[ssm_mod.SSMState] = None,
                delta: Optional[torch.Tensor] = None, *,
                decode: bool = False, train: bool = False):
    """Pre-norm Mamba2 block: -> (x + delta, the block's pending output,
    new state).  ``train``: no state in or out, the plain scan."""
    h, x = add_rms_norm(x, delta, p["ln_w"], cfg.norm_eps)
    y, new_state = ssm_mod.mamba2_block(p, cfg, h, state, decode=decode,
                                        differentiable=train)
    return x, y, new_state


# ---------------------------------------------------------------------------
# The train mode: one layer at a time, each under cfg.remat
# ---------------------------------------------------------------------------

#: what ``remat="dots"`` keeps from a layer's forward: the outputs of its
#: matrix products (the JAX package's ``dots_saveable``)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _dots_context():
    return create_selective_checkpoint_contexts(_DOTS)


def _maybe_remat(fn, cfg, mode):
    """``fn`` (one layer) as the train mode runs it.  ``cfg.remat``:
    "none" runs it as is and keeps what autograd saves; "full" keeps only
    its inputs and runs it again in the backward
    (``torch.utils.checkpoint``); "dots" runs it again too but keeps the
    outputs of its matrix products.  Other modes run ``fn`` as is.  The
    layer's boundary carries the (x, pending delta) pair; a checkpointed
    layer runs its forward kernels twice (forward, then the recompute)."""
    if mode != "train" or cfg.remat == "none":
        return fn
    extra = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def run(*args):
        # the recompute runs in the backward, on the card on autograd's
        # own thread, where the thread-local expert-parallel and tensor-
        # parallel meshes are not set: it re-enters the ones the forward
        # ran under
        ep, tp = current_ep_mesh(), current_tp()
        body = fn if ep is None and tp is None else _under(fn, ep, tp)
        return checkpoint(body, *args, use_reentrant=False, **extra)
    return run


def _under(fn, ep, tp):
    def body(*args):
        with (ep_mesh_context(*ep) if ep else nullcontext()), \
                (tp_mesh_context(tp.mesh, kv=tp.kv) if tp
                 else nullcontext()):
            return fn(*args)
    return body


def _dense_train_layer(pb, cfg, x, delta):
    """A dense/moe/vlm layer in train mode: -> (x, pending delta, the MoE
    aux loss or None)."""
    x, delta, _ = attn_block(pb["attn"], cfg, x, delta, mode="train")
    return _ffn_block(pb, cfg, x, delta, with_aux=True)


def _mamba_train_layer(p, cfg, x, delta):
    """A Mamba2 layer in train mode: -> (x, pending delta)."""
    x, y, _ = mamba_block(p, cfg, x, None, delta, train=True)
    return x, y


def _pair_layer(pl, pg, cfg, x, delta, mode, kvl=None, kvg=None,
                pos=None):
    """gemma2's (local, global) layer pair, the unit the JAX package's
    scan (and its remat) wraps, each layer an attention block (the local
    one within ``cfg.sliding_window`` keys) and an MLP block: -> (x,
    pending delta, the local and the global layer's new (k, v) or
    None)."""
    x, delta, nkvl = attn_block(pl["attn"], cfg, x, delta, mode=mode,
                                window=cfg.sliding_window, layer_kv=kvl,
                                pos=pos)
    x, delta = mlp_block(pl["mlp"], cfg, x, delta)
    x, delta, nkvg = attn_block(pg["attn"], cfg, x, delta, mode=mode,
                                layer_kv=kvg, pos=pos)
    x, delta = mlp_block(pg["mlp"], cfg, x, delta)
    return x, delta, nkvl, nkvg


def _enc_layer(pb, cfg, x, delta):
    """A whisper encoder layer: non-causal self-attention without RoPE
    (the plain path: the JAX package runs it in its train mode in every
    mode), then the MLP: -> (x, pending delta)."""
    x, delta, _ = attn_block(pb["attn"], cfg, x, delta, mode="train",
                             causal=False, rope=False)
    return mlp_block(pb["mlp"], cfg, x, delta)


def _dec_layer(pb, cfg, x, delta, cross_kv, mode, layer_kv=None, pos=None,
               cross_split=False):
    """A whisper decoder layer: causal self-attention with RoPE over the
    cache (``mode``), the cross-attention to the encoder's K/V (plain,
    non-causal; ``cross_split``: merged over the ranks' slot ranges), then
    the MLP: -> (x, pending delta, the self-attention's new (k, v) or
    None)."""
    x, delta, nkv = attn_block(pb["self_attn"], cfg, x, delta, mode=mode,
                               layer_kv=layer_kv, pos=pos)
    x, delta, _ = attn_block(pb["cross_attn"], cfg, x, delta, mode="train",
                             cross_kv=cross_kv, cross_split=cross_split,
                             rope=False)
    x, delta = mlp_block(pb["mlp"], cfg, x, delta)
    return x, delta, nkv


def _shared_train_block(shared, cfg, x, delta):
    """One application of zamba2's shared attention + MLP in train mode:
    -> (x, pending delta)."""
    x, delta, _ = attn_block(shared["attn"], cfg, x, delta, mode="train")
    return mlp_block(shared["mlp"], cfg, x, delta)


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


@spanned("model.attn")
def _paged_attn_block(p: Params, cfg: ModelConfig, x: torch.Tensor, delta,
                      pools, table, write_table, positions, kv_lens, *,
                      chunk_attend: bool):
    """Pre-norm attention over the page pool: -> (x + delta, the block's
    pending output), as ``attn_block``.

    x: [B, S, d]; positions: [B, S] absolute positions of these tokens;
    kv_lens: [B] total valid tokens after this write.  KV writes route
    through ``write_table`` (inactive rows' tables are zeroed there, so
    their writes land on the scratch page); gathers use the real
    ``table``.  With ``chunk_attend`` the S chunk tokens attend causally
    to their rows' pages (prefill chunks: ``positions[b]`` runs from
    ``positions[b, 0]`` in steps of one); otherwise S == 1 decode.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    h, x = add_rms_norm(x, delta, p["ln_w"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (h @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (h @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    q, k = _qk_rope(p, cfg, q, k, positions)
    page = pools[0].shape[1]
    kp = _paged_kv_write(pools[0], k, write_table, positions, page)
    vp = _paged_kv_write(pools[1], v, write_table, positions, page)
    if chunk_attend:
        out = paged_prefill_attention(
            q, kp, vp, table, positions[:, 0], kv_lens,
            attn_softcap=cfg.attn_softcap, scale=_attn_scale(cfg),
            f32_logits=cfg.attn_f32_logits)
    else:
        out = paged_decode_attention(
            q, kp, vp, table, kv_lens,
            attn_softcap=cfg.attn_softcap, scale=_attn_scale(cfg),
            f32_logits=cfg.attn_f32_logits)
    out = out.reshape(B, S, cfg.num_heads * hd) @ p["wo"]
    if cfg.use_post_norm:
        out = rms_norm(out, p["post_ln_w"], cfg.norm_eps)
    return x, out


def _layers(tree) -> list:
    """The layers of a stacked ``[L, ...]`` param tree, one dict of views
    each, from one ``torch.unbind`` per leaf: autograd stacks the layers'
    gradients into the leaf's once, where indexing layer by layer would
    build a full-size gradient for every layer (L^2 traffic)."""
    cols = {k: (_layers(v) if isinstance(v, dict) else torch.unbind(v))
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _paged_stack(params, cfg, x, cache, positions, kv_lens, active, *,
                 chunk_attend: bool):
    """Dense/moe/vlm stack over the page pool, one layer at a time; layer
    ``l`` reads and writes the pools ``cache["k"][l]`` / ``[l]``.  Each
    block's output stays pending until the next norm adds it (in the same
    launch on the card); returns (h, the last block's pending output,
    cache)."""
    _check_paged(cfg)
    table = cache["table"]
    if active is None:
        write_table = table
    else:
        write_table = torch.where(
            torch.as_tensor(active, dtype=torch.bool,
                            device=table.device)[:, None],
            table, torch.zeros((), dtype=table.dtype, device=table.device))
    d = None
    for i, pb in enumerate(_layers(params["blocks"])):
        pools = (cache["k"][i], cache["v"][i])
        x, d = _paged_attn_block(pb["attn"], cfg, x, d, pools, table,
                                 write_table, positions, kv_lens,
                                 chunk_attend=chunk_attend)
        x, d, _ = _ffn_block(pb, cfg, x, d)
    return x, d, {"k": cache["k"], "v": cache["v"], "table": table}


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
    h, d, nc = _paged_stack(params, cfg, x, cache, positions, lens + 1,
                            active, chunk_attend=False)
    nl = lens + 1
    if active is not None:
        nl = torch.where(torch.as_tensor(active, dtype=torch.bool,
                                         device=lens.device), nl, lens)
    nc["lens"] = nl
    return _unembed(params, cfg, h, d), nc


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
    h, d, nc = _paged_stack(params, cfg, x, cache, positions,
                            start + chunk_lens, active, chunk_attend=True)
    nl = start + chunk_lens
    if active is not None:
        nl = torch.where(torch.as_tensor(active, dtype=torch.bool,
                                         device=dev), nl, cache["lens"])
    nc["lens"] = nl
    last = (torch.arange(B, device=dev),
            torch.clamp(chunk_lens - 1, min=0).long())
    return _unembed(params, cfg, h[last][:, None], d[last][:, None]), nc


# ---------------------------------------------------------------------------
# Dense-cache serving
# ---------------------------------------------------------------------------

def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor):
    return _unembed(params, cfg, hidden)


def _dense_stack(params, cfg, x, mode, cache=None):
    """Dense / moe / vlm decoder stack, one layer at a time (gemma2's
    goes to ``_local_global_stack``). Returns (h,
    the last block's pending output (see ``_paged_stack``), new_cache_kv,
    aux).  Decode writes layer ``l``'s token into
    ``cache["k"][l]`` / ``["v"][l]`` in place; prefill stacks the
    layers' (k, v) into ``[L, B, S, Hkv, hd]``.  ``aux`` sums the MoE
    load-balancing loss in train mode and stays zero in the serving
    modes, which never read it."""
    if cfg.local_global:
        return _local_global_stack(params, cfg, x, mode, cache)
    pos = None if cache is None else cache["len"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    d = None
    for i, pb in enumerate(_layers(params["blocks"])):
        if mode == "train":
            x, d, a = _maybe_remat(_dense_train_layer, cfg, mode)(pb, cfg, x,
                                                                  d)
            if a is not None:
                aux = aux + a
            continue
        kv = (cache["k"][i], cache["v"][i]) if cache else None
        x, d, nkv = attn_block(pb["attn"], cfg, x, d, mode=mode, layer_kv=kv,
                               pos=pos)
        x, d, _ = _ffn_block(pb, cfg, x, d)
        if mode == "prefill":
            ks.append(nkv[0])
            vs.append(nkv[1])
    if mode == "train":
        return x, d, None, aux
    if mode == "prefill":
        return x, d, {"k": torch.stack(ks), "v": torch.stack(vs)}, aux
    return x, d, {"k": cache["k"], "v": cache["v"]}, aux


def _local_global_stack(params, cfg, x, mode, cache=None):
    """gemma2: ``num_layers // 2`` (local, global) layer pairs
    (``_pair_layer``).  Caches ``local_k/v`` and ``global_k/v``
    ``[L/2, B, S, Hkv, hd]``: decode writes in place, prefill stacks the
    pairs' (k, v); the train mode keeps none, each pair under
    ``cfg.remat``.  Returns (h, the last block's pending output, new cache
    kv, aux)."""
    pos = None if cache is None else cache["len"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = {key: [] for key in ("local_k", "local_v", "global_k",
                               "global_v")}
    d = None
    for i, (pl, pg) in enumerate(zip(_layers(params["local"]),
                                     _layers(params["global"]))):
        kvl, kvg = ((cache["local_k"][i], cache["local_v"][i]),
                    (cache["global_k"][i], cache["global_v"][i])) \
            if cache else (None, None)
        x, d, nkvl, nkvg = _maybe_remat(_pair_layer, cfg, mode)(
            pl, pg, cfg, x, d, mode, kvl, kvg, pos)
        if mode == "prefill":
            for pre, (k, v) in (("local", nkvl), ("global", nkvg)):
                new[f"{pre}_k"].append(k)
                new[f"{pre}_v"].append(v)
    if mode == "train":
        return x, d, None, aux
    if mode == "prefill":
        return x, d, {k: torch.stack(v) for k, v in new.items()}, aux
    return x, d, {k: cache[k] for k in new}, aux


def _encdec_stacks(params, cfg, enc_x, dec_x, mode, cache=None):
    """Whisper backbone.  enc_x: [B, S_enc, d] frame embeddings (the
    frontend is a stub), or None in decode, which reads the cross K/V
    from the cache; dec_x: [B, S_dec, d] decoder token embeddings.  The
    encoder (its layers under ``cfg.remat`` in train mode only), its
    final norm and each decoder layer's cross K/V from the encoder's
    output; then the decoder over the self-attention cache ``k``/``v``
    ``[L, B, S, Hkv, hd]`` (in place in decode), its cross-attention to
    ``cross_k``/``cross_v`` ``[L, B, S_enc, Hkv, hd]``.  Returns (h, the
    last block's pending output, new cache, aux)."""
    pos = None if cache is None else cache["len"]
    dec = _layers(params["dec_blocks"])
    if enc_x is not None:
        d = None
        for pb in _layers(params["enc_blocks"]):
            enc_x, d = _maybe_remat(_enc_layer, cfg, mode)(pb, cfg, enc_x, d)
        enc_h, _ = add_rms_norm(enc_x, d, params["enc_final_ln_w"],
                                cfg.norm_eps)
        B, S = enc_h.shape[:2]
        # this rank's heads (or every head, where wk/wv are whole) under
        # the tensor-parallel context, the encoder output's gradient then
        # summed over 'model' once for every layer
        if split(dec[0]["cross_attn"]["wq"].shape[-1],
                 cfg.num_heads * cfg.head_dim):
            enc_h = copy_to(enc_h)
        shape = (B, S, -1, cfg.head_dim)
        cross_k = [(enc_h @ pb["cross_attn"]["wk"]).reshape(shape)
                   for pb in dec]
        cross_v = [(enc_h @ pb["cross_attn"]["wv"]).reshape(shape)
                   for pb in dec]
    else:
        cross_k, cross_v = cache["cross_k"], cache["cross_v"]
    # a decode step reads the cross K/V from the cache, which may be this
    # rank's range of a cache split over the sequence
    cross_split = enc_x is None and kv_layout("cross") == "sequence"
    x, d = dec_x, None
    ks, vs = [], []
    for i, pb in enumerate(dec):
        kv = (cache["k"][i], cache["v"][i]) if cache else None
        x, d, nkv = _maybe_remat(_dec_layer, cfg, mode)(
            pb, cfg, x, d, (cross_k[i], cross_v[i]), mode, kv, pos,
            cross_split)
        if mode == "prefill":
            ks.append(nkv[0])
            vs.append(nkv[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, d, None, aux
    if mode == "prefill":
        return x, d, {"k": torch.stack(ks), "v": torch.stack(vs),
                      "cross_k": torch.stack(cross_k),
                      "cross_v": torch.stack(cross_v)}, aux
    return x, d, {"k": cache["k"], "v": cache["v"], "cross_k": cross_k,
                  "cross_v": cross_v}, aux


def _mamba_layer(p: Params, cfg: ModelConfig, x: torch.Tensor, delta, cache,
                 layer: int, decode: bool):
    """Mamba2 layer ``layer`` over the cache, its pre-norm adding the
    pending ``delta``: -> (x + delta, the block's pending output).  It
    starts from
    ``cache["ssm"][layer]`` / ``cache["conv"][layer]`` and writes its new
    states there IN PLACE (the JAX version returns updated copies from
    donated buffers).  A prefill starts from the fresh cache's zero state,
    so its scan is given no initial state and reads no zeros.  A prompt
    shorter than the conv window fills only the window's last slots; the
    rest keep the zeros of the fresh cache, the causal conv's own padding
    (the JAX version returns a shorter conv state there, which its decode
    step cannot take)."""
    ssm, conv = cache["ssm"][layer], cache["conv"][layer]
    state = ssm_mod.SSMState(ssm=ssm if decode else None, conv=conv)
    x, y, ns = mamba_block(p, cfg, x, state, delta, decode=decode)
    ssm.copy_(ns.ssm)
    conv[:, conv.shape[1] - ns.conv.shape[1]:].copy_(ns.conv)
    return x, y


def _ssm_stack(params, cfg, x, mode, cache=None):
    """Pure-mamba stack over the cache {"ssm": [L,B,H,P,N], "conv":
    [L,B,W-1,ch]}, one layer at a time (prefill starts from a zero
    cache, as in the JAX package); the states are updated in place.  The
    train mode takes no cache and writes no state (new cache None).
    Returns (h, the last block's pending output, cache, aux)."""
    d = None
    for i, p in enumerate(_layers(params["blocks"]["mamba"])):
        if mode == "train":
            x, d = _maybe_remat(_mamba_train_layer, cfg, mode)(p, cfg, x, d)
        else:
            x, d = _mamba_layer(p, cfg, x, d, cache, i, mode == "decode")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, d, None, aux
    return x, d, {"ssm": cache["ssm"], "conv": cache["conv"]}, aux


def _hybrid_stack(params, cfg, x, mode, cache=None):
    """Zamba2: groups of ``attn_every`` mamba blocks, a single *shared*
    attention+MLP block applied before each group, with a KV cache per
    application (``[n_apps, B, S, Hkv, hd]``).  Decode writes the token's
    k/v and the mamba states in place; prefill stacks the applications'
    (k, v).  The train mode takes no cache and writes no state (new cache
    None), each shared application and each mamba layer under
    ``cfg.remat``.  Returns (h, the last block's pending output, cache,
    aux)."""
    n_apps, per = cfg.num_layers // cfg.attn_every, cfg.attn_every
    shared = params["shared"]
    mamba = _layers(params["blocks"]["mamba"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    d = None
    if mode == "train":
        for app in range(n_apps):
            x, d = _maybe_remat(_shared_train_block, cfg, mode)(shared, cfg,
                                                                x, d)
            for i in range(app * per, (app + 1) * per):
                x, d = _maybe_remat(_mamba_train_layer, cfg, mode)(
                    mamba[i], cfg, x, d)
        return x, d, None, aux
    decode = mode == "decode"
    pos = cache["len"]
    ks, vs = [], []
    for app in range(n_apps):
        kv = (cache["k"][app], cache["v"][app])
        x, d, nkv = attn_block(shared["attn"], cfg, x, d, mode=mode,
                               layer_kv=kv, pos=pos)
        x, d = mlp_block(shared["mlp"], cfg, x, d)
        if not decode:
            ks.append(nkv[0])
            vs.append(nkv[1])
        for i in range(app * per, (app + 1) * per):
            x, d = _mamba_layer(mamba[i], cfg, x, d, cache, i, decode)
    new_cache = {"ssm": cache["ssm"], "conv": cache["conv"]}
    if decode:
        new_cache["k"], new_cache["v"] = cache["k"], cache["v"]
    else:
        new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    return x, d, new_cache, aux


_STACKS = {"dense": _dense_stack, "moe": _dense_stack, "vlm": _dense_stack,
           "ssm": _ssm_stack, "hybrid": _hybrid_stack}


def _enc_embeds(cfg: ModelConfig, batch):
    return batch["enc_embeds"].to(torch_dtype(cfg.compute_dtype))


def forward_train(params: Params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Returns (hidden [B,S,d], aux_loss scalar). Loss lives in
    train/loss.py.

    ``batch``: {"tokens": [B, S] int, ...}; the vlm family prepends
    ``batch["patch_embeds"]`` [B, S_img, d] to the token embeddings, and
    the encdec family's encoder reads ``batch["enc_embeds"]``.  The
    hidden returned is the sum the JAX function returns (the last block's
    pending output added).  No cache is read or written, and attention
    and the SSD scan take their plain versions (the JAX training path;
    see the module docstring)."""
    if cfg.family == "encdec":
        dec_x = _embed(params, cfg, batch["tokens"])
        h, d, _, aux = _encdec_stacks(params, cfg, _enc_embeds(cfg, batch),
                                      dec_x, "train")
        return h + d, aux
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    h, d, _, aux = _STACKS[cfg.family](params, cfg, x, "train")
    return h + d, aux


def decode_step(params: Params, cfg: ModelConfig, cache, token: torch.Tensor):
    """One-token decode. token: [B, 1] int. Returns (logits [B,1,V] fp32,
    cache); the cache's KV arrays and SSM/conv states are updated in
    place and its ``len`` advances by one on the device."""
    x = _embed(params, cfg, token)
    if cfg.family == "encdec":
        h, d, nc, _ = _encdec_stacks(params, cfg, None, x, "decode", cache)
    else:
        h, d, nc, _ = _STACKS[cfg.family](params, cfg, x, "decode", cache)
    nc["len"] = cache["len"] + 1
    # carry across non-updated fields
    for key in cache:
        if key not in nc:
            nc[key] = cache[key]
    return _unembed(params, cfg, h, d), nc


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int):
    """Process a prompt, build the cache. Returns (last_logits [B,1,V],
    cache with KV arrays ``[L, B, max_len, Hkv, hd]`` (the hybrid's
    ``[n_apps, ...]``, gemma2's ``local_k/v`` and ``global_k/v``
    ``[L/2, ...]``, whisper's ``cross_k/v`` ``[L, B, S_enc, Hkv, hd]``
    unpadded), SSM/conv states for ssm/hybrid, and ``len`` = S)."""
    if cfg.family == "encdec":
        S = batch["tokens"].shape[1]
        dec_x = _embed(params, cfg, batch["tokens"])
        h, d, nc, _ = _encdec_stacks(params, cfg, _enc_embeds(cfg, batch),
                                     dec_x, "prefill")
        nc = _local_kv(_pad_kv_cache(nc, max_len, S))
        nc["len"] = torch.tensor(S, dtype=torch.int32, device=dec_x.device)
        return _unembed(params, cfg, h[:, -1:], d[:, -1:]), nc
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm":
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    S = x.shape[1]
    if cfg.family in ("ssm", "hybrid"):
        # SSM prefill needs real state carry: run with a concrete zero cache
        # of the heads the layers compute (this rank's, when split)
        cache = init_cache(cfg, x.shape[0], max_len, device=x.device,
                           ssm_heads=params["blocks"]["mamba"]["dt_bias"]
                           .shape[-1])
        h, d, nc, _ = _STACKS[cfg.family](params, cfg, x, "prefill", cache)
    else:
        h, d, nc, _ = _dense_stack(params, cfg, x, "prefill", None)
    nc = _local_kv(_pad_kv_cache(nc, max_len, S))
    nc["len"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return _unembed(params, cfg, h[:, -1:], d[:, -1:]), nc


def _local_kv(nc):
    """A prefill's cache as this rank holds it under the tensor-parallel
    context: each KV leaf ``[L, B, S, Hkv, hd]`` of a cache split over the
    sequence (``tp.kv_layout``; it holds every kv head) cut to this rank's
    range of its S slots; every other leaf as computed (its heads, or the
    whole cache)."""
    out = {}
    for name, t in nc.items():
        kind = "cross" if name.startswith("cross") else "self"
        if (name in ("k", "v") or name.endswith(("_k", "_v"))) \
                and kv_layout(kind) == "sequence":
            t = seq_range(t, 2)
        out[name] = t
    return out


def _pad_kv_cache(nc, max_len: int, cur_len: int):
    """Pad prefill-produced [.., S, Hkv, hd] KV arrays out to max_len
    slots (zeros)."""
    def pad(x):
        if x.dim() >= 4 and x.shape[-3] == cur_len and max_len > cur_len:
            out = x.new_zeros(x.shape[:-3] + (max_len,) + x.shape[-2:])
            out[..., :cur_len, :, :] = x
            return out
        return x
    return {k: (pad(v) if k.endswith(("k", "v")) and "cross" not in k
                and not k.startswith(("ssm", "conv")) else v)
            for k, v in nc.items()}
