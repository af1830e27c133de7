"""Qwen3 and Qwen3-MoE in plain PyTorch, float32, from the published
description (Hugging Face ``Qwen3ForCausalLM`` / ``Qwen3MoeForCausalLM``):
pre-norm RMSNorm blocks; grouped-query attention with an RMSNorm on
each q and k head and rotate-half RoPE; a SwiGLU MLP, or 128 SwiGLU
experts of which each token takes its top 8 by the softmax of the router
logits, their weights renormalised to sum to 1, none dropped; a final
RMSNorm and the LM head (the tied embedding in qwen3-0.6b).

It reads a weight tree laid out as the benchmark makes it: ``embed``
[V, d], ``final_ln_w``, ``lm_head`` [d, V] (untied), and under
``blocks`` each leaf stacked over the layers: ``attn/{ln_w, wq, wk, wv,
wo, q_norm, k_norm}`` (x @ w), ``mlp/{ln_w, wi_gate, wi_up, wo}`` or
``moe/{ln_w, w_router, w_gate, w_up, w_down}``.  Everything is computed
in float32 one layer at a time, with the weights of that layer cast as
they are used, so a 61 GB bf16 model fits beside its float32 layer.

``quant`` (the control) computes every linear layer but the router in
fp8: both operands rounded to e4m3 with a scale per row of the
activation and per output column of the weight, and in training the
incoming gradient rounded to e5m2 with a scale per row, before each of
the backward's two products (the usual fp8 training recipe): the
reference computed in the precision below bf16.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    eps: float
    theta: float
    tied: bool
    experts: int = 0
    top_k: int = 0

    @classmethod
    def of(cls, config: dict) -> "Dims":
        """From a configuration file (the published ``config.json``
        keys)."""
        return cls(layers=config["num_hidden_layers"],
                   d=config["hidden_size"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"],
                   vocab=config["vocab_size"],
                   eps=float(config["rms_norm_eps"]),
                   theta=float(config["rope_theta"]),
                   tied=bool(config["tie_word_embeddings"]),
                   experts=config.get("num_experts", 0),
                   top_k=config.get("num_experts_per_tok", 0))


def fake_fp8(x: torch.Tensor, dim: int,
             dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to fp8 at a scale per slice along ``dim`` (absmax to the
    format's largest value), back in float32."""
    top = torch.finfo(dtype).max
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = top / amax
    return (x * s).to(dtype).to(torch.float32) / s


class _Fp8Matmul(torch.autograd.Function):
    """x @ w with e4m3 operands; the backward's products take the
    incoming gradient in e5m2 and the saved e4m3 operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fake_fp8(x, -1), fake_fp8(w, 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        g = fake_fp8(dy, -1, torch.float8_e5m2)
        dx = g @ wq.T
        dw = (xq.reshape(-1, xq.shape[-1]).T
              @ fake_fp8(dy.reshape(-1, dy.shape[-1]), 0,
                         torch.float8_e5m2))
        return dx, dw


def linear(x: torch.Tensor, w: torch.Tensor, quant: bool = False):
    """x [..., i] @ w [i, o] in float32 (in fp8 with ``quant``)."""
    w = w.float()
    if quant:
        return _Fp8Matmul.apply(x, w)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [..., T, H, D] at positions pos [T]."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def layer_weights(blocks: dict, i: int) -> dict:
    """Layer ``i``'s weights, as views (cast where used)."""
    return {kind: {k: v[i] for k, v in leaves.items()}
            for kind, leaves in blocks.items()}


def all_layers(blocks: dict) -> List[dict]:
    """Every layer's weights from one ``unbind`` per stacked leaf (its
    gradient is stacked once, not built full-size for every layer)."""
    cols = {kind: {k: torch.unbind(v) for k, v in leaves.items()}
            for kind, leaves in blocks.items()}
    n = len(next(iter(next(iter(cols.values())).values())))
    return [{kind: {k: c[i] for k, c in leaves.items()}
             for kind, leaves in cols.items()} for i in range(n)]


def attention(h, w, dm: Dims, quant=False):
    """Causal attention of h [B, T, d] (positions 0..T-1)."""
    B, T, _ = h.shape
    D = dm.head_dim
    q = linear(h, w["wq"], quant).view(B, T, dm.heads, D)
    k = linear(h, w["wk"], quant).view(B, T, dm.kv_heads, D)
    v = linear(h, w["wv"], quant).view(B, T, dm.kv_heads, D)
    q = rms_norm(q, w["q_norm"], dm.eps)
    k = rms_norm(k, w["k_norm"], dm.eps)
    pos = torch.arange(T, device=h.device)
    q, k = rope(q, pos, dm.theta), rope(k, pos, dm.theta)
    G = dm.heads // dm.kv_heads
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return linear(o.reshape(B, T, dm.heads * D), w["wo"], quant)


def mlp(h, w, quant=False):
    g = linear(h, w["wi_gate"], quant)
    return linear(torch.nn.functional.silu(g) * linear(h, w["wi_up"], quant),
                  w["wo"], quant)


def moe(h, w, dm: Dims, quant=False):
    """Every token through its top-k experts (none dropped), weighted by
    the renormalised softmax of the float32 router logits."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(x @ w["w_router"].float(), dim=-1)
    wts, idx = torch.topk(probs, dm.top_k, dim=-1)
    wts = wts / wts.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        xe = x[tok]
        g = linear(xe, w["w_gate"][e], quant)
        u = linear(xe, w["w_up"][e], quant)
        ye = linear(torch.nn.functional.silu(g) * u, w["w_down"][e], quant)
        y.index_add_(0, tok, ye * wts[tok, slot][:, None])
    return y.view(shape)


def attn_block(x, w, dm: Dims, quant=False):
    a = w["attn"]
    return x + attention(rms_norm(x, a["ln_w"], dm.eps), a, dm, quant)


def ffn_block(x, w, dm: Dims, quant=False):
    if "moe" in w:
        f = w["moe"]
        return x + moe(rms_norm(x, f["ln_w"], dm.eps), f, dm, quant)
    f = w["mlp"]
    return x + mlp(rms_norm(x, f["ln_w"], dm.eps), f, quant)


def block(x, w, dm: Dims, quant=False):
    """One decoder layer on x [B, T, d]."""
    return ffn_block(attn_block(x, w, dm, quant), w, dm, quant)


def head_weight(params: dict, dm: Dims) -> torch.Tensor:
    return params["embed"].T if dm.tied else params["lm_head"]


def final_logits(h, final_w, head, dm: Dims, quant=False):
    """The final RMSNorm and the LM head of h [..., d]."""
    return linear(rms_norm(h, final_w, dm.eps), head, quant)


@torch.no_grad()
def logits_at(params: dict, dm: Dims, seqs: Sequence[Sequence[int]],
              wanted: Sequence[Sequence[int]], device,
              quant: bool = False) -> List[torch.Tensor]:
    """For each token sequence, the float32 logits [len(wanted[i]), V]
    at the positions ``wanted[i]``: one full causal forward per
    sequence, layer by layer over all sequences."""
    no_tf32()
    hs = [params["embed"][torch.as_tensor(list(s), device=device)]
          .float()[None] for s in seqs]
    sizes = [h.shape[1] for h in hs]
    for i in range(dm.layers):
        w = layer_weights(params["blocks"], i)
        hs = [attn_block(h, w, dm, quant) for h in hs]
        # the FFN over every sequence's tokens at once (one pass over
        # the experts)
        x = ffn_block(torch.cat([h[0] for h in hs]), w, dm, quant)
        hs = [t[None] for t in torch.split(x, sizes)]
    head = head_weight(params, dm)
    out = []
    for h, pos in zip(hs, wanted):
        out.append(final_logits(h[0, list(pos)], params["final_ln_w"],
                                head, dm, quant))
    return out


def served_gaps(params: dict, dm: Dims, prompts, served, device,
                quant: bool = False) -> List[torch.Tensor]:
    """For each request (its prompt ids and the tokens served after
    it), the gap by which each served token's reference logit lies
    below the reference's best at that position.  With ``quant`` the
    gaps are of the tokens the fp8 control puts first, read on the
    float32 reference's logits."""
    seqs = [list(p) + list(s[:-1]) for p, s in zip(prompts, served)]
    wanted = [range(len(p) - 1, len(p) - 1 + len(s))
              for p, s in zip(prompts, served)]
    ref = logits_at(params, dm, seqs, wanted, device)
    if quant:
        ctl = logits_at(params, dm, seqs, wanted, device, quant=True)
        picks = [c.argmax(-1) for c in ctl]
    else:
        picks = [torch.as_tensor(list(s), device=device) for s in served]
    return [r.max(-1).values - r.gather(1, p[:, None])[:, 0]
            for r, p in zip(ref, picks)]
