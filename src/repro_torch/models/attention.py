"""Grouped-query attention with the full option set used by the assigned archs.

The plain PyTorch path of ``attention`` mirrors the JAX package's XLA
path.  Where the JAX package reaches a Pallas kernel (with
``use_pallas``), the port reaches its hand-written CUDA kernel whenever
the tensor lies on the card, whatever ``use_pallas`` says: prefill
self-attention goes to ``kernels/flash_attention``, dense decode to
``kernels/decode_attention`` and paged decode to
``kernels/paged_attention``.  The paged prefill chunk, plain XLA in the
JAX package, goes to ``kernels/paged_prefill`` on the card too.  A CPU
tensor takes the plain path.

The train mode is the exception, and the model's mode decides it, never
the device: ``attention(..., differentiable=True)`` takes the plain path
on any device, because the kernels have no backward and the JAX package
trains through its plain XLA attention (``use_pallas=False``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import softcap
from repro_torch.obs.spans import COUNTERS

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Boolean [.., Q, K] mask of *allowed* positions.

    q_pos: [Q] or [B, Q]; k_pos: [K] or [B, K].
    """
    qp = q_pos[..., :, None].to(torch.int32)
    kp = k_pos[..., None, :].to(torch.int32)
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=qp.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    if kv_len is not None:
        kv = torch.as_tensor(kv_len, dtype=torch.int32, device=qp.device)
        kv = kv.reshape(kv.shape + (1, 1)) if kv.dim() else kv
        ok = ok & (kp < kv)
    return ok


def attention(
    q: torch.Tensor,           # [B, Q, Hq, D]
    k: torch.Tensor,           # [B, K, Hkv, D]
    v: torch.Tensor,           # [B, K, Hkv, D]
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,  # [Q] or [B,Q]
    k_positions: Optional[torch.Tensor] = None,  # [K] or [B,K]
    kv_len: Optional[torch.Tensor] = None,       # scalar or [B]
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    use_pallas: bool = False,
    f32_logits: bool = True,
    differentiable: bool = False,
) -> torch.Tensor:
    """Returns [B, Q, Hq, D]. Softmax in fp32 (or in the input dtype with
    explicit max-subtraction when ``f32_logits=False``).

    Self-attention of a whole sequence (``Q > 1``, causal, ``Q == K``, no
    ``kv_len``: where the JAX package may take its flash kernel) runs the
    CUDA flash-attention kernel on a CUDA tensor (fp32 online softmax, so
    ``f32_logits`` and the positions do not apply there, as in the JAX
    kernel path).  ``use_pallas`` is kept for the callers' signature and
    has no effect: the tensor's device decides, except that
    ``differentiable`` (the model's train mode) always takes the plain
    path, which autograd can differentiate, as the JAX package trains."""
    B, Q, Hq, D = q.shape
    _, K, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale

    if (q.is_cuda and not differentiable and Q > 1 and causal
            and kv_len is None and Q == K):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(
            q, k, v, causal=True, window=window,
            attn_softcap=attn_softcap, scale=scale)

    if q_positions is None:
        q_positions = torch.arange(Q, device=q.device)
    if k_positions is None:
        k_positions = torch.arange(K, device=q.device)

    ldt = torch.float32 if f32_logits else q.dtype
    qg = q.reshape(B, Q, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ldt), k.to(ldt)) \
        * torch.tensor(scale, dtype=ldt)
    if attn_softcap > 0.0:
        logits = softcap(logits, attn_softcap).to(ldt)
    mask = _mask(q_positions, k_positions, causal=causal, window=window,
                 kv_len=kv_len)
    # mask broadcast: [.., Q, K] -> [B?, 1, 1, Q, K]
    while mask.dim() < logits.dim():
        mask = mask.unsqueeze(-3)
    neg = torch.tensor(-3e4 if ldt == torch.bfloat16 else NEG_INF,
                       dtype=ldt, device=q.device)
    logits = torch.where(mask, logits, neg)
    if f32_logits:
        probs = torch.softmax(logits.float(), dim=-1)
    else:
        m = torch.amax(logits, dim=-1, keepdim=True)
        e = torch.exp((logits - m).float()).to(ldt)
        probs = e / torch.clamp(e.float().sum(-1, keepdim=True),
                                min=1e-9).to(ldt)
    odt = torch.float32 if f32_logits else v.dtype
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(odt),
                       v.to(odt))
    return out.reshape(B, Q, Hq, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,           # [B, 1, Hq, D]
    k_pool: torch.Tensor,      # [P, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp] int32 (unused slots -> page 0)
    lens: torch.Tensor,        # [B] int32: valid tokens incl. current
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    f32_logits: bool = True,
) -> torch.Tensor:
    """One-token attention against a page-table KV pool; each row has its
    own length (no shared position counter).

    The tensor's device decides the path, and nothing else does: on a
    CUDA tensor this always launches the CUDA paged-decode kernel (fp32
    online softmax, so ``f32_logits`` does not apply there); on a CPU
    tensor it gathers the pages and runs the plain ``attention``.
    ``cfg.use_pallas`` has no effect on the port's paged decode.  A row
    with ``lens == 0`` comes out as zeros from the kernel and as a uniform
    average from the plain path; callers never read such rows."""
    if q.is_cuda:
        from repro_torch.kernels.paged_attention import ops as pa_ops
        return pa_ops.paged_attention(
            q, k_pool, v_pool, page_table, lens,
            window=window, attn_softcap=attn_softcap, scale=scale)
    from repro_torch.kernels.paged_attention.ref import gather_pages
    k = gather_pages(k_pool, page_table)       # [B, maxp*page, Hkv, D]
    v = gather_pages(v_pool, page_table)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=q.device)
    return attention(
        q, k, v, causal=True,
        q_positions=(lens - 1)[:, None],
        k_positions=torch.arange(k.shape[1], device=q.device),
        kv_len=lens, window=window, attn_softcap=attn_softcap,
        scale=scale, f32_logits=f32_logits)


def paged_prefill_attention(
    q: torch.Tensor,           # [B, C, Hq, D] one chunk per row
    k_pool: torch.Tensor,      # [P, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp] int32 (unused slots -> page 0)
    start: torch.Tensor,       # [B] int32: position of query 0, any stride
    kv_lens: torch.Tensor,     # [B] int32: valid tokens after the write
    *,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    f32_logits: bool = True,
) -> torch.Tensor:
    """A prefill chunk's attention over the page pool: query ``i`` of row
    ``b`` sits at position ``start[b] + i`` and attends causally to the
    row's first ``kv_lens[b]`` tokens, which include the chunk's own.

    The tensor's device decides the path: on a CUDA tensor this always
    launches the CUDA paged-prefill kernel, which reads each row's live
    pages in place (fp32 online softmax, so ``f32_logits`` does not apply
    there); on a CPU tensor it gathers every row's whole page table and
    runs the plain ``attention``, as the JAX package's chunk path does,
    and counts the gathered slots (``attn.kv_gathered``; on the card the
    paged backend counts the slots the kernel reads).  A row with
    ``kv_lens == 0`` comes out as zeros from the kernel and as a uniform
    average from the plain path; callers never read such rows."""
    if q.is_cuda:
        from repro_torch.kernels.paged_prefill import ops as pp_ops
        return pp_ops.paged_prefill(
            q, k_pool, v_pool, page_table, start, kv_lens,
            attn_softcap=attn_softcap, scale=scale)
    from repro_torch.kernels.paged_attention.ref import gather_pages
    k = gather_pages(k_pool, page_table)       # [B, maxp*page, Hkv, D]
    v = gather_pages(v_pool, page_table)
    COUNTERS.inc("attn.kv_gathered", k.shape[0] * k.shape[1])
    positions = start[:, None] + torch.arange(
        q.shape[1], dtype=start.dtype, device=q.device)[None, :]
    return attention(
        q, k, v, causal=True, q_positions=positions,
        k_positions=torch.arange(k.shape[1], device=q.device),
        kv_len=kv_lens, attn_softcap=attn_softcap, scale=scale,
        f32_logits=f32_logits)


def decode_attention(
    q: torch.Tensor,            # [B, 1, Hq, D]
    k_cache: torch.Tensor,      # [B, S, Hkv, D]
    v_cache: torch.Tensor,      # [B, S, Hkv, D]
    cache_len,                  # scalar int32: index of the current token
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    use_pallas: bool = False,
    f32_logits: bool = True,
) -> torch.Tensor:
    """One-token attention against a (possibly partially filled) KV cache.

    The tensor's device decides the path: on a CUDA tensor this always
    launches the CUDA dense-decode kernel (fp32 online softmax, so
    ``f32_logits`` does not apply there); on a CPU tensor it runs the
    plain ``attention``.  ``use_pallas`` is kept for the callers'
    signature and has no effect."""
    if q.is_cuda:
        from repro_torch.kernels.decode_attention import ops as da_ops
        return da_ops.decode_attention(
            q, k_cache, v_cache, cache_len,
            window=window, attn_softcap=attn_softcap, scale=scale)
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=q.device)
    q_pos = cache_len.reshape(1)               # query at index len
    return attention(
        q, k_cache, v_cache, causal=True,
        q_positions=q_pos,
        k_positions=torch.arange(k_cache.shape[1], device=q.device),
        kv_len=cache_len + 1, window=window,
        attn_softcap=attn_softcap, scale=scale, f32_logits=f32_logits)
