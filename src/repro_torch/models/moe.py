"""Top-k Mixture-of-Experts FFN (the *layer* kind, not the paper's
predictor).

Mirrors the JAX package's ``models/moe.py``: tokens are dispatched into
an ``[E, C, d]`` capacity buffer, each expert runs a dense SwiGLU (one
batched product per weight, ``torch.bmm``), and the results are combined
back with the router weights.  Assignments past an expert's capacity C
are dropped.  The JAX version scatters and scatter-adds; here dispatch
writes every buffer slot at most once and combine gathers each token's k
slots and sums them, so nothing depends on the order of duplicate writes
or of atomics, and no step reads a count back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import activation


class MoEOutput(NamedTuple):
    y: torch.Tensor                            # [N, d]
    aux_loss: Optional[torch.Tensor]           # scalar load-balancing loss
    fraction_dropped: Optional[torch.Tensor]   # scalar, monitoring


def router_topk(logits: torch.Tensor, k: int):
    """logits [N, E] -> (weights [N,k] fp32 normalized, idx [N,k] int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    counts = torch.zeros(num_experts, dtype=torch.float32,
                         device=probs.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=probs.device))
    f = counts / max(idx.numel(), 1)          # fraction routed per expert
    p = probs.mean(0)                         # mean router prob per expert
    return num_experts * torch.sum(f * p)


def capacity(n_tokens: int, k: int, capacity_factor: float,
             num_experts: int) -> int:
    """Slots per expert: the JAX package's formula, rounded up to 8."""
    c = max(int(n_tokens * k * capacity_factor / num_experts), 1)
    return -(-c // 8) * 8


def _local_dispatch(x: torch.Tensor, weights: torch.Tensor,
                    idx: torch.Tensor, E: int, C: int):
    """Group the ``N`` tokens of ``x`` by expert into ``buf [E, C, d]``.

    Returns ``(buf, src, wgt, keep)``: for each (token, choice) pair in
    the tokens' top-k order, ``src`` its slot ``e * C + c`` in the
    flattened buffer and ``wgt`` its router weight (0 where dropped);
    ``keep`` marks the pairs inside capacity, in expert order."""
    N, d = x.shape
    k = idx.shape[1]
    dev = x.device
    # ---- slot assignment: position of each (token, expert) pair within
    # its expert's buffer, by a stable sort over expert ids
    flat_e = idx.reshape(-1)                           # [N*k]
    order = torch.argsort(flat_e, stable=True)         # group by expert
    sorted_e = flat_e[order]
    # the first sorted position of each expert (torch.bincount would read
    # its input's maximum back to the host in every layer)
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    pos_in_e = torch.arange(N * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.clamp(pos_in_e, max=C - 1)           # clipped; weight 0
    tok = torch.div(order, k, rounding_mode="floor")  # token per entry
    wgt = torch.where(keep, weights.reshape(-1)[order], 0.0)

    # ---- dispatch: buf[e, c] = x[token assigned to (e, c)].  The JAX
    # version (moe.py:80-85) also writes 0 from every dropped entry to
    # slot C-1 of its expert, after the kept token there, so in an expert
    # past capacity slot C-1 ends up 0 (that token's expert output is 0).
    # Here each slot is written at most once, kept tokens only, and that
    # slot is left at 0; the rest go to a scratch row past the buffer.
    write = keep & ~((counts[sorted_e] > C) & (pos_in_e == C - 1))
    dest = torch.where(write, sorted_e * C + slot, E * C)
    buf = torch.zeros(E * C + 1, d, dtype=x.dtype, device=dev)
    buf.index_copy_(0, dest, x[tok])
    buf = buf[:E * C].view(E, C, d)

    # each pair's slot and weight back in the tokens' top-k order (the
    # inverse of ``order``)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * k, device=dev)
    return buf, (sorted_e * C + slot)[inv], wgt[inv], keep


def _combine(y_buf: torch.Tensor, src: torch.Tensor, wgt: torch.Tensor,
             k: int, dtype) -> torch.Tensor:
    """Each token's k slots of the flattened expert outputs ``y_buf
    [E*C, d]``, weighted and summed in fp32 in the token's top-k order
    (the JAX version scatter-adds them in expert order: the same
    products, summed in another order)."""
    y_slots = y_buf[src].float() * wgt[:, None]
    return y_slots.view(-1, k, y_buf.shape[1]).sum(1).to(dtype)


def moe_ffn(
    x: torch.Tensor,          # [N, d] flattened tokens
    w_router: torch.Tensor,   # [d, E]
    w_gate: torch.Tensor,     # [E, d, f]
    w_up: torch.Tensor,       # [E, d, f]
    w_down: torch.Tensor,     # [E, f, d]
    *,
    k: int,
    capacity_factor: float,
    act: str = "silu",
    with_aux: bool = False,
) -> MoEOutput:
    """The MoE FFN of ``N`` tokens.  ``aux_loss`` and
    ``fraction_dropped`` are computed only ``with_aux`` (serving never
    reads them; JAX's jit drops them as dead code there), else None."""
    N, d = x.shape
    E = w_router.shape[1]
    C = capacity(N, k, capacity_factor, E)

    # the router in fp32: JAX promotes the bf16 activations to w_router's
    # fp32 in its einsum
    logits = x.float() @ w_router.float()
    weights, idx = router_topk(logits, k)              # [N, k]

    buf, src, wgt, keep = _local_dispatch(x, weights, idx, E, C)

    # ---- expert computation (batched products)
    g = activation(torch.bmm(buf, w_gate), act)
    u = torch.bmm(buf, w_up)
    y_buf = torch.bmm((g * u).to(x.dtype), w_down).view(E * C, d)
    y = _combine(y_buf, src, wgt, k, x.dtype)
    if not with_aux:
        return MoEOutput(y, None, None)
    probs = torch.softmax(logits, dim=-1)
    aux = load_balance_loss(probs, idx, E)
    dropped = 1.0 - keep.float().mean()
    return MoEOutput(y, aux, dropped)
