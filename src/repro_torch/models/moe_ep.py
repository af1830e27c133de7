"""Expert-parallel MoE over explicit collectives (the JAX package's
``models/moe_ep.py``, whose ``shard_map`` body runs here in every rank).

  local top-k routing -> local capacity buffer [E, C_src, d]
  all_to_all over the EP ('data') axis  (the irreducible token exchange)
  local expert GEMMs with the LOCAL expert shard (TP over 'model' inside)
  reverse all_to_all -> local combine

Capacity is per source shard, ``C = ceil8(max(int(N_local·k·cf/E), 1))``,
so which tokens drop differs from the dense path's global capacity, as in
the JAX version.

Each rank passes its own shard of every input, the one ``shard_map``
would hand its body: ``x`` the rank's tokens (its block over the token
axes, replicated over 'model'), ``w_router`` whole, the expert weights
``[E/D, d, f/M]`` and ``[E/D, f/M, d]`` (P('data', None, 'model') and
P('data', 'model', None)).  The gradients are those of ``jax.grad``
through ``shard_map``: a replicated input's gradient is the sum over the
ranks that computed with it, a sharded one's is its shard's.  Three ops
make that so:

  * entering the f-sharded expert GEMMs (``_CopyTo``, ``models/tp.py``):
    identity forward, the gradient all-reduced over 'model' (each rank
    holds only its f-slice's share of it); leaving them, the partial sum
    (``_ReduceFrom``): all-reduce forward, identity backward;
  * the replicated router enters through ``_CopyTo`` over the token axes,
    so its gradient sums over the token shards;
  * under ``tp_dispatch`` each model rank takes its 1/M of the rank's
    tokens on entry (``_Split``: all-gather backward) and the output is
    gathered back over 'model' on exit (``_Gather``: its slice
    backward); the exchange is then gathered over 'model' before the
    GEMMs and reduce-scattered after them (autograd-carrying functional
    collectives, whose backwards are each other).

The aux loss is the mean of the shards' losses over the token axes (the
JAX ``pmean``); ``fraction_dropped`` is the shards' mean fraction (the
JAX version returns 0).  Both only ``with_aux``, as ``moe_ffn``.

The mesh comes from ``ep_mesh_context`` (the train launcher sets it);
without one, ``models/moe.py``'s dense path runs.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import activation
from repro_torch.models.moe import (MoEOutput, _combine, _local_dispatch,
                                    capacity, load_balance_loss, router_topk)
from repro_torch.models.tp import _CopyTo, _ReduceFrom, all_reduce

_ctx = threading.local()


@contextmanager
def ep_mesh_context(mesh, data_axis: str = "data",
                    model_axis: str = "model",
                    extra_batch_axes: Tuple[str, ...] = (),
                    tp_dispatch: bool = False):
    """Declare the ``DeviceMesh`` for the expert-parallel MoE.
    ``extra_batch_axes`` are axes tokens are also sharded over but experts
    are replicated over ('pod').

    ``tp_dispatch``: also shard the routing/dispatch phase over the model
    axis (otherwise every TP rank repeats it on the full local token set).
    Costs one all-gather of the received expert inputs before the GEMMs."""
    prev = getattr(_ctx, "info", None)
    _ctx.info = (mesh, data_axis, model_axis, tuple(extra_batch_axes),
                 tp_dispatch)
    try:
        yield
    finally:
        _ctx.info = prev


def current_ep_mesh():
    return getattr(_ctx, "info", None)


def _gather0(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _slice0(t: torch.Tensor, group) -> torch.Tensor:
    return t.chunk(dist.get_world_size(group))[dist.get_rank(group)]


class _Split(torch.autograd.Function):
    """This rank's block of dim 0 forward; the gradient gathered back
    over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice0(x, group).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Gathered over ``group`` along dim 0 forward; this rank's block of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice0(g, ctx.group).contiguous(), None


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` of dim 0's equal blocks over ``group`` (block j to
    rank j, rank i's block to position i), with its autograd.  Counted
    forward only (``_exchange.launches``)."""
    _exchange.launches += 1
    return fc.all_to_all_single_autograd(t.contiguous(), None, None, group)


_exchange.launches = 0


def moe_ffn_ep(
    x: torch.Tensor,          # [N_rank, d] this rank's tokens
    w_router: torch.Tensor,   # [d, E] replicated
    w_gate: torch.Tensor,     # [E/D, d, f/M] this rank's shard
    w_up: torch.Tensor,
    w_down: torch.Tensor,     # [E/D, f/M, d]
    *,
    k: int,
    capacity_factor: float,
    act: str = "silu",
    with_aux: bool = False,
) -> MoEOutput:
    info = current_ep_mesh()
    assert info is not None, "moe_ffn_ep requires ep_mesh_context"
    mesh, daxis, maxis, extra, tp_dispatch = info
    D = mesh_shape(mesh).shape[daxis]
    E = w_router.shape[1]
    assert E % D == 0, (E, D)
    moe_ffn_ep.calls += 1
    gd, gm = mesh.get_group(daxis), mesh.get_group(maxis)
    token_groups = [mesh.get_group(a) for a in extra] + [gd]
    if tp_dispatch:
        token_groups.append(gm)
        x = _Split.apply(x, gm)
    n_shards = 1
    for g in token_groups:
        n_shards *= dist.get_world_size(g)

    Nl, d = x.shape
    C = capacity(Nl, k, capacity_factor, E)
    wr = _CopyTo.apply(w_router, token_groups)
    logits = x.float() @ wr.float()
    weights, idx = router_topk(logits, k)
    buf, src, wgt, keep = _local_dispatch(x, weights, idx, E, C)
    # exchange: [E, C, d] -> [E/D, D*C, d] (expert-major blocks land on
    # their owning shard; block i of dim 1 from source shard i)
    recv = _exchange(buf.view(D, E // D, C, d), gd)
    recv = recv.transpose(0, 1).reshape(E // D, D * C, d)
    if tp_dispatch:
        # dispatch ran on model-sharded tokens; the expert GEMMs (TP over
        # f) need every token of their experts: gather over TP
        recv = fc.all_gather_tensor_autograd(recv, 1, gm)
    else:
        recv = _CopyTo.apply(recv, [gm])
    # local expert GEMMs (TP over 'model' on f)
    g = activation(torch.bmm(recv, w_gate), act)
    u = torch.bmm(recv, w_up)
    y_part = torch.bmm((g * u).to(recv.dtype), w_down)
    if tp_dispatch:
        # each TP rank its own token block, partials summed
        y_recv = fc.reduce_scatter_tensor_autograd(y_part, "sum", 1, gm)
    else:
        y_recv = _ReduceFrom.apply(y_part, [gm])  # TP partial sum over f
    # reverse exchange: [E/D, D*C, d] -> [E, C, d]
    y_send = y_recv.to(x.dtype).reshape(E // D, D, C, d).transpose(0, 1)
    y_buf = _exchange(y_send, gd).reshape(E * C, d)
    y = _combine(y_buf, src, wgt, k, x.dtype)
    if tp_dispatch:
        y = _Gather.apply(y, gm)
    if not with_aux:
        return MoEOutput(y, None, None)
    probs = torch.softmax(logits, dim=-1)
    aux = _ReduceFrom.apply(load_balance_loss(probs, idx, E) / n_shards,
                            token_groups)
    with torch.no_grad():
        dropped = all_reduce(1.0 - keep.float().mean(),
                              token_groups) / n_shards
    return MoEOutput(y, aux, dropped)


moe_ffn_ep.calls = 0
