"""GPipe-style microbatch pipeline parallelism over a mesh axis (the JAX
package's ``launch/pipeline.py``, whose ``shard_map`` body runs here in
every rank).

Each rank of the pipe axis holds its stage's parameters; the
``n_micro + n_stages - 1``-tick schedule moves the activations one stage
downstream per tick (the ring ``ppermute``: ``batch_isend_irecv`` on the
axis's sub-group); the last stage writes its finished microbatch into the
output buffer, which is summed over the axis at the end (only one rank
writes each slot), so every rank returns the whole output.

Differentiable in the stage parameters and ``x_micro``, as ``jax.grad``
through the JAX function is: the gradients are those of applying the
stages in sequence.  The backward runs the schedule in reverse, each
tick's output gradient shifted one rank upstream (the reverse ring
``(r + 1) -> r``).  It is one ``torch.autograd.Function`` over the whole
schedule, not one per shift, because only the last rank's output buffer
has a local graph to the loss: a rank's autograd alone would never run
the shifts of the others.  Every rank computes the same loss from the
replicated output; its gradient enters at the last stage (the output's
all-reduce passes it through unchanged), and the gradient of the
replicated ``x_micro`` is summed over the axis, so every rank holds it
whole.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _local_stage(leaf: torch.Tensor) -> torch.Tensor:
    """This rank's stage of a leaf: a DTensor sharded over the pipe axis
    on dim 0 gives its local block, a plain tensor is that block; either
    way ``[1, ...]``, dropped to ``[...]``."""
    local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
    assert local.shape[0] == 1, local.shape
    return local[0]


def _shift(y: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Send ``y`` to rank ``r + step`` of ``group`` and receive rank
    ``r - step``'s (the ring ``ppermute`` ``i -> (i + 1) % n`` forward;
    ``step=-1`` is its reverse, the backward's)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    recv = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _schedule(stage_fn, pl, x_micro, group, saved=None) -> torch.Tensor:
    """The forward ticks; with ``saved`` (a list) each tick's (input,
    output) graph is recorded, under grad, for the backward."""
    n_stages = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    act = torch.zeros_like(x_micro[0])
    out = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if rank == 0:                   # stage 0 ingests microbatch t
            act = x_micro[min(t, n_micro - 1)]
        mb = t - rank                   # microbatch this rank holds
        if not 0 <= mb < n_micro:
            y = act
        elif saved is None:
            y = stage_fn(pl, act)
        else:
            a = act.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(pl, a)
            saved.append((t, a, y))
            y = y.detach()
        if rank == n_stages - 1 and 0 <= mb < n_micro:
            out[mb] = y                 # the last stage retires it
        act = _shift(y, group) if n_stages > 1 else y
    dist.all_reduce(out, group=group)   # only the last rank wrote
    return out


class _Pipeline(torch.autograd.Function):
    """``_schedule`` with its backward: the ticks in reverse."""

    @staticmethod
    def forward(ctx, stage_fn, template, group, x_micro, *leaves):
        ins = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        saved = []
        out = _schedule(stage_fn, tree_unflatten(template, ins), x_micro,
                        group, saved)
        ctx.group, ctx.ins, ctx.saved = group, ins, saved
        ctx.x_shape, ctx.n_micro = x_micro.shape, x_micro.shape[0]
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, n_micro = ctx.group, ctx.n_micro
        n_stages = dist.get_world_size(group)
        rank = dist.get_rank(group)
        ticks = n_micro + n_stages - 1
        wrt = [p for p in ctx.ins if p.requires_grad]
        g_leaves = [torch.zeros_like(p) for p in wrt]
        g_x = torch.zeros(ctx.x_shape, dtype=g_out.dtype,
                          device=g_out.device)
        graphs = {t: (a, y) for t, a, y in ctx.saved}
        g_act = torch.zeros_like(g_x[0])    # of act(t + 1) on this rank
        for t in reversed(range(ticks)):
            # the gradient of y(t): of what rank + 1 received from it
            if n_stages == 1:
                g_y = g_act
            elif t == ticks - 1:        # the last shift's output is unused
                g_y = torch.zeros_like(g_act)
            else:
                g_y = _shift(g_act if rank > 0 else torch.zeros_like(g_act),
                             group, -1)
            mb = t - rank
            if rank == n_stages - 1 and 0 <= mb < n_micro:
                g_y = g_y + g_out[mb]
            if t in graphs:
                a, y = graphs[t]
                gs = torch.autograd.grad(y, [a] + wrt, g_y,
                                         allow_unused=True)
                g_act = gs[0] if gs[0] is not None else torch.zeros_like(a)
                for acc, g in zip(g_leaves, gs[1:]):
                    if g is not None:
                        acc.add_(g)
            else:
                g_act = g_y
            if rank == 0:               # act(t) was x[min(t, n_micro - 1)]
                g_x[min(t, n_micro - 1)] += g_act
        dist.all_reduce(g_x, group=group)
        ctx.saved = ctx.ins = None
        it = iter(g_leaves)
        return (None, None, None, g_x,
                *(next(it) if need else None
                  for need in ctx.needs_input_grad[4:]))


def pipeline_apply(stage_fn: Callable, mesh, axis: str,
                   stage_params, x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``y = stage_{S-1}(...stage_0(x))`` as a microbatch pipeline.

    stage_fn(params_slice, x) -> x'   (same shape, one pipeline stage)
    stage_params: tree of this rank's stage: leaves ``[1, ...]`` (the
        block ``shard_map`` hands its body) or DTensors of leading dim
        n_stages sharded over ``axis``
    x_micro: [n_micro, mb, ...] microbatched input (replicated)
    Returns [n_micro, mb, ...] outputs on every rank, differentiable in
    ``stage_params`` and ``x_micro`` (every rank must run the backward).
    """
    group = mesh.get_group(axis)
    pl = tree_map(_local_stage, stage_params)
    leaves = list(tree_leaves(pl))
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in [x_micro] + leaves):
        with torch.no_grad():
            return _schedule(stage_fn, pl, x_micro, group)
    return _Pipeline.apply(stage_fn, pl, group, x_micro, *leaves)
