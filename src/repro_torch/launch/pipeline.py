"""GPipe-style microbatch pipeline parallelism over a mesh axis (the JAX
package's ``launch/pipeline.py``, whose ``shard_map`` body runs here in
every rank).

Each rank of the pipe axis holds its stage's parameters; the
``n_micro + n_stages - 1``-tick schedule moves the activations one stage
downstream per tick (the ring ``ppermute``: ``batch_isend_irecv`` on the
axis's sub-group); the last stage writes its finished microbatch into the
output buffer, which is summed over the axis at the end (only one rank
writes each slot), so every rank returns the whole output.  Forward only,
like the JAX function.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_map


def _local_stage(leaf: torch.Tensor) -> torch.Tensor:
    """This rank's stage of a leaf: a DTensor sharded over the pipe axis
    on dim 0 gives its local block, a plain tensor is that block; either
    way ``[1, ...]``, dropped to ``[...]``."""
    local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
    assert local.shape[0] == 1, local.shape
    return local[0]


def _shift(y: torch.Tensor, group) -> torch.Tensor:
    """Send ``y`` to the next rank of ``group`` and receive the previous
    rank's (the ring ``ppermute`` ``i -> (i + 1) % n``)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    recv = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      dist.get_global_rank(group, (r + 1) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, mesh, axis: str,
                   stage_params, x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``y = stage_{S-1}(...stage_0(x))`` as a microbatch pipeline.

    stage_fn(params_slice, x) -> x'   (same shape, one pipeline stage)
    stage_params: tree of this rank's stage: leaves ``[1, ...]`` (the
        block ``shard_map`` hands its body) or DTensors of leading dim
        n_stages sharded over ``axis``
    x_micro: [n_micro, mb, ...] microbatched input (replicated)
    Returns [n_micro, mb, ...] outputs on every rank.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    pl = tree_map(_local_stage, stage_params)
    act = torch.zeros_like(x_micro[0])
    out = torch.zeros_like(x_micro)
    for t in range(ticks):
        if rank == 0:                   # stage 0 ingests microbatch t
            act = x_micro[min(t, n_micro - 1)]
        mb = t - rank                   # microbatch this rank holds
        y = stage_fn(pl, act) if 0 <= mb < n_micro else act
        if rank == n_stages - 1 and 0 <= mb < n_micro:
            out[mb] = y                 # the last stage retires it
        act = _shift(y, group) if n_stages > 1 else y
    dist.all_reduce(out, group=group)   # only the last rank wrote
    return out
