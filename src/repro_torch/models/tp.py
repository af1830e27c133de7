"""Tensor parallelism over the mesh's 'model' axis: the compute GSPMD
derives for the JAX package from its rule table
(``launch/sharding.py``), as explicit collectives, one process per rank.

Under ``tp_mesh_context(mesh)`` the model's blocks take the shards the
rule table stores (``models/model.py``):

  * attention: ``wq``/``wk``/``wv`` column-parallel (this rank's Hq/M and
    Hkv/M heads), ``wo`` row-parallel, its partial sum all-reduced
    (``reduce_from``) before the post-norm; where Hkv/M is not whole the
    rank computes every kv head from the gathered ``wk``/``wv`` and keeps
    the ones its q heads read (``local_kv_heads``, Megatron's KV
    replication);
  * the gated MLP: ``wi_gate``/``wi_up`` column-parallel, ``wo``
    row-parallel;
  * the vocabulary: the embedding lookup over this rank's rows
    ``[v0, v1)`` (``vocab_embed``), the logits of this rank's columns,
    the cross-entropy's log-sum-exp and gold logit over them
    (``vocab_lse_gold``) and greedy sampling (``vocab_argmax``).

Each block's input enters through ``copy_to`` (identity forward; the
gradient summed over 'model', where each rank holds only its heads' or
columns' share of it) and its output leaves through ``reduce_from``
(summed over 'model' forward; identity backward): Megatron's f and g.  A
block decides by the shapes it is given (``split``): a leaf the rule table
leaves whole is computed whole.  Outside the context, or on a model axis
of one rank, every helper is the identity and the one-rank paths run as
they are.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

_ctx = threading.local()


class TPInfo(NamedTuple):
    mesh: object
    group: object       # the 'model' process group of this rank
    size: int           # M
    rank: int           # this rank's index on 'model'


@contextmanager
def tp_mesh_context(mesh, model_axis: str = "model"):
    """Declare the ``DeviceMesh`` whose ``model_axis`` the dense blocks
    split over.  A mesh without that axis, or with one rank on it,
    declares nothing."""
    prev = getattr(_ctx, "info", None)
    info = None
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if model_axis in names:
        group = mesh.get_group(model_axis)
        size = dist.get_world_size(group)
        if size > 1:
            info = TPInfo(mesh, group, size, dist.get_rank(group))
    _ctx.info = info
    try:
        yield
    finally:
        _ctx.info = prev


def current_tp() -> Optional[TPInfo]:
    return getattr(_ctx, "info", None)


def split(local: int, whole: int) -> bool:
    """Whether a block holds a shard: under the context, and given
    ``local`` of the ``whole`` heads, columns or rows."""
    return current_tp() is not None and local != whole


def all_reduce(t: torch.Tensor, groups, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """A copy of ``t`` reduced over each of ``groups``."""
    t = t.clone()
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    """Summed over ``groups`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Gathered over ``group`` along the last dim forward (rank order);
    this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, \
            None, None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """A block's input under the context (its gradient summed over
    'model'); ``x`` itself outside it."""
    tp = current_tp()
    return x if tp is None else _CopyTo.apply(x, [tp.group])


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel partial sum summed over 'model' under the context;
    ``x`` itself outside it."""
    tp = current_tp()
    return x if tp is None else _ReduceFrom.apply(x, [tp.group])


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The last dim's shards gathered over 'model' in rank order (vocab-
    parallel logits made whole); ``x`` itself outside the context."""
    tp = current_tp()
    return x if tp is None else _GatherLast.apply(x, tp.group, tp.rank,
                                                  tp.size)


def local_kv_heads(k: torch.Tensor, v: torch.Tensor, num_heads: int
                   ) -> tuple:
    """Of every kv head ``[B, S, Hkv, D]`` (computed from the gathered
    ``wk``/``wv``), the ones this rank's Hq/M q heads read: a run of
    whole groups, or the one head that a run inside a group reads.  Q
    head h reads kv head h // G, G = Hq / Hkv."""
    tp = current_tp()
    Hkv = k.shape[2]
    G, hl = num_heads // Hkv, num_heads // tp.size
    q0 = tp.rank * hl
    if hl % G == 0:
        sel = slice(q0 // G, (q0 + hl) // G)
    elif G % hl == 0:
        sel = slice(q0 // G, q0 // G + 1)
    else:
        raise ValueError(f"{hl} q heads per rank split the kv groups of "
                         f"{G} unevenly (Hq {num_heads}, Hkv {Hkv}, M "
                         f"{tp.size})")
    return k[:, :, sel], v[:, :, sel]


def _vocab_range(local: int):
    tp = current_tp()
    return tp.rank * local, (tp.rank + 1) * local


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """``table[tokens]`` where ``table`` may be this rank's rows
    ``[v0, v1)`` of the embedding: a token outside them reads zeros, and
    the rows are summed over 'model'."""
    if not split(table.shape[0], vocab_size):
        return table[tokens]
    v0, v1 = _vocab_range(table.shape[0])
    mine = (tokens >= v0) & (tokens < v1)
    rows = table[torch.where(mine, tokens - v0, 0)]
    return reduce_from(torch.where(mine[..., None], rows,
                                   torch.zeros((), dtype=rows.dtype,
                                               device=rows.device)))


def vocab_lse_gold(logits: torch.Tensor, labels: torch.Tensor,
                   vocab_size: int) -> tuple:
    """(log-sum-exp, gold logit), each ``[...]``, of fp32 ``logits
    [..., V]`` or of this rank's columns ``[..., V/M]`` of them: the max,
    the sum of exponentials and the owning rank's gold logit each summed
    (the max maximised) over 'model'."""
    labels = labels.long()
    if not split(logits.shape[-1], vocab_size):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    tp = current_tp()
    m = all_reduce(logits.detach().amax(dim=-1), [tp.group],
                   dist.ReduceOp.MAX)
    s = reduce_from(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    v0, v1 = _vocab_range(logits.shape[-1])
    mine = (labels >= v0) & (labels < v1)
    g = torch.gather(logits, -1,
                     torch.where(mine, labels - v0, 0)[..., None])[..., 0]
    gold = reduce_from(torch.where(mine, g, torch.zeros((), dtype=g.dtype,
                                                        device=g.device)))
    return m + torch.log(s), gold


def vocab_argmax(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """``argmax(logits, -1)`` as int32 over the whole vocabulary, of
    ``logits`` or of this rank's columns of them: each rank's max and
    first index of it, then the lowest index holding the global max, as
    ``argmax`` breaks ties."""
    if not split(logits.shape[-1], vocab_size):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    tp = current_tp()
    val, idx = torch.max(logits, dim=-1)
    top = all_reduce(val, [tp.group], dist.ReduceOp.MAX)
    v0, _ = _vocab_range(logits.shape[-1])
    cand = torch.where(val == top, idx + v0,
                       torch.full_like(idx, vocab_size))
    return all_reduce(cand, [tp.group], dist.ReduceOp.MIN).to(torch.int32)
