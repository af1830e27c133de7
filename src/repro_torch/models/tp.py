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
    (``vocab_lse_gold``) and greedy sampling (``vocab_argmax``);
  * the Mamba2 layers, where M divides the SSM heads (and G = 1): this
    rank's H/M heads, from its columns of ``in_proj`` and of the conv
    (``mamba_columns``: ``[z_r | x_r | B | C | dt_r]`` and ``[x_r | B |
    C]``, B and C whole on every rank), its rows of ``out_proj`` (row-
    parallel, ``reduce_from``) and its shards of ``norm_w``, ``dt_bias``,
    ``A_log`` and ``D``; the gated norm's sum of squares over the whole
    ``d_inner`` is summed over 'model' by ``model_summer``'s function,
    whose backward sums too (each rank's sum feeds only its own
    columns).

The serving steps' KV cache lies over 'model' as ``cache_specs`` lays
it and the steps declare (``kv_layout``): by heads where M divides Hkv
(each rank writes and reads its heads), else by sequence (each rank
holds every kv head of its ``S/M`` slots: a decode step gathers the q
heads over 'model' (``gather_heads``), attends every head over the
rank's slots with the decode kernel's log-sum-exp, and merges the
ranks' partials (``merge_partials``)), or whole where M divides
neither.

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
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

_ctx = threading.local()


class TPInfo(NamedTuple):
    mesh: object
    group: object       # the 'model' process group of this rank
    size: int           # M
    rank: int           # this rank's index on 'model'
    kv: Dict[str, str]  # declared KV cache layouts, by kind (kv_layout)


@contextmanager
def tp_mesh_context(mesh, model_axis: str = "model",
                    kv: Optional[Dict[str, str]] = None):
    """Declare the ``DeviceMesh`` whose ``model_axis`` the dense blocks
    split over, and (``kv``) how the KV cache ``[L, B, S, Hkv, hd]`` lies
    over it, by kind: "self" (the self-attention caches) and "cross"
    (whisper's), each "heads", "sequence" or "whole".  A mesh without
    that axis, or with one rank on it, declares nothing."""
    prev = getattr(_ctx, "info", None)
    info = None
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if model_axis in names:
        group = mesh.get_group(model_axis)
        size = dist.get_world_size(group)
        if size > 1:
            info = TPInfo(mesh, group, size, dist.get_rank(group),
                          dict(kv or {}))
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


class _AllReduce(torch.autograd.Function):
    """Summed over ``groups`` forward and backward: the sum every rank
    takes feeds only that rank's own outputs, so the gradient of each
    rank's summand is the sum of every rank's gradient of the sum."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.groups), None


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


def model_summer():
    """A function that sums a tensor over 'model' forward and backward
    (``_AllReduce``: a sum each rank then uses for its own shard, the
    gated norm's sum of squares), bound to the context's group when
    ``model_summer`` is called; the identity outside the context.  Bound,
    it still sums where an autograd Function's backward calls it on
    autograd's own thread, which does not see the thread-local context
    (a CUDA backward runs there)."""
    tp = current_tp()
    if tp is None:
        return _identity
    groups = [tp.group]
    return lambda x: _AllReduce.apply(x, groups)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def mamba_columns(rank: int, M: int, dims: dict) -> tuple:
    """Rank ``rank`` of M's share of a Mamba2 layer split by heads, for
    the whole layer's ``dims`` (``models/ssm.py::mamba2_dims``; G = 1):
    (the runs of ``in_proj``'s columns ``[z_r | x_r | B | C | dt_r]``,
    the runs of the conv's channels ``[x_r | B | C]``), each run a
    ``(start, stop)`` pair, in the order the local layer packs them.
    Head block r is heads ``[r H/M, (r + 1) H/M)``: z and x columns
    ``r d_inner/M`` on, dt column ``r H/M`` on; B and C are whole."""
    di, H, gn = dims["di"], dims["H"], dims["G"] * dims["N"]
    w, h = di // M, H // M
    xr = (rank * w, (rank + 1) * w)
    dt0 = 2 * di + 2 * gn
    cols = (xr, (di + xr[0], di + xr[1]), (2 * di, dt0),
            (dt0 + rank * h, dt0 + (rank + 1) * h))
    return cols, (xr, (di, di + 2 * gn))


def take_columns(t: torch.Tensor, runs) -> torch.Tensor:
    """The last dim's ``runs`` of ``t`` (``mamba_columns``), side by
    side: one ``index_select``, whose gradient is one tensor of ``t``'s
    shape with those columns filled."""
    idx = torch.cat([torch.arange(a, b, device=t.device) for a, b in runs])
    return torch.index_select(t, -1, idx)


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


def kv_layout(kind: str) -> Optional[str]:
    """How the KV cache of ``kind`` ("self" or "cross") lies over 'model'
    under the context: "heads", "sequence" or "whole", as the sharded
    serving steps declare it from ``cache_specs`` (a rank's cache slice
    cannot tell a sequence split from a whole cache by its shape).  None
    outside the context or where nothing is declared (the train step has
    no cache)."""
    tp = current_tp()
    return None if tp is None else tp.kv.get(kind)


def seq_range(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's range of ``t``'s ``dim`` of the whole sequence, a copy
    of its own (the cache a rank holds under a sequence split)."""
    tp = current_tp()
    return t.chunk(tp.size, dim)[tp.rank].contiguous()


def gather_heads(q: torch.Tensor) -> torch.Tensor:
    """The q heads ``[B, S, Hq/M, hd]`` of every rank, gathered over
    'model' in rank order into ``[B, S, Hq, hd]`` (forward only: the
    serving steps' decode over a sequence-split cache)."""
    tp = current_tp()
    parts = [torch.empty_like(q) for _ in range(tp.size)]
    dist.all_gather(parts, q.contiguous(), group=tp.group)
    return torch.cat(parts, dim=2)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, heads_split: bool
                   ) -> torch.Tensor:
    """The attention of every rank's slots from this rank's partial ``o``
    ``[B, 1, Hq, hd]`` over its own slots and its log-sum-exp ``lse``
    ``[B, Hq]`` (fp32, -inf where it attends none): ``sum_r w_r o_r /
    sum_r w_r``, ``w_r = exp(lse_r - max_r lse_r)``, in fp32, a rank at
    -inf weighing exactly 0, in o's dtype.  ``heads_split``: this rank
    keeps its own Hq/M heads, and each rank receives only those heads'
    partials, by one ``all_to_all_single`` of ``[M, B, Hq/M, hd + 1]``;
    else every rank keeps every head (its ``wo`` is whole), by one
    ``all_gather`` of ``[B, Hq, hd + 1]``.  Forward only."""
    tp = current_tp()
    M = tp.size
    B, _, Hq, hd = o.shape
    packed = torch.cat([o.reshape(B, Hq, hd).float(), lse[..., None]], -1)
    if heads_split:
        send = packed.reshape(B, M, Hq // M, hd + 1).transpose(0, 1)
        parts = torch.empty_like(send, memory_format=torch.contiguous_format)
        dist.all_to_all_single(parts, send.contiguous(), group=tp.group)
    else:
        chunks = [torch.empty_like(packed) for _ in range(M)]
        dist.all_gather(chunks, packed, group=tp.group)
        parts = torch.stack(chunks)
    out = merge_lse(parts[..., :hd], parts[..., hd])
    return out.reshape(B, 1, -1, hd).to(o.dtype)


def merge_lse(po: torch.Tensor, pl: torch.Tensor) -> torch.Tensor:
    """The partials ``po`` ``[M, ..., hd]`` over M slot ranges merged by
    their log-sum-exps ``pl`` ``[M, ...]``: ``sum_r w_r po_r / sum_r
    w_r``, ``w_r = exp(pl_r - max_r pl_r)``, in fp32, a range at -inf
    weighing exactly 0 (zeros where every range is at -inf)."""
    po, pl = po.float(), pl.float()
    w = torch.where(pl == -torch.inf, 0.0, torch.exp(pl - pl.amax(0)))
    den = w.sum(0)
    return (w[..., None] * po).sum(0) / torch.where(den > 0, den,
                                                    1.0)[..., None]


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
