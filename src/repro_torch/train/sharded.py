"""The train step on a mesh: the JAX launcher's sharded step
(``launch/train.py`` there jits ``build_train_step`` with
``train_shardings`` and GSPMD partitions it), as explicit collectives
over a ``DeviceMesh``, one process per rank.

The state follows the rule tables of ``launch/sharding.py``: each
parameter is a DTensor at its ``param_specs(kind="train")`` placement,
each AdamW moment at its ``zero1_opt_specs`` placement, and each rank
takes its rows of the global batch by ``batch_specs``.  One step:

1. takes the leaves the tensor-parallel compute splits
   (``launch/sharding.py::tp_leaves``: the attention blocks' ``wq`` /
   ``wk`` / ``wv`` / ``wo``, the MLPs' ``wi_*`` / ``wo``, the Mamba2
   layers' ``out_proj`` / ``norm_w`` / ``dt_bias`` / ``A_log`` / ``D``,
   the embedding and LM head) as this rank's shard over 'model', and
   under expert
   parallelism the expert leaves as this rank's shards; gathers every
   other leaf whole;
2. computes the loss and its gradients on the rank's batch shard under
   ``tp_mesh_context`` (``models/tp.py``: column- and row-parallel
   products, the vocab-parallel embedding and CE; no ``[B, S, V]``
   logits), the CE weighted by the shard's share of the global batch's
   counted tokens (``lm_loss`` divides by the tokens it counts), not a
   plain mean of the shards' means.  With ``tc.microbatch`` set, as the
   JAX step's reshape to ``(n, microbatch)``: microbatch j is the global
   rows ``[j mb, (j + 1) mb)``, each data rank takes an equal share of
   them (a ``ValueError`` where mb does not split evenly), each
   microbatch's CE is the token-weighted mean over its own tokens on all
   data ranks, the fp32 gradients are summed over the n microbatches and
   divided by n, and the metrics are the microbatches' mean;
3. sums every leaf's gradient over the batch's axes, which gives the
   gradient of the global batch's loss (the expert shards' and the
   router's come out of ``moe_ffn_ep``'s backward already summed over
   the token shards, as ``shard_map``'s do).  Over 'model' it sums only
   the gathered leaves whose consumer saw this rank's heads alone:
   ``q_norm`` / ``k_norm`` of a split attention block, ``wk`` / ``wv``
   where M does not divide the kv heads (each rank computes every kv
   head and reads its q heads' ones), and a split Mamba2 layer's
   ``in_proj`` / ``conv_w`` / ``conv_b`` (each rank takes its heads'
   columns and B and C: its gradient is zero off those, and B's and C's
   are its heads' partials).  The norms', the router's and
   the other replicated leaves' gradients are already the same on every
   model rank (their consumers' inputs enter the split blocks through
   ``copy_to``, whose backward sums over 'model');
4. clips by the global norm, the squares of the tensor-parallel shards
   summed over 'model' and the expert shards' over the mesh;
5. updates this rank's ZeRO-1 slice of the moments and parameters (a
   split leaf's slice taken from its local shard);
6. gathers the updated slices back to each parameter's placement.

That is one gather of the leaves computed whole and one reduce of
gradients per step, outside the layer loop (``zero1_opt_specs``), and
inside it the tensor-parallel all-reduces: per attention or MLP block
one forward (``wo``'s partial sums) and one backward (its input's
gradient); per Mamba2 layer two forward (the gated norm's sum of
squares, ``out_proj``'s partial sums) and two backward (the norm's
second sum, its input's gradient); and the embedding's and the CE's.

**What stays gathered** (a deliberate difference from the JAX package,
whose GSPMD may split these too): the norms and the router (small, and
replicated by the rule table); a Mamba2 layer's ``in_proj``, ``conv_w``
and ``conv_b`` (stored as column runs across the packed ``[z | x | B |
C | dt]`` boundaries: gathered, and each rank computes with its heads'
columns, B and C whole); a Mamba2 layer whose heads M does not divide,
or with more than one group, whole; leaves ``fix_spec`` leaves whole or
splits mid-head (whisper's 51,866-token vocabulary at M = 4, an
attention block whose q heads M does not divide); and the experts
without expert parallelism.  The MoE family
without expert parallelism routes each data shard's tokens on its own,
so its capacity and aux loss are per shard, as under expert
parallelism, where JAX's dense path routes the global batch.
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch.sharding import NamedSharding, P, tp_leaves
from repro_torch.models.moe_ep import ep_mesh_context
from repro_torch.models.tp import tp_mesh_context
from repro_torch.train import optim
from repro_torch.train.step import build_loss_fn, value_and_grad
from repro_torch.utils.tree import (flatten_with_paths, tree_map,
                                    tree_unflatten)

#: the expert leaves expert parallelism computes on this rank's shards
EXPERT_LEAVES = ("moe/w_gate", "moe/w_up", "moe/w_down")


def local_block(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` at ``sharding``'s
    placements (``torch.chunk`` per sharded dim, mesh dims major to
    minor, as DTensor lays shards out); no communication."""
    mesh, sizes = sharding.mesh, sharding.mesh.mesh.shape
    coord = mesh.get_coordinate()
    out = t
    for dim in range(t.ndim):
        n, idx = 1, 0
        for j, pl in enumerate(sharding.placements):
            if isinstance(pl, Shard) and pl.dim == dim:
                n, idx = n * sizes[j], idx * sizes[j] + coord[j]
        if n > 1:
            out = out.chunk(n, dim)[idx]
    # a block must not keep the whole tensor's storage alive
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def distribute(t: torch.Tensor, sharding) -> DTensor:
    """``t``, the same whole tensor on every rank, as a DTensor at
    ``sharding``."""
    return DTensor.from_local(local_block(t, sharding), sharding.mesh,
                              sharding.placements, run_check=False)


def shard_state(params, opt: optim.OptState, shardings):
    """The whole ``params`` and ``opt`` (the same on every rank: drawn
    from one seed) as DTensors at ``shardings``' placements."""
    return (tree_map(distribute, params, shardings["params"]),
            tree_map(distribute, opt, shardings["opt"]))


def gather(t: DTensor, axes=None) -> torch.Tensor:
    """This rank's block of ``t`` with its shards over the mesh axes
    ``axes`` (default: every axis) gathered, by ``all_gather`` over each
    axis's group, the minor axes first (DTensor lays blocks out major to
    minor; a collective: every rank of those groups must call it).  Not
    DTensor's own gathers: those are functional collectives, which crash
    waiting on a gloo mesh of CUDA tensors (torch 2.11), where ranks
    share a card."""
    mesh, out = t.device_mesh, t.to_local()
    names = mesh.mesh_dim_names
    for j in reversed(range(len(names))):
        pl = t.placements[j]
        if isinstance(pl, Shard) and (axes is None or names[j] in axes):
            g = mesh.get_group(names[j])
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, out.contiguous(), group=g)
            out = torch.cat(parts, dim=pl.dim)
    return out


def gather_state(tree):
    """Every DTensor leaf of ``tree`` whole (a collective: every rank of
    the mesh must call it)."""
    return tree_map(lambda t: gather(t) if isinstance(t, DTensor) else t,
                    tree)


def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _parts(part) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def without_axis(sharding, axis: str) -> NamedSharding:
    """``sharding`` with ``axis`` taken out of its spec."""
    def drop(part):
        if isinstance(part, tuple):
            rest = tuple(a for a in part if a != axis)
            return rest if len(rest) > 1 else (rest[0] if rest else None)
        return None if part == axis else part
    return NamedSharding(sharding.mesh, P(*(drop(x) for x in sharding.spec)))


def model_shard(p: DTensor) -> torch.Tensor:
    """This rank's shard of ``p`` over 'model' alone: gathered over every
    other mesh axis it is split over (none, but under FSDP)."""
    return gather(p, [n for n in p.device_mesh.mesh_dim_names
                      if n != "model"])


def tp_state(cfg: ModelConfig, shardings: Dict):
    """(the paths of ``shardings``' parameters computed on this rank's
    shard over 'model', the replicated ones whose gradients sum over
    'model'): ``launch.sharding.tp_leaves`` of their specs."""
    pshard = dict(flatten_with_paths(shardings))
    return tp_leaves(cfg, {p: s.spec for p, s in pshard.items()},
                     next(iter(pshard.values())).mesh)


def build_sharded_train_step(cfg: ModelConfig, tc: TrainConfig,
                             shardings: Dict, *, ep: bool = False,
                             tp_dispatch: bool = False) -> Callable:
    """(params, opt_state, global batch) -> (params, opt_state, metrics),
    the state DTensors at ``shardings`` (``launch.sharding.
    train_shardings``), every rank passing the same global batch (or,
    without ``tc.microbatch``, each leaf a DTensor at the batch's
    placement).  ``ep``: the MoE layers run ``moe_ffn_ep`` on the mesh
    (``tp_dispatch``: its dispatch split over 'model' too).  The metrics
    are the global batch's (``ce_loss``, ``tokens``, ``aux_loss``,
    ``total_loss``; with ``tc.microbatch`` the microbatches' means) with
    ``grad_norm`` and ``lr``."""
    mesh = shardings["metrics"].mesh
    names = mesh.mesh_dim_names
    loss_fn = build_loss_fn(cfg)
    pshard = dict(flatten_with_paths(shardings["params"]))
    zshard = dict(flatten_with_paths(shardings["opt"].m))
    bshard = shardings["batch"]
    rows = bshard["tokens"].spec[0]
    daxes = () if rows is None else (
        rows if isinstance(rows, tuple) else (rows,))
    dgroups = [mesh.get_group(a) for a in daxes]
    n_data = 1
    for g in dgroups:
        n_data *= dist.get_world_size(g)
    everywhere = [mesh.get_group(a) for a in names]
    mgroups = [mesh.get_group("model")] if "model" in names else []
    local = {p for p in pshard if ep and p.endswith(EXPERT_LEAVES)}
    reduced = local | {p for p in pshard
                       if ep and p.endswith("moe/w_router")}
    tp_local, tp_summed = tp_state(cfg, shardings["params"])
    for p in tp_local:
        dims = [i for i, x in enumerate(pshard[p].spec) if x == "model"]
        zspec = zshard[p].spec
        if [i for i, x in enumerate(zspec) if "model" in _parts(x)] != dims \
                or any(zspec[i] != "model" for i in dims):
            raise ValueError(f"{p}: its moments must keep the leaf's "
                             f"'model' dim alone (spec {pshard[p].spec}, "
                             f"moments {zspec})")
    extra = ()
    if ep:
        if "data" not in daxes:
            raise ValueError(f"expert parallelism needs the batch's rows "
                             f"sharded over 'data' (rows over {daxes})")
        for p in local:
            spec = pshard[p].spec
            if {"data", "model"} - set(spec) or zshard[p].spec != spec:
                raise ValueError(f"{p}: expert parallelism needs E split "
                                 f"over 'data' and f over 'model', its "
                                 f"moments as the leaf (spec {spec}, "
                                 f"moments {zshard[p].spec})")
        extra = tuple(a for a in daxes if a != "data")

    def ctx():
        stack = ExitStack()
        stack.enter_context(tp_mesh_context(mesh))
        if ep:
            stack.enter_context(ep_mesh_context(
                mesh, extra_batch_axes=extra, tp_dispatch=tp_dispatch))
        return stack
    w = cfg.router_aux_weight

    def micro_grads(params, compute, mb):
        """The loss and gradients of the global rows ``mb``: this rank's
        block of them, its CE weighted by its share of their counted
        tokens over the data ranks."""
        lb = {k: v.to_local() if isinstance(v, DTensor) else
              local_block(v, bshard[k]) for k, v in mb.items()}
        mask = lb.get("loss_mask")
        cnt = (mask.float().sum() if mask is not None else torch.tensor(
            float(lb["labels"].numel()), device=lb["labels"].device))
        tokens = _sum_over(cnt, dgroups)
        denom = torch.clamp(tokens, min=1.0)

        def shard_loss(ps, b):
            _, m = loss_fn(ps, b)
            ce = m["ce_loss"] * torch.clamp(m["tokens"], min=1.0) / denom
            aux = m["aux_loss"] if ep else m["aux_loss"] / n_data
            return ce + w * aux, dict(m, ce_share=ce, aux_share=aux)

        with ctx():
            (_, m), grads = value_and_grad(shard_loss, tree_unflatten(
                params, compute), lb)
        ce = _sum_over(m["ce_share"].clone(), dgroups)
        aux = m["aux_loss"] if ep else _sum_over(m["aux_share"].clone(),
                                                 dgroups)
        metrics = {"ce_loss": ce, "tokens": tokens, "aux_loss": aux,
                   "total_loss": ce + w * aux}
        return [g for _, g in flatten_with_paths(grads)], metrics

    def compute_leaves(params):
        """The tensors the step computes with, one per leaf of
        ``params`` in ``flatten_with_paths`` order: this rank's shard of
        a split leaf (over 'model'; an expert's under expert
        parallelism), every other leaf whole."""
        return [p.to_local() if path in local else
                model_shard(p) if path in tp_local else gather(p)
                for path, p in flatten_with_paths(params)]

    def step(params, opt_state, batch):
        B, mbs = batch["tokens"].shape[0], tc.microbatch
        if mbs and (B % mbs or mbs % n_data):
            raise ValueError(
                f"microbatch {mbs} must divide the global batch {B} and "
                f"split evenly over the {n_data} data ranks")
        if mbs and isinstance(batch["tokens"], DTensor):
            raise ValueError("a microbatched step takes the global batch, "
                             "not DTensors")
        flat = flatten_with_paths(params)
        compute = compute_leaves(params)
        if mbs:
            # JAX's reshape to (n, mb): microbatch j is the global rows
            # [j mb, (j + 1) mb), each data rank taking an equal share
            n = B // mbs
            grads, ms = None, []
            for j in range(n):
                g, m = micro_grads(params, compute, {
                    k: v[j * mbs:(j + 1) * mbs] for k, v in batch.items()})
                grads = ([x.float() for x in g] if grads is None else
                         [a.add_(b.float()) for a, b in zip(grads, g)])
                ms.append(m)
            m = {k: torch.mean(torch.stack([x[k] for x in ms]), dim=0)
                 for k in ms[0]}
        else:
            grads, m = micro_grads(params, compute, batch)
            n = 1
        paths = [path for path, _ in flat]
        grads = [g if path in reduced else _sum_over(
            g, dgroups + (mgroups if path in tp_summed else []))
            for path, g in zip(paths, grads)]
        if n > 1:
            grads = [g / n for g in grads]
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        sq = [_sum_over(s, everywhere) if path in local else
              _sum_over(s, mgroups) if path in tp_local else s
              for path, s in zip(paths, sq)]
        gnorm = torch.sqrt(torch.sum(torch.stack(sq)))

        def zero1(path, t):
            # a split leaf's slice of its own shard: ZeRO-1 adds the data
            # axes to another dim than 'model''s
            return t if path in local else local_block(
                t, without_axis(zshard[path], "model")
                if path in tp_local else zshard[path])
        p_sl = [zero1(path, c) for path, c in zip(paths, compute)]
        g_sl = [zero1(path, g) for path, g in zip(paths, grads)]
        del compute, grads
        state = optim.OptState(
            m=tree_map(lambda t: t.to_local(), opt_state.m),
            v=tree_map(lambda t: t.to_local(), opt_state.v),
            count=opt_state.count.to_local())
        new_p, new_s, om = optim.adamw_update(
            tree_unflatten(params, p_sl), tree_unflatten(params, g_sl),
            state, tc, norm=gnorm)

        def moment(path, t):
            return DTensor.from_local(t, mesh, zshard[path].placements,
                                      run_check=False)

        def relayout(path, t):
            # ZeRO-1's slice gathered back over the axes the moments add
            z, want = moment(path, t), pshard[path].placements
            return DTensor.from_local(gather(z, [
                n for n, a, b in zip(names, z.placements, want) if a != b]),
                mesh, want, run_check=False)
        params = tree_unflatten(params, [
            relayout(path, t)
            for path, (_, t) in zip(paths, flatten_with_paths(new_p))])
        opt_state = optim.OptState(
            m=tree_unflatten(opt_state.m, [moment(path, t) for path, t in
                                           flatten_with_paths(new_s.m)]),
            v=tree_unflatten(opt_state.v, [moment(path, t) for path, t in
                                           flatten_with_paths(new_s.v)]),
            count=DTensor.from_local(new_s.count, mesh,
                                     shardings["opt"].count.placements,
                                     run_check=False))
        return params, opt_state, dict(m, **om)

    # the parts of a step the tests and the step analyzer look into: the
    # compute tensors of a state, the context the loss runs under, and
    # which leaves compute on shards
    step.compute_leaves, step.context = compute_leaves, ctx
    step.tp_leaves = (tp_local, tp_summed)
    return step
