"""The serving steps on a mesh: the counterparts of the JAX dry-run's
``build_prefill_step`` and ``build_serve_step`` jitted under
``serve_shardings`` and ``cache_specs`` (``launch/dryrun.py`` there), as
explicit collectives over a ``DeviceMesh``, one process per rank.

The parameters are DTensors at ``serve_shardings``' placements, the
cache DTensors at ``cache_specs``'.  Each rank takes its rows of the
global batch (the token's spec) and computes under ``tp_mesh_context``
(``models/tp.py``): the leaves ``launch/sharding.py::tp_leaves`` names
as its shard over 'model', every other leaf gathered whole.  The KV
cache is held as this rank's rows and its share over 'model' (below),
written in place by the decode step.  Where the Mamba2 layers split by
heads (``tp_leaves``), the SSM state stays as ``cache_specs`` holds it,
the rank's heads ``[L, B/D, H/M, P, N]``, and the decode step writes it
in place; the conv state, stored as contiguous channel runs that cross
the packed ``[x | B | C]`` boundaries, is gathered over 'model' and cut
to the rank's channels ``[x_r | B | C]`` (``tp.mamba_columns``) on the
way in, and on the way out the ranks' ``x_r`` channels are gathered
(B and C are the same on every rank) and the stored runs cut again.
Where they compute whole, both states are gathered over 'model' for
each step and split again after it.  The logits are vocab-parallel
(``serve_shardings``' ``P(batch, None, "model")``), and greedy sampling
runs over them (``tp.vocab_argmax``: a local max and argmax, then the
lowest index holding the global max).

The KV cache lies as ``cache_specs`` lays it over 'model', and the steps
declare that layout to the model (``tp_mesh_context(kv=...)``, one per
kind: the self-attention caches and whisper's cross-attention cache):
by heads where M divides Hkv (``[L, B/D, S, Hkv/M, hd]``); by sequence
where M does not divide Hkv but divides the slots (``[L, B/D, S/M,
Hkv, hd]``: every kv head of the rank's slot range; the rank that owns
the token's slot writes it, and the ranks' partial attention over their
ranges is merged by the decode kernel's log-sum-exp, ``models/tp.py``);
or whole where ``fix_spec`` drops both splits (each rank writes every
kv head and reads its q heads' ones).  The merge sums the ranks'
partials in rank order, where GSPMD's partitioned softmax sums in its
own order: the same function, equal within f32 rounding.
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.models import model as model_lib
from repro_torch.models.moe_ep import ep_mesh_context
from repro_torch.models.ssm import mamba2_dims
from repro_torch.models.tp import (mamba_columns, take_columns,
                                   tp_mesh_context, vocab_argmax)
from repro_torch.train.sharded import (EXPERT_LEAVES, gather,
                                       local_block, model_shard, tp_state)
from repro_torch.utils.tree import flatten_with_paths, tree_unflatten

def _is_kv(name: str) -> bool:
    """A KV leaf of the cache (``k``, ``v``, ``cross_k``, ``local_v``,
    ...), as ``cache_specs`` names them."""
    return name in ("k", "v") or name.endswith(("_k", "_v"))


def kv_layouts(shardings: Dict) -> Dict[str, str]:
    """How ``shardings``' KV cache lies over 'model', by kind ("self",
    "cross"; the leaves of one kind share their shape, so their specs):
    "heads" where its spec splits the kv heads, "sequence" where it
    splits the slots, else "whole"."""
    return {"cross" if path.startswith("cross") else "self":
            "heads" if sh.spec[3] == "model" else
            "sequence" if sh.spec[2] == "model" else "whole"
            for path, sh in flatten_with_paths(shardings["cache"])
            if _is_kv(path)}


class _Plan:
    """What a step of ``shardings`` computes with, and how its results go
    back to their placements."""

    def __init__(self, cfg: ModelConfig, shardings: Dict, ep: bool = False,
                 tp_dispatch: bool = False):
        self.cfg = cfg
        self.mesh = shardings["token"].mesh
        self.rows = shardings["token"].spec[0]
        self.tp_local, _ = tp_state(cfg, shardings["params"])
        self.cshard = dict(flatten_with_paths(shardings["cache"]))
        # the Mamba2 layers compute this rank's heads: its conv channels
        self.chans = None
        if any(p.endswith("mamba/out_proj") for p in self.tp_local):
            g = self.mesh.get_group("model")
            self.model_group = g
            self.chans = mamba_columns(dist.get_rank(g),
                                       dist.get_world_size(g),
                                       mamba2_dims(cfg))[1]
        self.kv = kv_layouts(shardings)
        self.ep = None
        if ep:
            rows = self.rows if isinstance(self.rows, tuple) else (
                () if self.rows is None else (self.rows,))
            if "data" not in rows:
                raise ValueError(f"expert parallelism needs the batch's "
                                 f"rows sharded over 'data' (rows over "
                                 f"{self.rows})")
            self.ep = (tuple(a for a in rows if a != "data"), tp_dispatch)

    def context(self):
        """The model's context: the mesh's 'model' axis, the cache's
        layout over it and, with expert parallelism, the mesh the MoE
        layers dispatch over (``moe_ffn_ep``)."""
        stack = ExitStack()
        stack.enter_context(tp_mesh_context(self.mesh, kv=self.kv))
        if self.ep is not None:
            stack.enter_context(ep_mesh_context(
                self.mesh, extra_batch_axes=self.ep[0],
                tp_dispatch=self.ep[1]))
        return stack

    def params(self, params):
        """The tensors the step computes with: this rank's shard of a leaf
        ``tp_leaves`` splits (and of an expert leaf, with expert
        parallelism), every other leaf gathered whole."""
        return tree_unflatten(params, [
            p.to_local() if self.ep is not None
            and path.endswith(EXPERT_LEAVES) else
            model_shard(p) if path in self.tp_local else gather(p)
            for path, p in flatten_with_paths(params)])

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch leaf (or the local tensor of
        a DTensor at the token's placement)."""
        if isinstance(t, DTensor):
            return t.to_local()
        return local_block(t, NamedSharding(
            self.mesh, P(self.rows, *([None] * (t.ndim - 1)))))

    def _held(self, name: str) -> bool:
        """Whether the step computes with the rank's block of cache leaf
        ``name`` as held: the KV leaves, ``len``, and the SSM state where
        the Mamba2 layers split by heads."""
        return _is_kv(name) or name == "len" or (
            name == "ssm" and self.chans is not None)

    def cache_in(self, cache: Dict) -> Dict:
        """The rank's cache (a flat dict, as ``init_cache`` makes it): the
        KV leaves (its heads, its slot range or whole) and ``len`` as
        held; the SSM state as held (its heads) where the Mamba2 layers
        split, else gathered over 'model'; the conv state gathered over
        'model' and, where they split, cut to the rank's channels."""
        out = {}
        for name, t in cache.items():
            if self._held(name):
                out[name] = t.to_local()
                continue
            t = gather(t, ["model"])
            if name == "conv" and self.chans is not None:
                t = take_columns(t, self.chans)
            out[name] = t
        return out

    def _whole_conv(self, t: torch.Tensor) -> torch.Tensor:
        """The whole conv state from this rank's channels ``[x_r | B |
        C]``: every rank's x channels (gathered over 'model') in rank
        order, then B and C (the same on every rank)."""
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self.model_group))]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        nx = self.chans[0][1] - self.chans[0][0]
        return torch.cat([p[..., :nx] for p in parts] + [t[..., nx:]], -1)

    def cache_out(self, cache: Dict) -> Dict:
        """The rank's new cache as DTensors at the cache's placements
        (the states computed whole, and the conv state, split over
        'model' again)."""
        out = {}
        for path, t in cache.items():
            sh = self.cshard[path]
            if not self._held(path):
                if path == "conv" and self.chans is not None:
                    t = self._whole_conv(t)
                t = local_block(t, NamedSharding(self.mesh, P(*(
                    "model" if x == "model" else None for x in sh.spec))))
            out[path] = DTensor.from_local(t, self.mesh, sh.placements,
                                           run_check=False)
        return out

    def logits_out(self, logits: torch.Tensor) -> DTensor:
        spec = P(self.rows, None, "model"
                 if logits.shape[-1] != self.cfg.vocab_size else None)
        return DTensor.from_local(logits, self.mesh,
                                  NamedSharding(self.mesh, spec).placements,
                                  run_check=False)


def build_sharded_prefill_step(cfg: ModelConfig, max_len: int,
                               shardings: Dict, *, ep: bool = False,
                               tp_dispatch: bool = False) -> Callable:
    """(params, global batch {"tokens": [B, S], ...}) -> (last logits
    [B, 1, V] at ``P(batch, None, "model")``, cache at ``shardings
    ["cache"]``), every rank passing the same global batch (or each leaf
    a DTensor at the batch's placement); ``shardings`` is
    ``launch.sharding.serve_shardings``.  ``ep``: the MoE layers run
    ``moe_ffn_ep`` on the mesh, on this rank's expert shards
    (``tp_dispatch``: its dispatch split over 'model' too)."""
    plan = _Plan(cfg, shardings, ep, tp_dispatch)

    def prefill_step(params, batch):
        ps = plan.params(params)
        lb = {k: plan.local_rows(v) for k, v in batch.items()}
        with plan.context():
            logits, cache = model_lib.prefill(ps, cfg, lb, max_len)
        return plan.logits_out(logits), plan.cache_out(cache)
    # what the step computes with, for the tests to look into
    prefill_step.plan = plan
    return prefill_step


def build_sharded_decode_step(cfg: ModelConfig, shardings: Dict, *,
                              ep: bool = False, tp_dispatch: bool = False
                              ) -> Callable:
    """(params, cache, token [B, 1]) -> (logits [B, 1, V] at ``P(batch,
    None, "model")``, cache); ``token`` the global tokens or a DTensor at
    the token's placement.  The KV leaves are written in place.  ``ep``
    and ``tp_dispatch`` as for the prefill."""
    plan = _Plan(cfg, shardings, ep, tp_dispatch)

    def decode_step(params, cache, token):
        ps = plan.params(params)
        with plan.context():
            logits, nc = model_lib.decode_step(
                ps, cfg, plan.cache_in(cache), plan.local_rows(token))
        return plan.logits_out(logits), plan.cache_out(nc)
    decode_step.plan = plan
    return decode_step


def build_sharded_serve_step(cfg: ModelConfig, shardings: Dict, *,
                             ep: bool = False, tp_dispatch: bool = False
                             ) -> Callable:
    """The dry-run's decode entry on the mesh: (params, token [B, 1],
    cache) -> (next token [B, 1] int32 at the token's placement, cache),
    greedy over the vocab-parallel logits."""
    decode = build_sharded_decode_step(cfg, shardings, ep=ep,
                                       tp_dispatch=tp_dispatch)

    def serve_step(params, token, cache):
        logits, cache = decode(params, cache, token)
        return greedy(logits, cfg), cache
    serve_step.plan = decode.plan
    return serve_step


def greedy(logits: DTensor, cfg: ModelConfig) -> DTensor:
    """``argmax(logits, -1)`` of a sharded step's vocab-parallel logits, as
    int32 at their rows' placement (the first token after a prefill)."""
    mesh = logits.device_mesh
    with tp_mesh_context(mesh):
        nxt = vocab_argmax(logits.to_local(), cfg.vocab_size)
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else
                 Replicate() for pl in logits.placements)
    return DTensor.from_local(nxt, mesh, rows, run_check=False)
