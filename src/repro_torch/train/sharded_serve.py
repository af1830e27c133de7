"""The serving steps on a mesh: the counterparts of the JAX dry-run's
``build_prefill_step`` and ``build_serve_step`` jitted under
``serve_shardings`` and ``cache_specs`` (``launch/dryrun.py`` there), as
explicit collectives over a ``DeviceMesh``, one process per rank.

The parameters are DTensors at ``serve_shardings``' placements, the
cache DTensors at ``cache_specs``'.  Each rank takes its rows of the
global batch (the token's spec) and computes under ``tp_mesh_context``
(``models/tp.py``): the leaves ``launch/sharding.py::tp_leaves`` names
as its shard over 'model', every other leaf gathered whole.  The KV
cache is held as this rank's rows and heads, ``[L, B/D, S, Hkv/M, hd]``,
written in place by the decode step; the Mamba2 states, which the Mamba2
layers compute whole, are gathered over 'model' for each step and split
again after it.  The logits are vocab-parallel (``serve_shardings``'
``P(batch, None, "model")``), and greedy sampling runs over them
(``tp.vocab_argmax``: a local max and argmax, then the lowest index
holding the global max).

Where ``cache_specs`` splits the KV cache over the sequence (M does not
divide Hkv), the steps raise a ``ValueError``: merging the ranks'
partial attention needs the decode kernel's log-sum-exp, a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import model_axis_size
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.models import model as model_lib
from repro_torch.models.tp import tp_mesh_context, vocab_argmax
from repro_torch.train.sharded import (gather, local_block, model_shard,
                                       tp_state)
from repro_torch.utils.tree import flatten_with_paths, tree_unflatten

def _is_kv(name: str) -> bool:
    """A KV leaf of the cache (``k``, ``v``, ``cross_k``, ``local_v``,
    ...), as ``cache_specs`` names them."""
    return name in ("k", "v") or name.endswith(("_k", "_v"))


def _check_cache(cfg: ModelConfig, shardings: Dict) -> None:
    M = model_axis_size(shardings["token"].mesh)
    for path, sh in flatten_with_paths(shardings["cache"]):
        if _is_kv(path) and M > 1 and sh.spec[3] != "model":
            raise ValueError(
                f"cache {path}: spec {sh.spec} does not split its "
                f"{cfg.num_kv_heads} kv heads over the {M} model ranks "
                f"(Hkv % M != 0 takes cache_specs' sequence split, whose "
                f"partial attention the decode kernel's log-sum-exp will "
                f"merge in a later slice of the port)")


class _Plan:
    """What a step of ``shardings`` computes with, and how its results go
    back to their placements."""

    def __init__(self, cfg: ModelConfig, shardings: Dict):
        _check_cache(cfg, shardings)
        self.cfg = cfg
        self.mesh = shardings["token"].mesh
        self.rows = shardings["token"].spec[0]
        self.tp_local, _ = tp_state(cfg, shardings["params"])
        self.cshard = dict(flatten_with_paths(shardings["cache"]))

    def params(self, params):
        return tree_unflatten(params, [
            model_shard(p) if path in self.tp_local else gather(p)
            for path, p in flatten_with_paths(params)])

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch leaf (or the local tensor of
        a DTensor at the token's placement)."""
        if isinstance(t, DTensor):
            return t.to_local()
        return local_block(t, NamedSharding(
            self.mesh, P(self.rows, *([None] * (t.ndim - 1)))))

    def cache_in(self, cache: Dict) -> Dict:
        """The rank's cache (a flat dict, as ``init_cache`` makes it): the
        KV leaves and ``len`` as held, the Mamba2 states gathered over
        'model'."""
        return {name: t.to_local() if _is_kv(name) or t.ndim == 0
                else gather(t, ["model"]) for name, t in cache.items()}

    def cache_out(self, cache: Dict) -> Dict:
        """The rank's new cache as DTensors at the cache's placements
        (the Mamba2 states split over 'model' again)."""
        out = {}
        for path, t in cache.items():
            sh = self.cshard[path]
            if not (_is_kv(path) or t.ndim == 0):
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
                               shardings: Dict) -> Callable:
    """(params, global batch {"tokens": [B, S], ...}) -> (last logits
    [B, 1, V] at ``P(batch, None, "model")``, cache at ``shardings
    ["cache"]``), every rank passing the same global batch; ``shardings``
    is ``launch.sharding.serve_shardings``."""
    plan = _Plan(cfg, shardings)

    def prefill_step(params, batch):
        ps = plan.params(params)
        lb = {k: plan.local_rows(v) for k, v in batch.items()}
        with tp_mesh_context(plan.mesh):
            logits, cache = model_lib.prefill(ps, cfg, lb, max_len)
        return plan.logits_out(logits), plan.cache_out(cache)
    return prefill_step


def build_sharded_decode_step(cfg: ModelConfig, shardings: Dict
                              ) -> Callable:
    """(params, cache, token [B, 1]) -> (logits [B, 1, V] at ``P(batch,
    None, "model")``, cache); ``token`` the global tokens or a DTensor at
    the token's placement.  The KV leaves are written in place."""
    plan = _Plan(cfg, shardings)

    def decode_step(params, cache, token):
        ps = plan.params(params)
        with tp_mesh_context(plan.mesh):
            logits, nc = model_lib.decode_step(
                ps, cfg, plan.cache_in(cache), plan.local_rows(token))
        return plan.logits_out(logits), plan.cache_out(nc)
    return decode_step


def build_sharded_serve_step(cfg: ModelConfig, shardings: Dict
                             ) -> Callable:
    """The dry-run's decode entry on the mesh: (params, token [B, 1],
    cache) -> (next token [B, 1] int32 at the token's placement, cache),
    greedy over the vocab-parallel logits."""
    decode = build_sharded_decode_step(cfg, shardings)

    def serve_step(params, token, cache):
        logits, cache = decode(params, cache, token)
        return greedy(logits, cfg), cache
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
