"""Rule-based partition specs: DP / TP / EP / SP / FSDP, for the port.

The rules and their decisions are the JAX package's
(``launch/sharding.py``), over the port's own spec type ``P``: one entry
per tensor dim, each None, an axis name or a tuple of axis names, with
the meaning of ``jax.sharding.PartitionSpec``.  One rule table covers
every architecture because param-leaf *names* encode their role (wq/wk/
wv/wo, wi_*/w_gate/w_up/w_down, in_proj/out_proj, embed, lm_head, ...).
Stacked ``[L, ...]`` leaves get their leading layer dim padded with None
automatically.

Adaptive choices:
  * KV caches: head-sharded over 'model' when Hkv divides the model axis,
    otherwise sequence-sharded (SP).
  * FSDP: when (param+optimizer) bytes per rank exceed half the device
    memory with TP alone, large leaves additionally shard over the data
    axes.  The budget is the H100's 80 GiB by default (``HBM_BYTES``);
    ``decide_fsdp`` takes another (the JAX package's is a v5e's 16 GiB).
  * Batch: sharded over ('pod','data') when divisible, 'data' when only
    that divides, replicated otherwise.

``to_named`` turns specs into ``NamedSharding``s, whose ``placements``
are the DTensor placements of the spec on the mesh.  ``tp_leaves`` says
which stored leaves the port's tensor-parallel steps compute on this
rank's shard (GSPMD derives that for the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch.mesh import data_axes, mesh_shape, model_axis_size
from repro_torch.utils.tree import (flatten_with_paths, tree_bytes,
                                    tree_map, tree_map_with_path,
                                    tree_unflatten)

HBM_BYTES = 80 * 2 ** 30          # H100 SXM5 80GB
FSDP_MIN_LEAF_BYTES = 16 * 2 ** 20


class P:
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``.
    A leaf of the port's trees (not a tuple), iterable and comparable
    like ``jax.sharding.PartitionSpec``."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


# --- per-leaf base rules: map last path component -> spec (trailing dims) --

_PARAM_RULES = {
    "embed": P("model", None),          # [V, d] vocab-sharded
    "lm_head": P(None, "model"),        # [d, V]
    "wq": P(None, "model"),
    "wk": P(None, "model"),
    "wv": P(None, "model"),
    "wo": P("model", None),             # attn out AND mlp down: [big, d]
    "wi_gate": P(None, "model"),
    "wi_up": P(None, "model"),
    "w_router": P(None, None),
    "w_gate": P("model", None, None),   # [E, d, f] expert-parallel
    "w_up": P("model", None, None),
    "w_down": P("model", None, None),
    "in_proj": P(None, "model"),
    "out_proj": P("model", None),
    "conv_w": P(None, "model"),
    "conv_b": P("model"),
    "dt_bias": P("model"),
    "A_log": P("model"),
    "D": P("model"),
    "norm_w": P("model"),
}
_REPLICATED_SUFFIXES = ("ln_w", "q_norm", "k_norm")

# Expert weights: EP over 'data' (E), Megatron-style TP over 'model' (f).
_EXPERT_RULES = {
    "w_gate": P("data", None, "model"),   # [E, d, f]
    "w_up": P("data", None, "model"),
    "w_down": P("data", "model", None),   # [E, f, d]
}


def _leaf_spec(path: str, ndim: int) -> P:
    name = path.rsplit("/", 1)[-1]
    if any(name.endswith(s) for s in _REPLICATED_SUFFIXES):
        return P()
    rule = _EXPERT_RULES.get(name) or _PARAM_RULES.get(name)
    if rule is None:
        return P()
    pad = ndim - len(rule)
    assert pad >= 0, (path, ndim, rule)
    return P(*([None] * pad + list(rule)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh).shape
    if isinstance(axis, (tuple, list)):
        return int(np.prod([shape[a] for a in axis]))
    return shape[axis]


def fix_spec(spec: P, shape, mesh) -> P:
    """Shardings of stored tensors must divide exactly: drop axes that
    don't."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        out.append(axis if axis is not None
                   and dim % _axis_size(mesh, axis) == 0 else None)
    return P(*out)


def _spec_axes(spec: P) -> set:
    used = set()
    for part in spec:
        if part is None:
            continue
        if isinstance(part, (tuple, list)):
            used.update(part)
        else:
            used.add(part)
    return used


def _add_fsdp(spec: P, shape, fsdp_axes, model_shards: int,
              itemsize: int) -> P:
    """Add the (not-yet-used) data axes to the largest unsharded dim of a
    big leaf. Leaves already sharded over an fsdp axis (EP expert weights)
    only receive the remaining axes."""
    used = _spec_axes(spec)
    free = tuple(a for a in fsdp_axes if a not in used)
    if not free:
        return spec
    local_bytes = int(np.prod(shape)) * itemsize
    for a in used:
        local_bytes //= max(model_shards if a == "model" else 1, 1)
    if local_bytes < FSDP_MIN_LEAF_BYTES:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    cand = [(shape[i], i) for i in range(len(shape)) if parts[i] is None]
    if not cand:
        return spec
    _, axis = max(cand)
    parts[axis] = free if len(free) > 1 else free[0]
    return P(*parts)


def param_bytes_estimate(abstract_params) -> int:
    return tree_bytes(abstract_params)


def decide_fsdp(cfg: ModelConfig, abstract_params, mesh, kind: str,
                tc: Optional[TrainConfig] = None,
                hbm_bytes: int = HBM_BYTES) -> bool:
    """FSDP when TP-only param (+opt) state would blow per-rank
    ``hbm_bytes``/2."""
    pb = param_bytes_estimate(abstract_params)
    per_chip = pb / model_axis_size(mesh)
    if kind == "train":
        adam_mult = (2.0 if (tc and tc.adam_dtype == "bfloat16") else 4.0)
        per_chip *= (1.0 + adam_mult)
    return per_chip > hbm_bytes / 2


def param_specs(cfg: ModelConfig, abstract_params, mesh, *,
                fsdp: Optional[bool] = None, kind: str = "train",
                tc: Optional[TrainConfig] = None,
                hbm_bytes: int = HBM_BYTES):
    """Spec tree matching the params tree.

    FSDP (weight sharding over data) applies only for *serving* of models
    whose TP-sharded weights exceed the device (kimi-class); training's
    memory relief comes from ZeRO-1 sharded optimizer state instead
    (see train_shardings)."""
    if fsdp is None:
        fsdp = kind != "train" and decide_fsdp(
            cfg, abstract_params, mesh, kind, tc, hbm_bytes)
    ms = model_axis_size(mesh)
    daxes = data_axes(mesh)
    specs = []
    for path, leaf in flatten_with_paths(abstract_params):
        spec = _leaf_spec(path, leaf.ndim)
        if fsdp:
            spec = _add_fsdp(spec, leaf.shape, daxes, ms,
                             leaf.element_size())
        specs.append(fix_spec(spec, leaf.shape, mesh))
    return tree_unflatten(abstract_params, specs)


def zero1_opt_specs(param_spec_tree, abstract_params, mesh):
    """ZeRO-1: optimizer moments additionally sharded over the data axes
    (one gather of params + one reduce of grads per step, OUTSIDE the
    layer loop)."""
    daxes = data_axes(mesh)
    ms = model_axis_size(mesh)
    flat_s = [s for _, s in flatten_with_paths(param_spec_tree)]
    out = []
    for (path, leaf), spec in zip(flatten_with_paths(abstract_params),
                                  flat_s, strict=True):
        s = _add_fsdp(spec, leaf.shape, daxes, ms, 4)
        out.append(fix_spec(s, leaf.shape, mesh))
    return tree_unflatten(abstract_params, out)


def batch_axes(mesh, batch_size: int):
    shape = mesh_shape(mesh).shape
    daxes = data_axes(mesh)
    total = int(np.prod([shape[a] for a in daxes])) if daxes else 1
    if daxes and batch_size % total == 0:
        return daxes if len(daxes) > 1 else daxes[0]
    if "data" in daxes and batch_size % shape["data"] == 0:
        return "data"
    return None


def batch_specs(batch_tree, mesh):
    """Batch dict: leading dim is always global batch."""
    def spec(leaf):
        if not leaf.ndim:
            return P()
        ba = batch_axes(mesh, leaf.shape[0])
        return P(*([ba] + [None] * (leaf.ndim - 1)))
    return tree_map(spec, batch_tree)


def cache_specs(cfg: ModelConfig, cache_tree, mesh):
    """KV/SSM cache sharding (see module docstring for the SP rule)."""
    ms = model_axis_size(mesh)

    def spec(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if leaf.ndim == 0:
            return P()
        if name in ("k", "v", "cross_k", "cross_v") or name.endswith(
                ("_k", "_v")):
            # [L, B, S, Hkv, hd]
            ba = batch_axes(mesh, leaf.shape[1])
            if cfg.num_kv_heads and cfg.num_kv_heads % ms == 0:
                s = P(None, ba, None, "model", None)
            else:
                s = P(None, ba, "model", None, None)  # seq-parallel KV
        elif name == "ssm":
            ba = batch_axes(mesh, leaf.shape[1])
            hax = "model" if leaf.shape[2] % ms == 0 else None
            s = P(None, ba, hax, None, None)
        elif name == "conv":
            ba = batch_axes(mesh, leaf.shape[1])
            s = P(None, ba, None, "model")
        else:
            return P()
        return fix_spec(s, leaf.shape, mesh)

    return tree_map_with_path(spec, cache_tree)


#: the leaf names tensor parallelism may split (``tp_leaves``)
TP_NAMES = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embed", "lm_head",
            "out_proj", "norm_w", "dt_bias", "A_log", "D")
#: a Mamba2 layer's leaves stored split by heads (``tp_leaves``' local
#: set), and those it computes from their columns (its summed set)
MAMBA_LOCAL = ("out_proj", "norm_w", "dt_bias", "A_log", "D")
MAMBA_COLUMNS = ("in_proj", "conv_w", "conv_b")


def tp_leaves(cfg: ModelConfig, param_spec_tree, mesh):
    """(the leaves the tensor-parallel compute takes as this rank's shard
    over 'model', the replicated leaves whose gradients it sums over
    'model'), as sets of paths, for the stored specs ``param_spec_tree``
    (``param_specs``).  An attention block splits where M divides its q
    heads and its kv groups line up with them: its ``wq`` and ``wo``
    always, its ``wk`` / ``wv`` where M divides the kv heads too, else
    they are gathered and their gradients summed (each rank reads only
    its q heads' kv heads), as are its ``q_norm`` / ``k_norm``'s; a gated
    MLP where M divides d_ff; the embedding and the LM head where M
    divides the vocabulary.  A Mamba2 layer splits by heads where M
    divides its SSM heads and it has one group (B and C shared by every
    head): its ``out_proj`` (rows over d_inner), ``norm_w``, ``dt_bias``,
    ``A_log`` and ``D`` are local, their stored shards head-aligned;
    ``in_proj``, ``conv_w`` and ``conv_b``, whose stored column runs cross
    the packed ``[z | x | B | C | dt]`` boundaries, are gathered (the
    layer takes its columns, ``tp.mamba_columns``) and summed: the B and C
    columns carry each rank's partial gradient, the others are zero off
    their rank.  Every other leaf (norms, router, experts, and leaves
    ``fix_spec`` leaves whole) is computed whole.  Both sets are empty on
    a model axis of one rank."""
    M = model_axis_size(mesh)
    local, summed = set(), set()
    if M == 1:
        return local, summed
    specs = dict(flatten_with_paths(param_spec_tree))

    def on(path, dim):
        return path in specs and specs[path][dim] == "model"
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    for path in specs:
        pre, _, name = path.rpartition("/")
        pre = pre + "/" if pre else ""
        if name == "wq" and Hq % M == 0 and on(pre + "wq", -1) \
                and on(pre + "wo", -2):
            kv = {pre + "wk", pre + "wv"}
            hl, G = Hq // M, Hq // Hkv
            if Hkv % M == 0 and all(on(k, -1) for k in kv):
                local |= kv
            elif hl % G == 0 or G % hl == 0:
                summed |= kv
            else:
                continue
            local |= {pre + "wq", pre + "wo"}
            summed |= {pre + n for n in ("q_norm", "k_norm")
                       if pre + n in specs}
        elif name == "wi_gate":
            trio = (pre + "wi_gate", pre + "wi_up", pre + "wo")
            if on(trio[0], -1) and on(trio[1], -1) and on(trio[2], -2):
                local |= set(trio)
        elif name == "out_proj" and cfg.ssm_heads % M == 0 \
                and cfg.ssm_groups == 1 and on(path, -2) \
                and all(on(pre + n, -1) for n in MAMBA_LOCAL[1:]):
            local |= {pre + n for n in MAMBA_LOCAL}
            summed |= {pre + n for n in MAMBA_COLUMNS}
    if on("embed", -2):
        local.add("embed")
    if on("lm_head", -1):
        local.add("lm_head")
    return local, summed


class NamedSharding:
    """A spec on a mesh: the port's (mesh, spec) pair.  ``placements``
    are its DTensor placements, one per mesh dim: ``Shard(i)`` where
    tensor dim ``i`` names that mesh axis, else ``Replicate()``.  A dim
    sharded over several axes (``("pod", "data")``) is ``Shard(i)`` on
    each, major to minor in the mesh's order, as in JAX."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_shape(self.mesh).axis_names
        out = [Replicate()] * len(names)
        for i, part in enumerate(self.spec):
            axes = () if part is None else (
                tuple(part) if isinstance(part, tuple) else (part,))
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"{self.spec}: axes of dim {i} must follow "
                                 f"the mesh's order {names}")
            for j in pos:
                out[j] = Shard(i)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_shape(self.mesh)}, {self.spec})"


def to_named(tree_of_specs, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_of_specs)


# ---------------------------------------------------------------------------
# Assembled sharding plans per step kind
# ---------------------------------------------------------------------------

def train_shardings(cfg: ModelConfig, mesh, abstract_params, abstract_opt,
                    abstract_batch, tc: Optional[TrainConfig] = None,
                    fsdp: Optional[bool] = None) -> Dict[str, Any]:
    ps = param_specs(cfg, abstract_params, mesh, fsdp=fsdp, kind="train",
                     tc=tc)
    # ZeRO-1: moments sharded over data axes on top of the param TP spec;
    # step counter replicated
    zs = zero1_opt_specs(ps, abstract_params, mesh)
    opt_spec = type(abstract_opt)(m=zs, v=zs, count=P())
    bs = batch_specs(abstract_batch, mesh)
    return {
        "params": to_named(ps, mesh),
        "opt": to_named(opt_spec, mesh),
        "batch": to_named(bs, mesh),
        "metrics": NamedSharding(mesh, P()),
    }


def serve_shardings(cfg: ModelConfig, mesh, abstract_params, abstract_cache,
                    token_batch: int, fsdp: Optional[bool] = None
                    ) -> Dict[str, Any]:
    ps = param_specs(cfg, abstract_params, mesh, fsdp=fsdp, kind="serve")
    cs = cache_specs(cfg, abstract_cache, mesh)
    ba = batch_axes(mesh, token_batch)
    return {
        "params": to_named(ps, mesh),
        "cache": to_named(cs, mesh),
        "token": NamedSharding(mesh, P(ba, None)),
        "logits": NamedSharding(mesh, P(ba, None, "model")),
    }
