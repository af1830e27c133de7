"""The cost of one call of a step of the port, without running it: the
counterpart of the JAX package's ``utils/hlo_analyzer.py::analyze`` (FLOPs,
bytes, loops with trip counts, collectives) and ``utils/hlo.py::
count_ops`` / ``collective_stats``, read from the ops eager PyTorch
dispatches instead of from compiled HLO.

``analyze(step, *args)`` runs ``step(*args)`` once on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): every argument leaf,
``device="meta"`` or real, is replaced by a fake CPU tensor of its shape,
dtype and strides (a DTensor by a DTensor of the same placements over a
fake tensor of its local shard's shape: what the rank holds, never the
global tensor), so the step computes nothing and allocates nothing,
and every kernel wrapper takes its plain version (a fake tensor says
``device.type == "cpu"``).  Nothing is launched: the launch counters of
every kernel are checked unchanged.  Under the fake mode
``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs and a
dispatch mode of this module sees every op, its tensors and its storages.

What is counted (``StepCost``), and how it differs from XLA's numbers:

* ``flops``: FlopCounterMode's total, which counts matrix products
  (mm, bmm, addmm, baddbmm, convolutions, the fused attentions) and
  nothing elementwise, as the JAX count takes ``dot`` only.
* ``hbm_bytes``: input + output bytes of every op that is not a view,
  an alias or a metadata op (``_is_alias_op``, ``_NO_TRAFFIC``).  An op
  that writes one of its inputs in place counts that input once, as
  written; an indexed write (``_INDEXED_WRITES``) counts its source twice
  and its indices, as XLA charges a dynamic-update-slice.  Eager PyTorch
  runs every op as its own kernel, so this is more than XLA's count of a
  fused program: a deliberate difference, not an error.
* ``peak_temp_bytes``: the most bytes that live storages made by the
  step's ops held at once, from their lifetimes (``weakref.finalize`` on
  each storage: a storage lives while any tensor, or autograd's saved
  tensors, hold it).  The arguments' storages and the storages the step
  returns do not count (XLA's ``temp_size_in_bytes``), so argument +
  temporary + output bytes bound the step's footprint.
* ``argument_bytes`` / ``output_bytes``: the bytes of the call's
  argument and result leaves, a DTensor's local shard's (XLA adds 8 B per
  output leaf for its tuple index table; this does not).
* ``alias_bytes``: the bytes of the result leaves that are argument
  storages, written in place (the decode steps' KV caches): XLA's
  ``alias_size_in_bytes`` of donated buffers.
* ``bytes_by_op``: ``hbm_bytes`` by aten op name.
* ``matmul_count``: the ops FlopCounterMode has a formula for (JAX's
  ``dot`` count); ``op_count``: every counted op, each a kernel in eager
  PyTorch (JAX's ``fusion`` count).
* ``loops``: the recurrences of the step's program with their trip
  counts, as XLA's ``while`` loops count them (one per loop of the
  program, however often an enclosing loop runs it):
  - each layer stack the forward walks: the models walk a stacked
    ``[L, ...]`` tree through one ``torch.unbind`` per leaf
    (``models/model.py::_layers``), so a run of consecutive unbinds of
    one length along dim 0 is one stack, ``trip`` its length;
  - each loop a plain version declares with ``note_loop`` (the Mamba2
    SSD's recurrence over chunks), once per stack walk;
  - in a step that runs a backward, each of the forward's loops again
    (autograd walks them in reverse), and each declared loop that the
    backward runs again (the recompute under ``remat``) once more.
* ``collective_counts`` / ``collective_bytes``: the ``c10d`` and
  functional-collective ops the step issues, by JAX's kind names, with
  their operand bytes (a send is one ``collective-permute``; a receive,
  its other half, is not counted again).  Under the fake mode they move
  nothing.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.utils.tree import tree_leaves, tree_map

#: c10d and functional-collective op names -> JAX's collective kinds
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional")

#: ops that allocate without moving bytes (no kernel writes them)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "_unsafe_view",
               "lift_fresh"}

#: in-place writes of a source into indexed slots of their first input
_INDEXED_WRITES = {"index_copy_", "index_put_", "_index_put_impl_",
                   "scatter_", "scatter_add_", "scatter_reduce_",
                   "index_add_", "masked_scatter_"}


@dataclass
class StepCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    peak_temp_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    output_leaves: int = 0
    alias_bytes: int = 0
    matmul_count: int = 0
    op_count: int = 0
    loops: List[Dict] = field(default_factory=list)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _is_alias_op(func) -> bool:
    """A view or alias: every tensor it returns aliases an input without
    writing it (the schema's ``Tensor(a)``), or it moves no bytes."""
    if func.__name__.split(".")[0] in _NO_TRAFFIC:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _written_input(func, args):
    """The input an in-place (``Tensor(a!)``) op writes, or None."""
    for a, arg in zip(func._schema.arguments, args):
        if a.alias_info is not None and a.alias_info.is_write and \
                isinstance(arg, torch.Tensor):
            return arg
    return None


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _launch_counts() -> Dict[str, int]:
    """Every kernel launcher's ``.launches``."""
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fl
    from repro_torch.kernels.paged_attention import kernel as pg
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_scan import kernel as ssd
    fns = [pg.paged_attention_fwd, fl.flash_attention_fwd,
           dec.decode_attention_fwd, ssd.ssd_scan_fwd, rms.rmsnorm_fwd,
           rms.add_rmsnorm_fwd, rms.qk_norm_rope_fwd, rms.gated_rmsnorm_fwd,
           rms.rmsnorm_bwd, rms.add_rmsnorm_bwd, rms.qk_norm_rope_bwd,
           rms.gated_rmsnorm_bwd]
    return {f.__name__: f.launches for f in fns}


#: the recorders of the ``analyze`` calls in progress
_RECORDERS: List["_Recorder"] = []


def note_loop(name: str, trip: int) -> None:
    """Declare a loop of ``trip`` iterations that the ops alone do not
    show (a Python loop over chunks); a no-op outside ``analyze``."""
    for rec in _RECORDERS:
        rec.note(name, trip)


def _in_backward() -> bool:
    return torch._C._current_autograd_node() is not None


class _Recorder(TorchDispatchMode):
    """Sees every op below autograd: bytes, op counts, layer stacks,
    collectives and the lifetimes of the storages the ops make."""

    def __init__(self, cost: StepCost, matmuls, arg_keys):
        super().__init__()
        self.cost, self.matmuls, self.arg_keys = cost, matmuls, arg_keys
        self.events: List[tuple] = []      # (storage serial, +/- bytes)
        self.live: Dict[int, tuple] = {}   # storage key -> (serial, bytes)
        self.run = None                    # the stack walk in progress
        self.noted = set()                 # declared loops already seen
        self.backward = False              # whether a backward ran

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.arg_keys:
            return
        serial = len(self.events)
        self.live[key] = (serial, st.nbytes())
        self.events.append((serial, st.nbytes()))

        def free(key=key):
            serial, b = self.live.pop(key)
            self.events.append((serial, -b))
        weakref.finalize(st, free)

    def note(self, name: str, trip: int) -> None:
        phase = "backward" if _in_backward() else "forward"
        stacks = [i for i, lp in enumerate(self.cost.loops)
                  if lp["name"] == "layers"]
        key = (name, trip, phase, stacks[-1] if stacks else -1)
        if key not in self.noted:
            self.noted.add(key)
            self.cost.loops.append({"name": name, "trip": trip,
                                    "phase": phase})

    def serials(self, tensors) -> set:
        """The serials of the live storages of ``tensors``."""
        return {self.live[k][0] for k in map(_storage_key, tensors)
                if k in self.live}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func.__name__.split(".")[0]
        outs = _tensors(out)
        if ns in _COLLECTIVE_NS:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in _tensors(args[:1])))
                c = self.cost
                c.collective_counts[kind] = c.collective_counts.get(kind,
                                                                    0) + 1
                c.collective_bytes[kind] = c.collective_bytes.get(kind,
                                                                  0.0) + b
            self.run = None
            return out
        if ns != "aten":
            return out
        for t in outs:
            self._track(t)
        backward = _in_backward()
        self.backward |= backward
        if name == "unbind" and not backward:
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if dim == 0:
                n = len(outs)
                if self.run is None or self.run["trip"] != n:
                    self.run = {"name": "layers", "trip": n,
                                "phase": "forward"}
                    self.cost.loops.append(self.run)
            return out
        if _is_alias_op(func):
            return out
        self.run = None
        ins = _tensors(list(args) + list(kwargs.values()))
        written = _written_input(func, args)
        if written is None:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        else:
            others = [_nbytes(t) for t in ins if t is not written]
            b = sum(others) + (max(others, default=0)
                               if name in _INDEXED_WRITES
                               else _nbytes(written))
        self.cost.hbm_bytes += b
        by_op = self.cost.bytes_by_op
        by_op[name] = by_op.get(name, 0.0) + b
        self.cost.op_count += 1
        if func in self.matmuls or func.overloadpacket in self.matmuls:
            self.cost.matmul_count += 1
        return out


class CollectiveCounter(TorchDispatchMode):
    """The collectives the ops run under it issue, on real tensors (a
    step on its ranks, or DTensor's gathers): ``counts`` and operand
    ``bytes`` by JAX's kind names, as ``StepCost`` counts them.

        with CollectiveCounter() as c:
            step(...)
        c.counts.get("all-gather", 0)
    """

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = COLLECTIVE_KINDS.get(func.__name__.split(".")[0]) \
            if func.namespace in _COLLECTIVE_NS else None
        if kind is not None:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0.0) + float(
                sum(_nbytes(t) for t in _tensors(args[:1])))
        return out


def _peak(events, skip) -> int:
    live = peak = 0
    for key, b in events:
        if key not in skip:
            live += b
            peak = max(peak, live)
    return peak


def _local(t: torch.Tensor) -> torch.Tensor:
    """What a rank holds of ``t``: a DTensor's local shard, else ``t``."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _faked(t):
    """A fake CPU stand-in for an argument leaf (inside the fake mode): of
    ``t``'s shape, dtype and strides, or for a DTensor a DTensor of its
    placements over a stand-in of its local shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        loc = t.to_local()
        return DTensor.from_local(
            torch.empty_strided(loc.shape, loc.stride(), dtype=loc.dtype,
                                device="cpu"), t.device_mesh, t.placements,
            run_check=False, shape=t.shape, stride=t.stride())
    if isinstance(t, torch.Tensor):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device="cpu")
    return t


def analyze(step, *args) -> StepCost:
    """``step(*args)`` once on fake CPU tensors: its ``StepCost``.  The
    argument trees (nested dicts, lists, tuples and NamedTuples) may hold
    ``device="meta"`` or real tensors, or DTensors over either (a sharded
    step's state: only the local shards' shapes count); only shapes,
    dtypes and strides are read."""
    cost = StepCost()
    before = _launch_counts()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        fargs = [tree_map(_faked, a) for a in args]
    arg_leaves = [_local(t) for a in fargs for t in tree_leaves(a)
                  if isinstance(t, torch.Tensor)]
    cost.argument_bytes = sum(_nbytes(t) for t in arg_leaves)
    flop_mode = FlopCounterMode(display=False)
    rec = _Recorder(cost, getattr(flop_mode, "flop_registry", {}),
                    {_storage_key(t) for t in arg_leaves})
    _RECORDERS.append(rec)
    try:
        with fake, flop_mode, rec:
            out = step(*fargs)
    finally:
        _RECORDERS.remove(rec)
    if rec.backward:
        cost.loops += [dict(lp, phase="backward") for lp in cost.loops
                       if lp["phase"] == "forward"]
    out_leaves = [_local(t) for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
    cost.output_bytes = sum(_nbytes(t) for t in out_leaves)
    cost.output_leaves = len(out_leaves)
    cost.alias_bytes = sum(_nbytes(t) for t in out_leaves
                           if _storage_key(t) in rec.arg_keys)
    cost.flops = float(flop_mode.get_total_flops())
    cost.peak_temp_bytes = _peak(rec.events, rec.serials(out_leaves))
    after = _launch_counts()
    if after != before:
        raise AssertionError(f"a kernel launched under the fake mode: "
                             f"{before} -> {after}")
    return cost
