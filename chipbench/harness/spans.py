"""The profiled slice by the program's own ranges: device time and idle
gaps put down to the spans the port opens (``repro_torch/obs/spans.py``:
function-scoped ``torch.profiler`` ranges named ``<layer>.<part>``),
read from the same kineto events as ``profiling.summarise``.

* Each device operation is matched by its correlation id to the CUDA
  API call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemsetAsync``, ...) and put down to the
  program ranges, on any thread, whose intervals hold that launch:
  autograd launches from its own thread while the main thread waits in
  ``train.backward``.
* Each idle gap of the device gets the ranges, program or harness
  (``chipbench/...``), that hold its midpoint; its label is the
  innermost of them, as ``profiling.summarise`` labels it by the
  harness's alone.

Ranges are nested by their length (the shortest holding a time is the
innermost).  The slice's window and busy intervals are the summary's.
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from chipbench.harness.profiling import OUTSIDE, SLICE, _ns, _union

#: a program range's name: ``<layer>.<part>``
PROGRAM = re.compile(r"[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*")

#: the least share of the slice's device time launched inside program
#: ranges for a quantity to be read
LEAST = 0.95

Path = Tuple[str, ...]


@dataclass
class Spans:
    device_s: float                              # Σ device operation time
    by_path: Dict[Path, float]                   # device s by launch path
    idle_by_path: Dict[Path, float]              # idle s by midpoint path
    count: Dict[str, int] = field(default_factory=dict)   # ranges by name
    unmatched_s: float = 0.0                     # no launch found

    def device(self, *names: str) -> float:
        """Device seconds launched inside every one of ``names``."""
        return sum(s for p, s in self.by_path.items()
                   if all(n in p for n in names))

    def idle(self, *names: str) -> float:
        """Idle seconds whose midpoint lies inside every one of ``names``."""
        return sum(s for p, s in self.idle_by_path.items()
                   if all(n in p for n in names))

    @property
    def attributed(self) -> float:
        """Share of the device time launched inside some program range."""
        if self.device_s <= 0:
            return 0.0
        inside = sum(s for p, s in self.by_path.items()
                     if any(PROGRAM.fullmatch(n) for n in p))
        return inside / self.device_s

    def innermost(self, idle: bool = False) -> List[Tuple[str, float]]:
        """Seconds by innermost range, largest first (idle: the labels
        of ``breakdown.idle_gaps``, program ranges where one is
        innermost)."""
        out: Dict[str, float] = {}
        for p, s in (self.idle_by_path if idle else self.by_path).items():
            key = p[-1] if p else OUTSIDE
            out[key] = out.get(key, 0.0) + s
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])


def _paths(ranges, points) -> List[Path]:
    """For each time of ``points``, the names of the ranges
    ``(start, end, name, thread)`` holding it, on any thread, outermost
    first.  One sweep over the sorted starts, ends and points."""
    marks = []
    for i, (s, t, _, _) in enumerate(ranges):
        marks.append((s, 1, i))
        marks.append((t, 0, i))        # [s, t): an end before a point
    for j, p in enumerate(points):
        marks.append((p, 2, j))
    marks.sort()
    open_: Dict[int, None] = {}
    out: List[Optional[Path]] = [None] * len(points)
    for _, kind, i in marks:
        if kind == 1:
            open_[i] = None
        elif kind == 0:
            open_.pop(i, None)
        else:
            held = sorted(open_, key=lambda k: ranges[k][0] - ranges[k][1])
            out[i] = tuple(ranges[k][2] for k in held)
    return out


def read(events) -> Spans:
    """The slice's device time and idle gaps by program and harness
    range, from kineto events (``prof.profiler.kineto_results
    .events()``)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    program, harness, dev, launch = [], [], [], {}
    lo = hi = None
    for e in events:
        name = e.name()
        s = _ns(e, "start")
        t = s + _ns(e, "duration")
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith(
                    "chipbench/"):
                dev.append((s, t, e.correlation_id()))
        elif name == SLICE:
            lo, hi = s, t
        elif name.startswith("chipbench/"):
            harness.append((s, t, name, e.start_thread_id()))
        elif PROGRAM.fullmatch(name):
            program.append((s, t, name, e.start_thread_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = s
    if lo is None:
        raise RuntimeError("the trace holds no chipbench/slice range")
    if dev:
        lo = min(lo, min(s for s, _, _ in dev))
        hi = max(hi, max(t for _, t, _ in dev))

    # device time by the program ranges holding each launch
    found = [(s, t, launch[c]) for s, t, c in dev if c in launch]
    unmatched = sum(t - s for s, t, c in dev if c not in launch)
    by_path: Dict[Path, float] = {}
    for (s, t, _), p in zip(found, _paths(program,
                                          [at for _, _, at in found])):
        by_path[p] = by_path.get(p, 0.0) + (t - s) / 1e9

    # idle gaps by the ranges holding their midpoints
    gaps, edge = [], lo
    for s, t in _union([(s, t) for s, t, _ in dev]) + [[hi, hi]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    idle: Dict[Path, float] = {}
    for (a, b), p in zip(gaps, _paths(program + harness,
                                      [(a + b) / 2 for a, b in gaps])):
        idle[p] = idle.get(p, 0.0) + (b - a) / 1e9

    count: Dict[str, int] = {}
    for _, _, n, _ in program:
        count[n] = count.get(n, 0) + 1
    return Spans(device_s=sum(t - s for s, t, _ in dev) / 1e9,
                 by_path=by_path, idle_by_path=idle, count=count,
                 unmatched_s=unmatched / 1e9)


def per_instance_ms(total_s: float, spans: Spans,
                    name: str) -> Optional[float]:
    """``total_s`` over the slice's ``name`` ranges, in ms; None (and why,
    on standard error) where the slice holds none or under ``LEAST`` of
    its device time was launched inside a program range."""
    n = spans.count.get(name, 0)
    if n == 0:
        print(f"chipbench: spans: no {name} range in the slice",
              file=sys.stderr)
        return None
    if spans.attributed < LEAST:
        print(f"chipbench: spans: {spans.attributed:.3f} of the device "
              f"time launched inside program ranges, under {LEAST}",
              file=sys.stderr)
        return None
    return 1e3 * total_s / n


#: per-layer quantities of a slice's ``Spans``: device ms of the chunk
#: calls' attention blocks per chunk call, idle ms inside a decode call per
#: decode call, device ms of a train step's backward (its recompute
#: included) and of its optimizer per step
METRICS = {
    "prefill_attn_ms": lambda sp: per_instance_ms(
        sp.device("serve.prefill_call", "model.attn"), sp,
        "serve.prefill_call"),
    "decode_idle_ms": lambda sp: per_instance_ms(
        sp.idle("serve.decode_call"), sp, "serve.decode_call"),
    "backward_ms": lambda sp: per_instance_ms(
        sp.device("train.backward"), sp, "train.backward"),
    "optimizer_ms": lambda sp: per_instance_ms(
        sp.device("train.optimizer"), sp, "train.optimizer"),
}
