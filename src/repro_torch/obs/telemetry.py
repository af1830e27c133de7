"""Telemetry registry: counters, gauges, and sampled timelines.

One :class:`Telemetry` instance rides on every
:class:`~repro_torch.sched.cluster.ClusterRuntime`; consumers increment
counters and sample timelines, benchmarks read ``summary()``.

The split is deliberate and load-bearing:

* ``counters``  — DETERMINISTIC accumulators (events dispatched per
  kind, stale drops, migrations).  Safe to surface in seed-pinned
  outputs: identical seeds give identical counters.
* ``gauges``    — point-in-time values that may come from the WALL
  clock (events/sec of real time).  These must never be copied into an
  engine/simulator summary dict — the traced-vs-untraced bit-identical
  acceptance check (and every golden) would break on machine speed.
* ``timelines`` — ``(t, value)`` samples on the virtual clock (per-axis
  node utilization, per-link flow counts); ``summary()`` reduces them
  to n/mean/max/last so a bench line stays one line.

Stdlib only, imports nothing from the rest of ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class Telemetry:
    """Plain counter / gauge / timeline registry (no locking — the
    runtime is single-threaded over a virtual clock)."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.timelines: Dict[str, List[Tuple[float, float]]] = {}

    def inc(self, name: str, by: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + by

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def sample(self, name: str, t: float, value: float) -> None:
        """Append one virtual-time sample to the ``name`` timeline."""
        self.timelines.setdefault(name, []).append(
            (float(t), float(value)))

    # --- reading ----------------------------------------------------------
    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def counters_with_prefix(self, prefix: str) -> Dict[str, float]:
        return {k: v for k, v in self.counters.items()
                if k.startswith(prefix)}

    def summary(self) -> Dict:
        """Counters and gauges verbatim; timelines reduced to
        ``{n, mean, max, last}`` (time-unweighted over the samples)."""
        lines = {}
        for name, pts in self.timelines.items():
            vals = [v for _, v in pts]
            lines[name] = {
                "n": len(vals),
                "mean": sum(vals) / len(vals) if vals else 0.0,
                "max": max(vals) if vals else 0.0,
                "last": vals[-1] if vals else 0.0,
            }
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timelines": lines}


def sample_node(telemetry: Telemetry, node, t: float) -> None:
    """Sample every capacitated axis of a
    :class:`~repro_torch.sched.cluster.Node`'s booked-claim ledger into
    ``node<nid>.util.<axis>`` timelines (booked fraction of capacity)."""
    for axis in node.capacity.axes:
        telemetry.sample(f"node{node.nid}.util.{axis}", t,
                         node.utilization(axis))


def sample_links(telemetry: Telemetry, topology, t: float) -> None:
    """Sample every :class:`~repro_torch.sched.topology.Link`'s in-flight
    ledger into ``link.<name>.flows`` timelines."""
    for link in topology.links():
        telemetry.sample(f"link.{link.name}.flows", t, link.n_flows)
