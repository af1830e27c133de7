"""Pluggable placement policies: who gets offered capacity, in what order.

The simulator's dispatcher used to hard-wire FCFS-over-jid with an
in-index host scan.  This module extracts that choice behind a tiny
protocol so queue ordering and host-scan order are selectable per run
(``SimConfig.placement``, ``benchmarks/run.py --placement``,
``launch/serve.py --placement``) without touching the admission logic:

* ``fcfs``          — jobs in arrival (jid) order, hosts in index order.
  The default; byte-identical to the pre-registry dispatcher.
* ``sjf``           — shortest remaining (isolated) job first: small
  jobs overtake large ones, trading makespan for mean turnaround.
* ``best-fit``      — FCFS over jobs, but hosts scanned tightest-fit
  first (least free primary memory), packing fragments before opening
  fresh hosts.
* ``arrival-aware`` — jobs ordered by normalized waiting time
  ``(now - arrival) / c_iso`` descending: the job whose slowdown is
  growing fastest is served first (directly optimizes ANTT under open
  arrival streams).

Jobs and hosts are duck-typed (``.arrival``/``.c_iso``/``.unassigned``
and ``.free_vector()`` respectively) so this module imports nothing from
``repro_torch.core`` — registration is import-cycle-free and third-party
policies can register their own types.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Type

_EPS = 1e-12


class PlacementPolicy:
    """Ordering protocol.  Subclass + ``@register_placement(name)``.

    Both hooks must be *pure orderings* (no admission decisions, no RNG):
    they receive already-schedulable jobs / candidate hosts and return
    them in offer order.  Stability matters — ties must preserve input
    order so runs stay deterministic.
    """

    name = "base"

    def order_jobs(self, jobs: Sequence, now: float = 0.0) -> List:
        return list(jobs)

    def order_hosts(self, job, hosts: Sequence,
                    primary_axis: str = "host_ram") -> List:
        return list(hosts)


_REGISTRY: Dict[str, Type[PlacementPolicy]] = {}


def register_placement(name: str):
    """Class decorator adding a policy to the registry under ``name``."""
    def deco(cls: Type[PlacementPolicy]) -> Type[PlacementPolicy]:
        if not issubclass(cls, PlacementPolicy):
            raise TypeError(f"{cls!r} is not a PlacementPolicy")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_placement(name: str) -> PlacementPolicy:
    """Instantiate the registered policy ``name`` (KeyError with the
    available names otherwise)."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r} "
                       f"(available: {available_placements()})") from None


def available_placements() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


@register_placement("fcfs")
class FCFSPlacement(PlacementPolicy):
    """First-come-first-served over jid, hosts in index order — the
    pre-registry dispatcher, bit-for-bit."""


@register_placement("sjf")
class SJFPlacement(PlacementPolicy):
    """Shortest remaining isolated work first (stable on ties)."""

    def order_jobs(self, jobs, now: float = 0.0):
        def remaining(j):
            frac = j.unassigned / max(getattr(j, "items", j.unassigned),
                                      _EPS)
            return j.c_iso * frac
        return sorted(jobs, key=remaining)


@register_placement("best-fit")
class BestFitPlacement(PlacementPolicy):
    """FCFS over jobs; hosts scanned tightest-fit first (least free
    primary memory), so fragments fill before fresh hosts open."""

    def order_hosts(self, job, hosts, primary_axis: str = "host_ram"):
        return sorted(hosts,
                      key=lambda h: h.free_vector().get(primary_axis, 0.0))


@register_placement("arrival-aware")
class ArrivalAwarePlacement(PlacementPolicy):
    """Serve the job whose normalized turnaround is degrading fastest:
    order by waiting time over isolated runtime, descending.  Under a
    batch (all arrivals at t=0) this prioritizes short jobs — the ANTT
    view of SJF; under an open stream it balances waiting against size."""

    def order_jobs(self, jobs, now: float = 0.0):
        def urgency(j):
            return (now - getattr(j, "arrival", 0.0)) / max(j.c_iso, _EPS)
        return sorted(jobs, key=urgency, reverse=True)
