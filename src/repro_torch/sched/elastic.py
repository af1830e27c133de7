"""Elastic runtime: spill-aware shrink admission, deterministic failure
injection, and replica autoscaling on the shared ClusterRuntime.

Admission so far has been *binary*: a job (or a join candidate) whose
demand vector does not fit the budget waits.  "Don't cry over spilled
records" (PAPERS.md) shows data-parallel tasks can run with LESS memory
than their working set at a *modeled* slowdown — spilled records are
re-read from disk, costing time instead of correctness — and "A
Workload-Specific Memory Capacity Configuration Approach" shows that
demand/performance trade-off is learnable per workload.  This module
makes the runtime elastic along exactly that axis, plus the two failure
modes the substrate already half-supports:

* :class:`SlowdownCurve` — the learnable trade-off: monotone
  ``fraction of demanded memory -> execution-time multiplier`` points.
  :func:`fit_slowdown_curve` derives one from a calibrated memory
  curve (the in-memory share of a shrunken grant follows the curve's
  inverse; the spilled share pays the disk re-read factor), so convex
  and concave working sets shrink differently — the workload-specific
  part.  The **conservative fallback is the flat curve** ("not
  shrinkable"): an estimate the scheduler does not trust never
  volunteers for a memory cut.
* :class:`ElasticController` — the shrink-vs-wait-vs-reject policy:
  given the largest demand fraction that fits the free budget, it
  shrinks iff the curve prices that fraction under ``max_slowdown``
  (and above ``min_fraction``), waits when the price is too high, and
  rejects only when nothing is free at all.  Consumers charge the
  decision's slowdown into *virtual time* — executor rate in the batch
  simulator, decode-step cost in the serving engine — so a shrunken
  grant is never a free lunch.
* :class:`FailureSchedule` — deterministic, seeded fail/repair
  injection for hosts AND serving replica ``Node``s.  The schedule is
  drawn once at construction from its own RNG (consumer RNG streams
  are untouched — flags-off runs stay bit-identical) and rides the
  shared :class:`~repro_torch.sched.cluster.EventLoop` under its own event
  kinds (``efail``/``erepair``), so it composes with the simulator's
  legacy Poisson ``fail`` events instead of colliding with them.
* :class:`Autoscaler` — spawn/drain replica ``Node``s from *sustained*
  queue-depth and SLO-attainment trends (the signals ``node_steps``
  and the metrics windows already expose), with
  :func:`pick_spawn_node` preferring the rack whose uplink has the
  most residual fair-share headroom when a topology is bound.

Like the rest of ``repro_torch.sched``'s substrate modules, this file imports
nothing from ``repro_torch.core`` or ``repro_torch.serve`` — it is import-cycle
free, so the estimator registry can attach shrink curves to every
:class:`~repro_torch.sched.estimator.DemandEstimate` without a cycle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sched.resources import MEMORY_AXES, ResourceVector

_EPS = 1e-12


# ---------------------------------------------------------------------------
# SlowdownCurve: the demand-vs-slowdown trade-off
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlowdownCurve:
    """Monotone map from the *fraction of demanded memory actually
    granted* to the modeled execution-time multiplier.

    ``points`` are ``(fraction, slowdown)`` pairs sorted by ascending
    fraction with ``slowdown`` non-increasing in ``fraction`` and the
    full grant free (``slowdown_at(1.0) == 1.0``).  A curve whose only
    point is ``(1.0, 1.0)`` is **flat** — "not shrinkable" — which is
    the conservative fallback: estimates the scheduler does not trust
    never volunteer for a memory cut."""

    points: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)

    def __post_init__(self):
        pts = tuple(sorted((float(f), float(s)) for f, s in self.points))
        if not pts:
            pts = ((1.0, 1.0),)
        for f, s in pts:
            if not 0.0 < f <= 1.0:
                raise ValueError(f"shrink fraction must be in (0, 1], "
                                 f"got {f}")
            if s < 1.0 - 1e-9:
                raise ValueError(f"slowdown must be >= 1, got {s} "
                                 f"at fraction {f}")
        object.__setattr__(self, "points", pts)

    @classmethod
    def flat(cls) -> "SlowdownCurve":
        """The not-shrinkable curve (conservative fallback)."""
        return cls(((1.0, 1.0),))

    @classmethod
    def linear(cls, max_slowdown: float, min_fraction: float = 0.5,
               n: int = 5) -> "SlowdownCurve":
        """Linear price: full grant free, ``min_fraction`` costs
        ``max_slowdown``, interpolated between — the declared-constant
        fallback for targets with no calibrated curve to derive from."""
        if not 0.0 < min_fraction < 1.0:
            raise ValueError(f"min_fraction must be in (0, 1), "
                             f"got {min_fraction}")
        fs = np.linspace(min_fraction, 1.0, max(int(n), 2))
        span = 1.0 - min_fraction
        return cls(tuple(
            (float(f),
             1.0 + (float(max_slowdown) - 1.0) * (1.0 - float(f)) / span)
            for f in fs))

    @property
    def min_fraction(self) -> float:
        """Smallest grant fraction the curve prices at all."""
        return self.points[0][0]

    @property
    def shrinkable(self) -> bool:
        """Whether the curve prices ANY fraction below the full grant."""
        return self.min_fraction < 1.0 - 1e-9

    def slowdown_at(self, fraction: float) -> float:
        """Modeled time multiplier of running on ``fraction`` of the
        demanded memory: piecewise-linear between the curve's points,
        ``inf`` below the smallest priced fraction (can't shrink that
        far), exactly 1.0 at or above the full grant."""
        f = float(fraction)
        if f >= 1.0 - 1e-12:
            return 1.0
        if f < self.min_fraction - 1e-12:
            return float("inf")
        xs = np.asarray([p[0] for p in self.points])
        ys = np.asarray([p[1] for p in self.points])
        return float(np.interp(f, xs, ys))


def fit_slowdown_curve(fn, units: float, *,
                       spill_cost: float = 3.0,
                       fractions: Sequence[float] = (0.25, 0.375, 0.5,
                                                     0.625, 0.75,
                                                     0.875, 1.0)
                       ) -> SlowdownCurve:
    """Derive the demand-vs-slowdown curve from a calibrated memory
    function: a grant of ``f * fn(units)`` keeps the working set of
    ``fn.inverse(f * fn(units))`` items in memory and spills the rest,
    each spilled item paying the disk re-read factor ``spill_cost``::

        slowdown(f) = (in_mem + spill_cost * (units - in_mem)) / units

    The curve's *shape* carries the workload: a concave (power-family)
    working set keeps most items in memory under a deep cut (cheap to
    shrink), a convex one loses them fast (expensive) — the
    workload-specific memory-capacity trade-off, learned from the same
    two-probe calibration the admission inverse already runs on.
    Degenerate curves (no inverse, non-positive demand) fall back to
    the flat not-shrinkable curve."""
    units = float(units)
    inverse = getattr(fn, "inverse", None)
    if units <= 0.0 or not callable(inverse):
        return SlowdownCurve.flat()
    try:
        full = float(fn(units))
    except (ValueError, OverflowError, FloatingPointError):
        return SlowdownCurve.flat()
    if not np.isfinite(full) or full <= 0.0:
        return SlowdownCurve.flat()
    pts: List[Tuple[float, float]] = []
    for f in sorted(set(float(x) for x in fractions)):
        if not 0.0 < f <= 1.0:
            continue
        if f >= 1.0 - 1e-12:
            pts.append((1.0, 1.0))
            continue
        try:
            in_mem = float(inverse(f * full))
        except (ValueError, OverflowError, FloatingPointError):
            return SlowdownCurve.flat()
        if not np.isfinite(in_mem):
            return SlowdownCurve.flat()
        in_mem = min(max(in_mem, 0.0), units)
        s = (in_mem + float(spill_cost) * (units - in_mem)) / units
        pts.append((f, max(s, 1.0)))
    if not pts:
        return SlowdownCurve.flat()
    if pts[-1][0] < 1.0 - 1e-12:
        pts.append((1.0, 1.0))
    return SlowdownCurve(tuple(pts))


# ---------------------------------------------------------------------------
# ElasticController: shrink vs wait vs reject
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElasticDecision:
    """One shrink-vs-wait-vs-reject verdict."""
    action: str                     # "shrink" | "wait" | "reject"
    fraction: float = 1.0           # granted fraction of demanded memory
    slowdown: float = 1.0           # modeled time multiplier charged

    def __bool__(self) -> bool:
        return self.action == "shrink"


class ElasticController:
    """The shrink policy: given the largest demand fraction that fits
    the free budget and the workload's :class:`SlowdownCurve`, decide
    whether running smaller-but-slower beats waiting.

    * **shrink** — the fraction is priced (>= the curve's and the
      controller's ``min_fraction``) and its slowdown is within
      ``max_slowdown``: book the shrunken vector, charge the slowdown.
    * **wait**   — the curve is flat (not shrinkable / conservative
      fallback), the cut is too deep, or the price exceeds the cap:
      today's behaviour, the job/request stays queued.
    * **reject** — nothing is free at all (fraction <= 0): shrinking
      cannot help; the caller's structured-reject path applies.
    """

    def __init__(self, max_slowdown: float = 2.5,
                 min_fraction: float = 0.25):
        if max_slowdown < 1.0:
            raise ValueError(f"max_slowdown must be >= 1, "
                             f"got {max_slowdown}")
        if not 0.0 < min_fraction <= 1.0:
            raise ValueError(f"min_fraction must be in (0, 1], "
                             f"got {min_fraction}")
        self.max_slowdown = float(max_slowdown)
        self.min_fraction = float(min_fraction)

    def decide(self, curve: Optional[SlowdownCurve],
               fraction: float) -> ElasticDecision:
        f = float(fraction)
        if f <= _EPS:
            return ElasticDecision("reject", 0.0, float("inf"))
        if f >= 1.0 - 1e-12:
            # it fits outright — nothing to shrink
            return ElasticDecision("shrink", 1.0, 1.0)
        if curve is None or not curve.shrinkable:
            return ElasticDecision("wait", f, float("inf"))
        if f < max(self.min_fraction, curve.min_fraction) - 1e-12:
            return ElasticDecision("wait", f, float("inf"))
        s = curve.slowdown_at(f)
        if not np.isfinite(s) or s > self.max_slowdown + 1e-12:
            return ElasticDecision("wait", f, s)
        return ElasticDecision("shrink", f, s)

    def __repr__(self) -> str:
        return (f"ElasticController(max_slowdown={self.max_slowdown}, "
                f"min_fraction={self.min_fraction})")


def shrink_vector(vec: ResourceVector, fraction: float) -> ResourceVector:
    """Scale a demand vector's MEMORY axes by ``fraction`` — cpu and
    link bandwidth are average-rate resources the spill model does not
    shrink (the slowdown already charges the time they are held)."""
    f = float(fraction)
    return ResourceVector(**{a: (v * f if a in MEMORY_AXES else v)
                             for a, v in vec.items()})


# ---------------------------------------------------------------------------
# FailureSchedule: deterministic seeded fail/repair injection
# ---------------------------------------------------------------------------

class FailureSchedule:
    """A pre-drawn fail/repair plan for hosts or serving replicas,
    injected onto a :class:`~repro_torch.sched.cluster.ClusterRuntime` as its
    own event kinds (``efail``/``erepair``).

    Determinism has two parts: the plan is drawn ONCE at construction
    from the schedule's own seeded RNG (so attaching it perturbs no
    consumer RNG stream), and the events ride the shared virtual clock
    (so seeded runs replay bit-identically).  This deliberately does
    NOT reuse the simulator's legacy ``fail`` kind — that handler
    re-arms itself from the simulator RNG unconditionally, which a
    deterministic plan must not trigger."""

    FAIL_KIND = "efail"
    REPAIR_KIND = "erepair"

    def __init__(self, failures: Sequence[Tuple[float, int]],
                 repair_s: float = 5.0):
        """``failures`` — explicit ``(time, target index)`` pairs;
        ``repair_s`` — downtime per failure (the repair event is pushed
        by the fail handler, so overlapping plans stay well-formed)."""
        if repair_s < 0.0:
            raise ValueError(f"repair_s must be >= 0, got {repair_s}")
        self.failures: Tuple[Tuple[float, int], ...] = tuple(
            sorted((float(t), int(idx)) for t, idx in failures))
        for t, _ in self.failures:
            if t < 0.0:
                raise ValueError(f"failure time must be >= 0, got {t}")
        self.repair_s = float(repair_s)
        self._on_fail: Optional[Callable[[float, int], None]] = None
        self._on_repair: Optional[Callable[[float, int], None]] = None
        self._n_targets = 0
        #: injected-event counters (observability; deterministic)
        self.n_failed = 0
        self.n_repaired = 0

    @classmethod
    def poisson(cls, *, seed: int, mtbf_s: float, n_targets: int,
                horizon_s: float, repair_s: float = 5.0,
                max_failures: Optional[int] = None) -> "FailureSchedule":
        """Draw a Poisson fail plan (exponential inter-failure times per
        target) from a dedicated seeded RNG, truncated at ``horizon_s``
        and optionally ``max_failures`` — the stochastic-but-replayable
        construction benches use."""
        if mtbf_s <= 0.0:
            raise ValueError(f"mtbf_s must be > 0, got {mtbf_s}")
        rng = np.random.default_rng(seed)
        events: List[Tuple[float, int]] = []
        for idx in range(int(n_targets)):
            t = float(rng.exponential(mtbf_s))
            while t < horizon_s:
                events.append((t, idx))
                t += repair_s + float(rng.exponential(mtbf_s))
        events.sort()
        if max_failures is not None:
            events = events[:int(max_failures)]
        return cls(events, repair_s=repair_s)

    def attach(self, runtime, *, on_fail: Callable[[float, int], None],
               on_repair: Callable[[float, int], None],
               n_targets: int) -> "FailureSchedule":
        """Register the ``efail``/``erepair`` handlers on ``runtime``
        and push every planned failure whose target index is in range.
        ``on_fail(t, idx)`` / ``on_repair(t, idx)`` are the consumer's
        workload-specific reactions (drain a replica, requeue a host's
        executors); the schedule owns the repair timing."""
        self._on_fail = on_fail
        self._on_repair = on_repair
        self._n_targets = int(n_targets)
        self._runtime = runtime
        runtime.on(self.FAIL_KIND, self._handle_fail)
        runtime.on(self.REPAIR_KIND, self._handle_repair)
        for t, idx in self.failures:
            if 0 <= idx < self._n_targets:
                runtime.push(t, self.FAIL_KIND, idx)
        return self

    def _handle_fail(self, t: float, idx: int):
        self.n_failed += 1
        if self._runtime.tracer is not None:
            self._runtime.tracer.instant(
                "efail", t, process="runtime", thread="failures",
                args={"target": idx})
        self._on_fail(t, idx)
        self._runtime.push(t + self.repair_s, self.REPAIR_KIND, idx)

    def _handle_repair(self, t: float, idx: int):
        self.n_repaired += 1
        if self._runtime.tracer is not None:
            self._runtime.tracer.instant(
                "erepair", t, process="runtime", thread="failures",
                args={"target": idx})
        self._on_repair(t, idx)

    def __repr__(self) -> str:
        return (f"FailureSchedule({len(self.failures)} failures, "
                f"repair_s={self.repair_s})")


# ---------------------------------------------------------------------------
# Autoscaler: replica spawn/drain from sustained trends
# ---------------------------------------------------------------------------

class Autoscaler:
    """Decides replica scale-up/scale-down from *sustained* signals —
    a single bursty sample never flaps the fleet.

    Signals (both already measured by the engine): queue depth per
    active replica (pending + in-transit load) and windowed SLO
    attainment of recently finished requests.  ``observe`` returns
    ``"up"`` / ``"down"`` / ``"hold"``; the consumer owns the actual
    spawn/drain mechanics (the engine pre-provisions ``max_replicas``
    Nodes and flips ``Node.up``).  Streak counters reset after each
    action, so consecutive scale-ups need ``sustain`` fresh samples
    each."""

    KIND = "autoscale"

    def __init__(self, *, max_replicas: int, min_replicas: int = 1,
                 interval_s: float = 1.0,
                 scale_up_queue: float = 4.0,
                 scale_down_queue: float = 0.5,
                 slo_floor: float = 0.9, sustain: int = 3,
                 window: int = 32):
        if max_replicas < 1 or min_replicas < 1 \
                or min_replicas > max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if interval_s <= 0.0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        self.max_replicas = int(max_replicas)
        self.min_replicas = int(min_replicas)
        self.interval_s = float(interval_s)
        self.scale_up_queue = float(scale_up_queue)
        self.scale_down_queue = float(scale_down_queue)
        self.slo_floor = float(slo_floor)
        self.sustain = int(sustain)
        self.window = int(window)
        self._slo: List[bool] = []
        self._up_streak = 0
        self._down_streak = 0
        #: decision log: (t, action, queue_per_replica, attainment)
        self.decisions: List[Tuple[float, str, float, float]] = []

    # --- signal feeds ----------------------------------------------------
    def observe_finished(self, ok: bool) -> None:
        """One finished request's SLO verdict into the sliding window."""
        self._slo.append(bool(ok))
        if len(self._slo) > self.window:
            del self._slo[:len(self._slo) - self.window]

    def attainment(self) -> float:
        """Windowed SLO attainment; full attainment with no history."""
        if not self._slo:
            return 1.0
        return sum(self._slo) / len(self._slo)

    # --- the decision ----------------------------------------------------
    def observe(self, now: float, *, queue_depth: float,
                active: int) -> str:
        """Fold one periodic sample and return the action.  Scale-up
        pressure: queue depth per active replica at/above
        ``scale_up_queue`` OR attainment below ``slo_floor``; scale-down
        calm: per-replica depth at/below ``scale_down_queue`` AND
        attainment healthy AND more than ``min_replicas`` active."""
        per = float(queue_depth) / max(int(active), 1)
        attain = self.attainment()
        if (per >= self.scale_up_queue or attain < self.slo_floor) \
                and active < self.max_replicas:
            self._up_streak += 1
            self._down_streak = 0
        elif per <= self.scale_down_queue and attain >= self.slo_floor \
                and active > self.min_replicas:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        action = "hold"
        if self._up_streak >= self.sustain:
            action = "up"
            self._up_streak = 0
        elif self._down_streak >= self.sustain:
            action = "down"
            self._down_streak = 0
        self.decisions.append((float(now), action, per, attain))
        return action

    def __repr__(self) -> str:
        return (f"Autoscaler({self.min_replicas}.."
                f"{self.max_replicas}, interval={self.interval_s}s)")


def pick_spawn_node(candidates: Sequence[int], topology=None
                    ) -> Optional[int]:
    """Which inactive replica Node to spawn: with a topology bound,
    prefer the node whose ingress path has the most residual fair-share
    bandwidth (spawn on the rack with uplink headroom — a replica that
    cannot be fed is no relief); ties and the no-topology case take the
    lowest node id (seeded determinism)."""
    cands = sorted(int(c) for c in candidates)
    if not cands:
        return None
    if topology is None or getattr(topology, "ingress", None) is None:
        return cands[0]
    def headroom(nid: int) -> float:
        name = f"n{nid}"
        if not topology.has_node(name):
            return -1.0
        try:
            return float(topology.path_residual_gbps(
                topology.ingress, name))
        except KeyError:
            return -1.0
    return max(cands, key=lambda nid: (headroom(nid), -nid))
