"""Budget-inverse admission control (paper Sections 4.1/4.2), over
vector resource budgets.

The paper's runtime decides, per host, how much work to admit from a
predicted memory function: select an expert family, calibrate it on two
small probes, then invert it under the free-memory budget.  This module
owns that loop for every consumer (simulator policies, serving driver),
generalized from a single scalar GB budget to a
:class:`~repro_torch.sched.resources.ResourceVector` over named axes
(``host_ram`` / ``cpu`` / ``hbm`` / ``net``): the admitted unit count is
the **min over per-axis inverses** of a :class:`DemandModel`, and the
decision records which axis bound it.

Since the DemandEstimator redesign the controller is built AROUND an
estimator instance (``repro_torch.sched.estimator`` registry): ``estimate()``
produces the full multi-axis :class:`DemandModel` (with per-axis
confidence and the conservative flag) and ``admit_target()`` runs
estimate -> shade -> binding-axis inverse in one call.  The per-call
curve/scalar APIs below (``admit(fn, budget_gb)``, ``calibrate``) are
DEPRECATED shims kept bit-identical to the PR 2/3 paths: a bare curve
becomes a single-axis demand model, a bare float a single-axis budget
vector, and the same code path runs (goldens pinned by
``tests/test_resources.py`` / ``tests/test_estimator.py``).

Units are deliberately abstract ("units" = M-items for Spark jobs,
concurrent requests for the serving batch) — the controller only cares
that each per-axis curve ``fn(units) -> amount`` is monotone.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import experts
from repro_torch.core.experts import MemoryFunction
from repro_torch.sched.resources import (MEMORY_AXES, DemandModel, ResourceVector,
                                   single_axis)


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of a budget-inverse admission query."""
    units: float          # admitted work units (0 if nothing fits)
    mem_gb: float         # primary-axis booking for those units
    budget_gb: float      # primary-axis shaded budget the inverse ran on
    fn: Optional[MemoryFunction]  # calibrated primary curve (if any)
    info: Dict = field(default_factory=dict)
    binding_axis: Optional[str] = None   # axis that bound the inverse
    #   (None: the caller's cap bound first, or nothing constrained)
    booked: Optional[ResourceVector] = None  # full per-axis booking
    budget: Optional[ResourceVector] = None  # full shaded budget vector

    def __bool__(self) -> bool:
        return self.units > 0.0


class AdmissionController:
    """Owns predict -> two-point-calibrate -> budget-inverse admission.

    Stateless with respect to any particular host or request stream;
    scheduler policies keep one instance and feed it per-decision
    budgets (scalar GB or :class:`ResourceVector`)."""

    def __init__(self, safety_margin: float = 0.0,
                 conservative_factor: float = 0.5,
                 oom_backoff: float = 0.5, max_oom_shifts: int = 3,
                 estimator=None):
        """``estimator`` — a :class:`~repro_torch.sched.estimator.
        DemandEstimator` instance or registry name; when set,
        :meth:`estimate` / :meth:`admit_target` run the full
        predict -> multi-axis-demand -> binding-axis-inverse pipeline
        through it."""
        self.safety_margin = float(safety_margin)
        self.conservative_factor = float(conservative_factor)
        self.oom_backoff = float(oom_backoff)
        self.max_oom_shifts = int(max_oom_shifts)
        if estimator is not None:
            from repro_torch.sched.estimator import resolve_estimator
            estimator = resolve_estimator(estimator)
        self.estimator = estimator

    # --- the estimator pipeline ------------------------------------------
    def estimate(self, target, probes=None, *, rng=None):
        """Predicted multi-axis demand for ``target`` via the attached
        estimator (see ``repro_torch.sched.estimator``)."""
        if self.estimator is None:
            raise RuntimeError(
                "this AdmissionController has no estimator attached — "
                "construct it with estimator=<instance or registry name>")
        return self.estimator.estimate(target, probes, rng=rng)

    def admit_target(self, target, free: Union[float, ResourceVector], *,
                     probes=None, rng=None, cap: float = np.inf,
                     floor: float = 0.0, book: bool = True,
                     safety_margin: Optional[float] = None,
                     oom_count: int = 0,
                     shading: str = "per-axis",
                     info: Optional[Dict] = None) -> AdmissionDecision:
        """The one-call pipeline: estimate the target's multi-axis
        demand, shade the free capacity by the scheduler's risk rules,
        and invert along the binding axis.

        ``shading`` selects the risk model:

        * ``"per-axis"`` (default) — each memory axis's budget is shaded
          by THAT axis's estimate confidence (full confidence leaves the
          axis unshaded, zero confidence reproduces the conservative
          halving, linear in between).  A well-predicted primary curve
          no longer pays for an uncertain side-car, and vice versa.
        * ``"scalar"`` — the deprecated pre-per-axis behaviour: the
          single ``conservative`` flag halves every memory axis.  Kept
          bit-identical (golden-pinned in ``tests/test_cluster.py``).
        """
        est = self.estimate(target, probes, rng=rng)
        if shading == "per-axis":
            budget = self.effective_budget(
                free, safety_margin=safety_margin,
                conservative=est.conservative, oom_count=oom_count,
                confidence=est.confidence)
        elif shading == "scalar":
            import warnings
            warnings.warn(
                "admit_target(shading='scalar') is deprecated — the "
                "default per-axis path shades each memory axis by its "
                "own DemandEstimate confidence",
                DeprecationWarning, stacklevel=2)
            budget = self.effective_budget(
                free, safety_margin=safety_margin,
                conservative=est.conservative, oom_count=oom_count)
        else:
            raise ValueError(f"unknown shading {shading!r} "
                             f"(choose from 'per-axis', 'scalar')")
        merged = {"estimate": est, **(info or {})}
        dec = self.admit(est.model, budget, cap=cap, floor=floor,
                         book=book, info=merged)
        # decision provenance: every admit_target decision records what
        # the inverse actually saw — raw free capacity, the shaded
        # budget, the per-axis confidence that shaded it, and the
        # binding axis.  info is the frozen dataclass's one mutable
        # field, so post-hoc enrichment is the supported idiom.
        dec.info["provenance"] = {
            "free": dict(free.items())
            if isinstance(free, ResourceVector) else float(free),
            "budget": dict(budget.items())
            if isinstance(budget, ResourceVector) else float(budget),
            "confidence": dict(est.confidence),
            "conservative": bool(est.conservative),
            "binding_axis": dec.binding_axis,
        }
        if "reject" in dec.info:
            dec.info["reject"]["confidence"] = dict(est.confidence)
        return dec

    # --- calibration (deprecated shim) -----------------------------------
    def calibrate(self, family: str,
                  probes: Sequence[Tuple[float, float]]) -> MemoryFunction:
        """DEPRECATED shim: estimators calibrate via ``estimate(target,
        probes)`` now; this delegates to the same implementation.
        Instantiate (m, b) from measured (x, y) probes — two probes use
        the paper's exact two-point solve, more fall back to the
        least-squares fit (same families, same guards)."""
        from repro_torch.sched.estimator import _fit_probes
        return _fit_probes(family, probes)

    # --- budget shading --------------------------------------------------
    def effective_budget(self, free: Union[float, ResourceVector], *,
                         safety_margin: Optional[float] = None,
                         conservative: bool = False,
                         oom_count: int = 0,
                         confidence: Optional[Dict[str, float]] = None
                         ) -> Union[float, ResourceVector]:
        """Shade raw free capacity by the scheduler's risk rules: global
        safety margin, the low-confidence conservative fallback (paper
        Section 6.9), and exponential backoff after OOM kills (paper
        Section 2.3).

        On a :class:`ResourceVector`, only the memory axes
        (``host_ram``/``hbm``) are shaded — CPU and link bandwidth are
        average-rate resources where overshoot time-shares rather than
        OOM-kills, so risk shading does not apply.

        ``confidence`` (axis -> [0, 1], a
        :class:`~repro_torch.sched.estimator.DemandEstimate`'s per-axis
        confidence) switches a memory axis from the binary conservative
        halving to a continuous shade::

            factor = conservative_factor + (1 - conservative_factor) * c

        so confidence 1.0 leaves the axis unshaded and confidence 0.0
        reproduces the halving exactly.  Memory axes absent from
        ``confidence`` (and the scalar float path) keep the legacy
        ``conservative`` flag behaviour."""
        margin = self.safety_margin if safety_margin is None \
            else float(safety_margin)
        shifts = min(int(oom_count), self.max_oom_shifts)

        def shade(v: float, conf: Optional[float] = None) -> float:
            budget = float(v) * (1.0 - margin)
            if conf is not None:
                cf = self.conservative_factor
                budget *= cf + (1.0 - cf) * min(max(float(conf), 0.0),
                                                1.0)
            elif conservative:
                budget *= self.conservative_factor
            budget *= self.oom_backoff ** shifts
            return budget

        if isinstance(free, ResourceVector):
            conf = confidence or {}
            return ResourceVector(**{
                a: (shade(v, conf.get(a)) if a in MEMORY_AXES else v)
                for a, v in free.items()})
        return shade(free)

    # --- budget-inverse admission ---------------------------------------
    @staticmethod
    def _normalize(demand: Union[MemoryFunction, DemandModel],
                   budget: Union[float, ResourceVector]
                   ) -> Tuple[DemandModel, ResourceVector]:
        """Scalar back-compat shim: a bare curve becomes a single-axis
        demand model, a bare float a single-axis budget vector on the
        demand's primary axis."""
        if isinstance(demand, DemandModel):
            dm = demand
        else:
            dm = DemandModel.scalar(demand)
        if isinstance(budget, ResourceVector):
            bv = budget
        else:
            bv = single_axis(dm.primary_axis, float(budget))
        return dm, bv

    @staticmethod
    def _book_vector(dm: DemandModel, units: float,
                     bv: ResourceVector) -> ResourceVector:
        """Per-axis booking for ``units``: predicted demand, clamped to
        the budget that admitted it.  Infinite admissions (a curve that
        saturates below its budget, with no cap) book the whole budgeted
        axis — the caller must bound the work some other way."""
        axes: Dict[str, float] = {}
        for a, fn in dm.curves.items():
            if not np.isfinite(units):
                axes[a] = bv[a] if a in bv else 0.0
                continue
            amount = float(fn(units))
            axes[a] = min(amount, bv[a]) if a in bv else amount
        for a, v in dm.fixed.items():
            axes[a] = axes.get(a, 0.0) + v
        return ResourceVector(**axes)

    def admit(self, demand: Union[MemoryFunction, DemandModel],
              budget: Union[float, ResourceVector], *,
              cap: float = np.inf, floor: float = 0.0,
              book: bool = True,
              info: Optional[Dict] = None) -> AdmissionDecision:
        """Largest ``units <= cap`` whose demand fits ``budget`` on every
        budgeted axis (min over per-axis inverses); zero-unit decision
        when that falls below ``floor``.  The decision records the
        ``binding_axis`` — ``None`` when the caller's ``cap`` (or
        nothing) bound first.

        ``book=False`` skips the booked-demand evaluation (``mem_gb``
        reads 0.0, ``booked`` is None) for callers that only size —
        e.g. the simulator's per-(job, host) candidate scan, which books
        separately after adjusting the unit count."""
        dm, bv = self._normalize(demand, budget)
        primary = dm.primary_axis
        budget_gb = float(bv.get(primary, np.inf))
        raw, binding = dm.inverse(bv)
        units = float(min(raw, cap))
        if units < raw:
            binding = None                     # the cap bound first
        if units <= 0.0 or units < floor - 1e-12:
            # structured reject reason: which axis bound, how short the
            # budget falls of the smallest useful grant, so callers /
            # metrics never see a silent zero-unit decision
            info_d = dict(info or {})
            floor_u = max(float(floor), 1.0)
            need = dm.demand(floor_u)
            deficit = {a: float(v - bv[a]) for a, v in need.items()
                       if a in bv and v > bv[a] + 1e-12}
            axis = binding
            if axis is None and deficit:
                axis = max(deficit, key=deficit.get)
            info_d["reject"] = {
                "axis": axis,
                "units": units,
                "floor": float(floor),
                "deficit": deficit,
                # requeue-vs-new provenance: callers that re-offer
                # preempted work pass info={"origin": "requeue"} so
                # per-tenant reject accounting doesn't double-count
                # preemption churn as fresh demand mis-prediction
                "origin": info_d.get("origin", "new"),
            }
            return AdmissionDecision(0.0, 0.0, budget_gb, dm.primary_fn,
                                     info_d, binding, None, bv)
        if book:
            booked = self._book_vector(dm, units, bv)
            mem = booked.get(primary, 0.0)
        else:
            booked, mem = None, 0.0
        return AdmissionDecision(units, mem, budget_gb, dm.primary_fn,
                                 dict(info or {}), binding, booked, bv)

    def shrink_target(self, demand: Union[MemoryFunction, DemandModel],
                      budget: Union[float, ResourceVector], *,
                      units: float, curve, elastic,
                      book: bool = True,
                      info: Optional[Dict] = None) -> AdmissionDecision:
        """Spill-aware shrink admission: when ``units`` of work does NOT
        fit ``budget`` outright, walk the binding memory axis down to
        the largest demand **fraction** that fits, price that fraction
        on the workload's demand-vs-slowdown ``curve``
        (:class:`~repro_torch.sched.elastic.SlowdownCurve`), and let
        ``elastic`` (:class:`~repro_torch.sched.elastic.ElasticController`)
        decide shrink-vs-wait-vs-reject.

        On **shrink** the decision books the shrunken vector — memory
        axes scaled by the granted fraction, average-rate axes (cpu,
        net) unscaled — and carries ``info["shrink"] = {fraction,
        slowdown, axis}``; THE CALLER must charge the slowdown into
        virtual time (executor rate, decode-step cost): a shrunken
        grant runs on less memory by paying time, never silently.  On
        **wait**/**reject** the zero-unit decision carries the usual
        structured ``info["reject"]`` plus ``info["elastic"]`` with the
        verdict, so telemetry can tell "priced too high" from "would
        not fit at any price"."""
        from repro_torch.sched.elastic import ElasticDecision, shrink_vector
        dm, bv = self._normalize(demand, budget)
        primary = dm.primary_axis
        budget_gb = float(bv.get(primary, np.inf))
        units = float(units)
        info_d = dict(info or {})
        need = dm.demand(units)

        def _zero(verdict: ElasticDecision, axis, fraction: float
                  ) -> AdmissionDecision:
            deficit = {a: float(v - bv[a]) for a, v in need.items()
                       if a in bv and v > bv[a] + 1e-12}
            info_d["elastic"] = {"action": verdict.action,
                                 "fraction": float(fraction),
                                 "slowdown": float(verdict.slowdown)}
            info_d["reject"] = {
                "axis": axis, "units": 0.0, "floor": units,
                "deficit": deficit,
                "origin": info_d.get("origin", "new"),
            }
            return AdmissionDecision(0.0, 0.0, budget_gb, dm.primary_fn,
                                     info_d, axis, None, bv)

        # average-rate axes don't shrink: if cpu / link demand already
        # exceeds its budget, no memory cut helps
        for a, v in need.items():
            if a not in MEMORY_AXES and a in bv and v > bv[a] + 1e-12:
                return _zero(ElasticDecision("wait", 0.0, float("inf")),
                             a, 0.0)
        # largest memory fraction that fits = min over budgeted memory
        # axes of budget/demand; the argmin is the binding axis the
        # curve is walked down
        fraction, binding = 1.0, None
        for a, v in need.items():
            if a in MEMORY_AXES and a in bv and v > 1e-12:
                r = float(bv[a]) / float(v)
                if r < fraction:
                    fraction, binding = r, a
        verdict = elastic.decide(curve, fraction)
        if verdict.action != "shrink":
            return _zero(verdict, binding, fraction)
        if book:
            # scale the RAW demand by the granted fraction, THEN clamp
            # to the budget (shrink_vector on a pre-clamped booking
            # would double-shrink the binding axis)
            booked = shrink_vector(need, verdict.fraction)
            booked = ResourceVector(**{
                a: (min(v, bv[a]) if a in bv else v)
                for a, v in booked.items()})
            mem = booked.get(primary, 0.0)
        else:
            booked, mem = None, 0.0
        info_d["shrink"] = {"fraction": float(verdict.fraction),
                            "slowdown": float(verdict.slowdown),
                            "axis": binding}
        return AdmissionDecision(units, mem, budget_gb, dm.primary_fn,
                                 info_d, binding, booked, bv)

    def book(self, fn: MemoryFunction, units: float,
             budget_gb: float) -> float:
        """Primary-axis memory to reserve for ``units``: the predicted
        footprint, never more than the budget that admitted it."""
        return min(float(fn(units)), float(budget_gb))

    def admit_batch(self, demand: Union[MemoryFunction, DemandModel],
                    budget: Union[float, ResourceVector], *,
                    min_batch: int = 1,
                    max_batch: Optional[int] = None) -> AdmissionDecision:
        """Integer variant for request serving: whole requests only,
        always at least ``min_batch`` (a server must make progress even
        when the model barely fits).  When the forced minimum does NOT
        fit the budget, the decision carries ``info['forced'] = True`` so
        callers can log over-budget forced progress instead of booking
        it silently.

        An UNBOUNDED admission (every budgeted curve saturates below its
        budget) requires an explicit ``max_batch`` — silently returning
        a huge batch would be a foot-gun for any non-affine footprint."""
        dm, bv = self._normalize(demand, budget)
        cap = np.inf if max_batch is None else float(max_batch)
        dec = self.admit(dm, bv, cap=cap)
        if not np.isfinite(dec.units):
            fam = dec.fn.family if dec.fn is not None else "?"
            raise ValueError(
                f"unbounded admission: {fam} footprint saturates below "
                f"the {dec.budget_gb} GB {dm.primary_axis} budget — "
                f"pass max_batch")
        n = int(dec.units)
        if max_batch is not None:
            n = min(n, int(max_batch))
        n = max(n, int(min_batch))
        need = dm.demand(n)
        forced_axes = [a for a, v in need.items()
                       if a in bv and v > bv[a] + 1e-9]
        booked = self._book_vector(dm, float(n), bv)
        return AdmissionDecision(
            float(n), booked.get(dm.primary_axis, 0.0), dec.budget_gb,
            dec.fn, {**dec.info, "forced": bool(forced_axes),
                     "forced_axes": forced_axes,
                     "demand": need.as_dict(),
                     "min_batch": min_batch},
            dec.binding_axis, booked, bv)
