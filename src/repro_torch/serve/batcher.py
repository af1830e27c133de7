"""Step-level vector admission for continuous batching.

``launch/serve.py``'s wave mode asks the admission controller ONCE —
"how many requests fit?" — and serves fixed waves.  This module asks the
same question **every decode step**, through the same
:class:`~repro_torch.sched.admission.AdmissionController` /
:class:`~repro_torch.sched.resources.DemandModel` /
:class:`~repro_torch.sched.resources.ResourceVector` machinery:

* per-request demand is a calibrated curve over the *live* context
  length ``prompt_len + tokens_decoded`` — weights amortized once,
  KV-cache growing one token per step (:class:`ServingDemand`);
* joins go through the controller's binding-axis inverse: the marginal
  demand of admitting the first ``u`` pending requests is a monotone
  :class:`PrefixCurve` per axis, wrapped in a :class:`DemandModel` and
  inverted under the step's *headroom* vector — exactly the
  ``admit_batch`` code path, so the decision records the binding axis
  and ``forced`` the same way;
* when next step's KV growth would breach the budget, the batcher
  preempts lowest-priority running requests (last in placement order,
  evict-and-requeue with recompute) until the step fits — or flags the
  step ``forced`` when even a single request is over budget (a server
  must make progress).

The booked footprint here is the *modeled* demand — the paged-KV view
where a request occupies ``kv(context)`` — which is what admission
decides on; a dense-cache execution backend may additionally round
capacity up to its padding bucket (see ``serve/backends.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.experts import MemoryFunction
from repro_torch.sched.admission import AdmissionController
from repro_torch.sched.elastic import shrink_vector
from repro_torch.sched.placement import PlacementPolicy, get_placement
from repro_torch.sched.resources import DemandModel, ResourceVector
from repro_torch.sched.tenancy import (TenantRegistry, pack_step,
                                 request_origin)
from repro_torch.serve.request import Request

_EPS = 1e-9


class PrefixCurve:
    """Monotone piecewise-linear curve through the cumulative demand of
    an *ordered* candidate list: ``fn(u)`` is the demand of admitting the
    first ``u`` candidates (linear between whole requests), ``inverse(y)``
    the largest ``u`` whose prefix fits ``y``.  Duck-types
    :class:`~repro_torch.core.experts.MemoryFunction` so it plugs straight into
    :class:`~repro_torch.sched.resources.DemandModel` and the controller's
    binding-axis inverse."""

    family = "prefix"

    def __init__(self, costs: Sequence[float]):
        costs = [float(c) for c in costs]
        if any(c < 0 for c in costs):
            raise ValueError("per-request demands must be >= 0")
        self._cum = np.concatenate([[0.0], np.cumsum(costs)])

    def __call__(self, u) -> float:
        u = float(np.clip(u, 0.0, len(self._cum) - 1))
        return float(np.interp(u, np.arange(len(self._cum)), self._cum))

    def inverse(self, y: float, x_hint: float = 1.0) -> float:
        y = float(y)
        if y < 0:
            return 0.0
        if y >= self._cum[-1] - _EPS:
            # every candidate fits: the curve is exhausted, not unbounded
            return float(len(self._cum) - 1)
        k = int(np.searchsorted(self._cum, y + _EPS, side="right") - 1)
        span = self._cum[k + 1] - self._cum[k]
        frac = (y - self._cum[k]) / span if span > _EPS else 0.0
        return float(k + min(max(frac, 0.0), 1.0 - 1e-12))


#: axes ServingDemand computes itself — an estimator must not leak
#: these through ``extra_axes`` (it would silently overwrite the KV
#: and staging terms in ``request_vector``)
RESERVED_AXES = ("hbm", "host_ram")


@dataclass
class ServingDemand:
    """Per-request serving footprint derived from a calibrated demand
    model (the ``kv-growth`` estimator in ``repro_torch.sched.estimator``):
    the affine footprint-vs-batch fit at ``max_len`` gives weights
    (intercept, amortized across the batch) and KV at full length
    (slope), from which the per-token KV slice follows.  ``extra_axes``
    carries any other per-request side-car constants (e.g. ``net``
    egress bandwidth) the estimate predicted.

    ``page_size > 1`` books **page-quantized** KV — a request holding
    ``c`` context tokens occupies ``ceil(c / page) * page`` KV slots,
    matching the paged backends' physical allocation granularity
    (``page_size = 1`` is the exact dense-token model and keeps every
    pre-paging schedule bit-identical)."""

    weights_gb: float           # resident once, however many requests
    kv_gb_per_token: float      # per request, per context token
    host_ram_per_req_gb: float = 0.0  # pinned host staging per request
    extra_axes: Dict[str, float] = field(default_factory=dict)
    page_size: int = 1          # KV allocation granularity in tokens
    #: demand-vs-slowdown curve for spill-aware shrunken joins
    #: (:class:`~repro_torch.sched.elastic.SlowdownCurve`); None = not
    #: shrinkable.  ``from_estimate`` carries the estimator's curve
    #: through; direct constructions opt in explicitly.
    shrink: Optional[object] = None

    def __post_init__(self):
        leaked = sorted(set(self.extra_axes) & set(RESERVED_AXES))
        if leaked:
            raise ValueError(
                f"extra_axes must not carry reserved axes {leaked} — "
                f"hbm/host_ram are computed from kv_gb_per_token and "
                f"host_ram_per_req_gb; a leaking estimator would "
                f"silently overwrite them")
        if int(self.page_size) < 1:
            raise ValueError(f"page_size must be >= 1, "
                             f"got {self.page_size}")
        self.page_size = int(self.page_size)

    @classmethod
    def from_demand_model(cls, dm: DemandModel, max_len: int,
                          page_size: int = 1) -> "ServingDemand":
        fn = dm.primary_fn
        if fn is None or getattr(fn, "family", None) != "affine":
            raise ValueError(
                "ServingDemand needs an affine footprint-vs-batch fit "
                "on the primary axis (the kv-growth estimator)")
        host = dm.curves.get("host_ram")
        extra = {a: float(c.b) for a, c in dm.curves.items()
                 if a not in (dm.primary_axis, "host_ram")}
        return cls(weights_gb=float(fn.m),
                   kv_gb_per_token=float(fn.b) / float(max_len),
                   host_ram_per_req_gb=float(host.b)
                   if host is not None else 0.0,
                   extra_axes=extra, page_size=page_size)

    @classmethod
    def from_estimate(cls, estimate, max_len: int) -> "ServingDemand":
        """Build from a :class:`~repro_torch.sched.estimator.DemandEstimate`
        (the registry path: ``get_estimator("kv-growth").estimate(
        ModelTarget(cfg, max_len, ...))``).  The estimator's declared
        page size carries through, so booked demand is quantized the
        way the paged backend actually allocates."""
        sd = cls.from_demand_model(
            estimate.model, max_len,
            page_size=int(estimate.info.get("page_size", 1)))
        sd.shrink = getattr(estimate, "shrink", None)
        return sd

    def kv_gb(self, tokens: int) -> float:
        """KV footprint of ``tokens`` context tokens, rounded up to the
        allocation granularity (whole pages)."""
        pages = -(-max(int(tokens), 0) // self.page_size)
        return self.kv_gb_per_token * pages * self.page_size

    def per_request_axes(self) -> Dict[str, float]:
        """Per-request side-car constants on every non-KV axis (what a
        request pins regardless of its context length)."""
        axes = dict(self.extra_axes)
        if self.host_ram_per_req_gb > 0.0:
            axes["host_ram"] = self.host_ram_per_req_gb
        return axes

    def request_vector(self, req: Request, extra_tokens: int = 0
                       ) -> ResourceVector:
        """Marginal demand of ``req`` holding ``context + extra_tokens``
        KV slots (weights excluded — they are booked once, below)."""
        axes = {"hbm": self.kv_gb(req.context_len + extra_tokens)}
        if self.host_ram_per_req_gb > 0.0:
            axes["host_ram"] = self.host_ram_per_req_gb
        axes.update(self.extra_axes)
        return ResourceVector(**axes)

    def booked(self, running: Sequence[Request], extra_tokens: int = 0
               ) -> ResourceVector:
        """Total modeled footprint of the running set after each request
        grows by ``extra_tokens``."""
        total = ResourceVector(hbm=self.weights_gb)
        for r in running:
            total = total + self.request_vector(r, extra_tokens)
        return total


@dataclass(frozen=True)
class StepDecision:
    """What the batcher decided for one decode step — the step-level
    analogue of :class:`~repro_torch.sched.admission.AdmissionDecision`."""
    step: int
    t: float
    admitted: Tuple[int, ...]       # rids joining this step
    preempted: Tuple[int, ...]      # rids evicted-and-requeued
    batch: int                      # running batch size after the plan
    booked: ResourceVector          # modeled footprint after the plan
    budget: ResourceVector
    binding_axis: Optional[str]     # axis that bound the join inverse
    forced: bool                    # step proceeds over budget
    forced_axes: Tuple[str, ...] = ()
    #: rids running over budget under the progress floor — the ONE
    #: forced-admission record shape shared by the continuous batcher
    #: and the legacy wave path (which used to flag the step without
    #: saying which requests were forced)
    forced_rids: Tuple[int, ...] = ()
    node: int = 0                   # replica Node the step ran on
    #: candidates that wanted to join this step but were declined —
    #: with the axis that bound the join inverse and how far short the
    #: headroom fell of admitting ONE more (the structured reject
    #: reason; 0 / None / 0.0 when everything offered was admitted)
    rejected: int = 0
    reject_axis: Optional[str] = None
    reject_deficit: float = 0.0
    #: declined candidates by rid, and the requeue-vs-new origin split
    #: (a declined candidate that has run before is preemption churn,
    #: not fresh demand — per-tenant reject accounting needs the two
    #: apart; ``rejected == rejected_new + rejected_requeue``)
    rejected_rids: Tuple[int, ...] = ()
    rejected_new: int = 0
    rejected_requeue: int = 0
    #: spill-aware shrunken joins this step: ``(rid, fraction,
    #: slowdown)`` per request admitted below its full memory demand —
    #: the engine registers these grants (the request keeps the
    #: fraction until it retires or is evicted) and charges the
    #: modeled slowdown into the step's decode time
    shrunk: Tuple[Tuple[int, float, float], ...] = ()

    @property
    def over_budget(self) -> bool:
        return not self.booked.fits(self.budget)


class ContinuousBatcher:
    """Re-decides batch membership every decode step.

    ``plan_step`` is pure planning — it mutates nothing; the engine
    applies the returned :class:`StepDecision` (evictions, joins) to the
    queue and the execution backend.  Invariants (pinned by
    ``tests/test_serve.py``):

    * the booked footprint never exceeds the budget on any axis at any
      step unless the decision is ``forced``;
    * ``forced`` only ever covers the single-request floor — a forced
      step runs exactly one request (the progress guarantee of
      ``admit_batch(min_batch=1)``);
    * planning is deterministic given (running, pending, now).
    """

    def __init__(self, demand: ServingDemand, budget: ResourceVector,
                 controller: Optional[AdmissionController] = None,
                 placement: Union[str, PlacementPolicy] = "fcfs",
                 max_batch: int = 64, node: int = 0,
                 tenancy: Optional[TenantRegistry] = None,
                 elastic: Optional[object] = None):
        if "hbm" not in budget:
            raise ValueError("serving budget must carry the hbm axis")
        if budget["hbm"] <= 0:
            raise ValueError("hbm budget must be positive")
        self.demand = demand
        self.budget = budget
        self.controller = controller or AdmissionController()
        self.placement = get_placement(placement) \
            if isinstance(placement, str) else placement
        self.max_batch = int(max_batch)
        self.node = int(node)       # replica id stamped on decisions
        #: with a TenantRegistry bound, joins run the weighted-DRF
        #: knapsack (sched.tenancy.pack_step) and evictions pick the
        #: highest-weighted-share tenant's lowest-priority request;
        #: None (the default) keeps the legacy FIFO-prefix plan
        #: bit-identical
        self.tenancy = tenancy
        #: an :class:`~repro_torch.sched.elastic.ElasticController` enables
        #: spill-aware shrunken joins on the legacy FIFO path: a
        #: declined candidate may be admitted at a memory fraction the
        #: demand's shrink curve prices under the slowdown cap.  None
        #: (the default) keeps every plan bit-identical.
        self.elastic = elastic
        #: live shrink grants — rid -> (fraction, slowdown, granted
        #: vector).  The granted vector is FROZEN at admission: as the
        #: request's context grows, it spills more (the modeled
        #: slowdown already paid for spill) instead of pressuring the
        #: budget — a growing grant sized to exact headroom would be
        #: evicted the very next step.  Owned by this batcher but
        #: MUTATED by the engine: grants from a plan's ``shrunk`` tuple
        #: are registered on apply (see ``register_shrunk``) and
        #: dropped on eviction / retirement / replica failure.
        self.shrunk: Dict[int, Tuple[float, float, ResourceVector]] = {}

    def register_shrunk(self, req: Request, fraction: float,
                        slowdown: float) -> None:
        """Freeze a plan's shrink grant: book ``fraction`` x the join
        vector at the admission-time context for as long as the request
        runs.  Called by the engine when applying a plan."""
        self.shrunk[req.rid] = (float(fraction), float(slowdown),
                                shrink_vector(self._join_vector(req),
                                              float(fraction)))

    # --- planning ---------------------------------------------------------
    def plan_step(self, running: Sequence[Request],
                  pending: Sequence[Request], now: float, step: int
                  ) -> StepDecision:
        """Plan the next decode step: evictions first (KV growth must
        fit), then joins through the controller's binding-axis inverse
        under the remaining headroom.  ``pending`` must already be in
        placement order (the queue's job)."""
        running = list(running)
        preempted: List[int] = []
        forced = False
        forced_axes: Tuple[str, ...] = ()
        forced_rids: Tuple[int, ...] = ()

        # 1. next step's KV growth: evict until it fits.  Untenanted:
        # lowest-priority first (reverse placement order).  With a
        # registry bound, the highest-weighted-share tenant pays first
        # and placement picks WHICH of its requests (its lowest
        # priority) — recomputed per eviction, since shares shift as
        # usage shrinks.
        victims = list(reversed(self.placement.order_jobs(running,
                                                          now=now)))
        while running and not self._booked(running, 1).fits(
                self.budget):
            if len(running) == 1:
                # the progress floor: one request runs even over budget
                forced = True
                forced_axes = self._violated(running, 1)
                forced_rids = (running[0].rid,)
                break
            v = victims.pop(0) if self.tenancy is None \
                else self._drf_victim(running, now)
            running.remove(v)
            preempted.append(v.rid)

        # 2. join new prefills under the post-eviction headroom
        admitted: List[int] = []
        binding: Optional[str] = None
        rejected = 0
        reject_axis: Optional[str] = None
        reject_deficit = 0.0
        rejected_rids: Tuple[int, ...] = ()
        rejected_new = 0
        rejected_requeue = 0
        shrunk_new: List[Tuple[int, float, float]] = []
        slots = self.max_batch - len(running)
        # running and pending are disjoint by contract (a victim is only
        # requeued AFTER the plan is applied), so a just-evicted request
        # can never be re-admitted within the same plan
        assert not preempted or \
            not {r.rid for r in pending} & set(preempted)
        # the knapsack sees the WHOLE pending set (it may skip an
        # oversized head and admit smaller work behind it); the legacy
        # prefix inverse only ever looks at the first ``slots``
        if self.tenancy is not None and slots > 0:
            cands = list(pending)
        else:
            cands = list(pending)[:slots] if slots > 0 else []
        if cands and not forced and self.tenancy is not None:
            headroom = self.budget.headroom(
                self._booked(running, 1))
            usage = self._tenant_usage(running)
            picked, skips = pack_step(
                self.tenancy, cands, headroom, self.budget, usage,
                self._join_vector, slots)
            if not picked and not running and pending:
                # nothing runs and nothing fits: forced single admission
                # of the first candidate the DRF order offered (the
                # lowest-share tenant's head), same progress floor as
                # the legacy path
                frid = skips[0].rid if skips else cands[0].rid
                first = next(r for r in cands if r.rid == frid)
                picked = [first]
                skips = [s for s in skips if s.rid != frid]
                forced = True
                forced_axes = self._violated([first], 2)
                forced_rids = (first.rid,)
            admitted = [r.rid for r in picked]
            running.extend(picked)
            rejected = len(skips)
            if skips:
                top = max(
                    (s for s in skips if s.axis is not None),
                    key=lambda s: s.deficit, default=None)
                reject_axis = top.axis if top else None
                reject_deficit = top.deficit if top else 0.0
                rejected_rids = tuple(s.rid for s in skips)
                rejected_new = sum(1 for s in skips
                                   if s.origin == "new")
                rejected_requeue = rejected - rejected_new
        elif cands and not forced:
            headroom = self.budget.headroom(
                self._booked(running, 1))
            jd = self._join_demand(cands)
            dec = self.controller.admit(
                jd, headroom, cap=float(len(cands)), book=False)
            n = int(np.floor(dec.units + 1e-9))
            binding = dec.binding_axis
            admitted = [r.rid for r in cands[:n]]
            running.extend(cands[:n])
            if not running and pending:
                # nothing runs and nothing fits: forced single admission
                # (admit_batch's min_batch=1 progress guarantee)
                first = cands[0]
                running.append(first)
                admitted = [first.rid]
                forced = True
                forced_axes = self._violated(running, 2)
                forced_rids = (first.rid,)
            rejected = max(len(cands) - len(admitted), 0)
            if rejected and self.elastic is not None and not forced:
                # spill-aware second chance: walk the declined suffix
                # and admit what the shrink curve prices under the
                # slowdown cap (appends to admitted/running in place).
                # Room is the PRE-join headroom minus the admitted
                # prefix's join demand — the inverse charged joiners at
                # context+2, so charging them through _booked (which
                # sees them at +1) would overshoot the budget.
                used = jd.demand(float(len(admitted)))
                room = ResourceVector(**{
                    a: max(headroom[a] - used.get(a, 0.0), 0.0)
                    for a in headroom.axes})
                shrunk_new = self._shrink_joins(
                    running, cands[len(admitted):], admitted, room)
                rejected = len(cands) - len(admitted)
            if rejected:
                # reject reason: axis and deficit of admitting ONE more
                # candidate than actually joined, against the headroom
                # the inverse saw
                need = jd.demand(float(len(admitted) + 1))
                overs = {a: float(v - headroom[a])
                         for a, v in need.items()
                         if a in headroom and v > headroom[a] + _EPS}
                reject_axis = dec.binding_axis or (
                    max(overs, key=overs.get) if overs else None)
                reject_deficit = overs.get(reject_axis, 0.0)
                taken = set(admitted)
                declined = [r for r in cands if r.rid not in taken]
                rejected_rids = tuple(r.rid for r in declined)
                rejected_new = sum(1 for r in declined
                                   if request_origin(r) == "new")
                rejected_requeue = rejected - rejected_new
        elif cands:
            # the eviction floor forced the step: every offered
            # candidate was declined without running the join inverse
            rejected = len(cands)
            reject_axis = forced_axes[0] if forced_axes else None
            rejected_rids = tuple(r.rid for r in cands)
            rejected_new = sum(1 for r in cands
                               if request_origin(r) == "new")
            rejected_requeue = rejected - rejected_new

        # end-of-step footprint: incumbents grow one token; joiners gain
        # two (the prefill-emitted token plus the decode-step token).
        # Live shrink grants (and the ones planned just above) book the
        # granted fraction of the modeled vector.
        joined = set(admitted)
        newly = {rid: f for rid, f, _ in shrunk_new}
        booked = ResourceVector(hbm=self.demand.weights_gb)
        for r in running:
            f = newly.get(r.rid)
            if f is not None:
                # just granted: the frozen vector the engine will book
                vec = shrink_vector(self._join_vector(r), f)
            elif r.rid in self.shrunk:
                vec = self.shrunk[r.rid][2]
            else:
                vec = self.demand.request_vector(
                    r, 2 if r.rid in joined else 1)
            booked = booked + vec
        return StepDecision(
            step=step, t=now, admitted=tuple(admitted),
            preempted=tuple(preempted), batch=len(running),
            booked=booked, budget=self.budget, binding_axis=binding,
            forced=forced, forced_axes=forced_axes,
            forced_rids=forced_rids, node=self.node,
            rejected=rejected, reject_axis=reject_axis,
            reject_deficit=reject_deficit,
            rejected_rids=rejected_rids,
            rejected_new=rejected_new,
            rejected_requeue=rejected_requeue,
            shrunk=tuple(shrunk_new))

    # --- helpers ----------------------------------------------------------
    def _booked(self, running: Sequence[Request], extra_tokens: int
                ) -> ResourceVector:
        """Booked footprint honouring live shrink grants: a request
        admitted at fraction ``f`` occupies ``f`` x its modeled memory
        (the spilled remainder lives off-budget at the modeled slowdown
        price).  With no grants outstanding this is exactly the legacy
        ``demand.booked`` total."""
        if not self.shrunk:
            return self.demand.booked(running, extra_tokens)
        total = ResourceVector(hbm=self.demand.weights_gb)
        for r in running:
            fs = self.shrunk.get(r.rid)
            vec = fs[2] if fs is not None \
                else self.demand.request_vector(r, extra_tokens)
            total = total + vec
        return total

    def _shrink_joins(self, running: List[Request],
                      declined: Sequence[Request],
                      admitted: List[int],
                      headroom: ResourceVector
                      ) -> List[Tuple[int, float, float]]:
        """Walk the declined candidates in placement order and admit
        each at the largest memory fraction the remaining headroom
        covers, when the demand's shrink curve prices that fraction
        under the elastic controller's slowdown cap — the serving twin
        of the simulator's shrunken executors, through the same
        :meth:`AdmissionController.shrink_target` walk.  Mutates
        ``running``/``admitted`` in place; returns the ``(rid,
        fraction, slowdown)`` grants for the engine to register."""
        curve = getattr(self.demand, "shrink", None)
        if curve is None or not getattr(curve, "shrinkable", False):
            return []
        out: List[Tuple[int, float, float]] = []
        for r in declined:
            if len(running) >= self.max_batch:
                break
            need = self._join_vector(r)
            dm = DemandModel(
                {a: MemoryFunction("affine", 0.0, v)
                 for a, v in need.items()},
                primary_axis="hbm")
            dec = self.controller.shrink_target(
                dm, headroom, units=1.0, curve=curve,
                elastic=self.elastic, book=False)
            sh = dec.info.get("shrink") if dec else None
            if not dec or sh is None or \
                    sh["fraction"] >= 1.0 - 1e-12:
                continue
            out.append((r.rid, float(sh["fraction"]),
                        float(sh["slowdown"])))
            admitted.append(r.rid)
            running.append(r)
            grant = shrink_vector(need, float(sh["fraction"]))
            headroom = ResourceVector(**{
                a: max(headroom[a] - grant.get(a, 0.0), 0.0)
                for a in headroom.axes})
        return out

    def _join_demand(self, cands: Sequence[Request]) -> DemandModel:
        """Marginal demand of admitting the first ``u`` ordered
        candidates, as per-axis prefix curves the controller can invert.
        Joiners are charged their full post-step context: the prefill
        emits one token and the decode step a second.  Every per-request
        side-car axis (host staging RAM, net egress) joins as a linear
        curve so it can bind the inverse too."""
        curves: Dict[str, object] = {"hbm": PrefixCurve(
            [self.demand.kv_gb(r.context_len + 2) for r in cands])}
        for axis, per_req in self.demand.per_request_axes().items():
            curves[axis] = MemoryFunction("affine", 0.0, per_req)
        return DemandModel(curves, primary_axis="hbm")

    def _join_vector(self, r: Request) -> ResourceVector:
        """Marginal join demand of one candidate as a single vector:
        post-step KV at ``context + 2`` (the prefill-emitted token plus
        the decode-step token) plus every per-request side-car axis —
        the same costs the prefix curve charges, in the form the
        knapsack subtracts from headroom."""
        axes = {"hbm": self.demand.kv_gb(r.context_len + 2)}
        axes.update(self.demand.per_request_axes())
        return ResourceVector(**axes)

    def _tenant_usage(self, running: Sequence[Request]
                      ) -> Dict[Optional[str], ResourceVector]:
        """This node's per-tenant booked footprint (requests at next
        step's context), the usage the DRF shares score against."""
        usage: Dict[Optional[str], ResourceVector] = {}
        for r in running:
            usage[r.tenant] = usage.get(r.tenant, ResourceVector()) \
                + self.demand.request_vector(r, 1)
        return usage

    def _drf_victim(self, running: Sequence[Request],
                    now: float) -> Request:
        """Eviction choice under tenancy: the request of the tenant
        with the highest weighted dominant share on this node, breaking
        within that tenant (and between tied tenants) toward the last
        request in placement order — fairness picks who pays, placement
        picks which of theirs."""
        order = self.placement.order_jobs(list(running), now=now)
        usage = self._tenant_usage(running)
        shares = {t: self.tenancy.weighted_share_of(t, v, self.budget)
                  for t, v in usage.items()}
        return max(enumerate(order),
                   key=lambda iv: (shares[iv[1].tenant], iv[0]))[1]

    def _violated(self, running: Sequence[Request],
                  extra_tokens: int) -> Tuple[str, ...]:
        booked = self._booked(running, extra_tokens)
        return tuple(a for a, v in booked.items()
                     if a in self.budget and v > self.budget[a] + _EPS)
