"""Multi-tenant fairness: credit-scored tenants, weighted-DRF routing,
and per-node knapsack packing.

At millions-of-users scale admission is per-*tenant*, not per-request: a
noisy neighbor whose demand keeps outrunning its prediction can starve
well-behaved tenants even when aggregate goodput looks healthy.  This
module adds the tenant axis on top of the existing vector-admission
machinery:

* :class:`Tenant` / :class:`TenantRegistry` — the tenant universe, each
  with a provisioned ``weight`` and a live **credit score** computed
  from signals the system already measures (see below).  The registry
  also keeps the per-(tenant, node) usage ledger the fairness policies
  score against.
* :class:`WeightedDRFRouter` (registry name ``drf``) — routes each
  request to the node where its tenant's *weighted dominant share*
  (dominant resource share over the :class:`~repro_torch.sched.resources.
  ResourceVector` axes, divided by the credit-coupled effective weight)
  would be lowest after placement.  With no registry bound it degrades
  exactly to ``least-loaded``.
* :func:`pack_step` — the per-node knapsack packer the continuous
  batcher uses instead of greedy FIFO-prefix joins when a registry is
  bound: candidates are offered in progressive-filling DRF order
  (lowest weighted share first) and any candidate whose marginal demand
  vector fits the remaining per-axis headroom is admitted (greedy-skip),
  so one tenant's oversized head-of-line request can no longer block
  everyone behind it.

**Credit score.**  ``credit(t)`` is the mean of the signal scores that
have data, clamped to ``[min_credit, 1]`` (no signals = full credit):

* *attainment* — the fraction of the tenant's last ``window`` finished
  requests that met their SLO;
* *error budget* — ``1 - miss_frac / error_budget`` clamped to [0, 1]:
  a tenant that spent its allowed miss fraction scores 0;
* *latency* — ``target / p99(observed latency / target)`` over the
  window, clamped to [0, 1]: sustained p99 at 2x target scores 0.5;
* *demand prediction* — ``1 / (1 + fresh_rejects / window)`` where only
  structured rejects with ``origin == "new"`` count (requeue churn from
  preemption is the scheduler's doing, not the tenant's mis-prediction —
  see the ``origin`` field on ``info["reject"]``).

Every score is monotone in its signal and ``effective_weight = weight *
credit``, so a lower credit can only *raise* a tenant's weighted share —
i.e. push it later in the admission order, never earlier (the credit-
monotonicity invariant ``tests/test_tenancy.py`` pins).

``tenants=None`` everywhere (the default) keeps every schedule
bit-identical to the pre-tenancy engine: the batcher runs its legacy
FIFO-prefix join inverse and routers never see a registry.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np

from repro_torch.sched.cluster import Node, Router, _fit_score, register_router
from repro_torch.sched.resources import ResourceVector

_EPS = 1e-12

#: registry key for requests that carry no tenant (they share one
#: default bucket at weight 1.0 so mixed populations stay well-defined)
UNTENANTED = None


def _ew(samples: Sequence[Tuple[float, float]], halflife: float):
    """Exponential-decay weights for timestamped ``(t, value)`` samples:
    weight halves every ``halflife`` virtual seconds behind the newest
    sample."""
    ts = np.asarray([s[0] for s in samples], float)
    vs = np.asarray([float(s[1]) for s in samples], float)
    w = 0.5 ** ((ts.max() - ts) / max(halflife, _EPS))
    return w, vs


def _ew_mean(samples, halflife: float) -> float:
    w, v = _ew(samples, halflife)
    return float(np.sum(w * v) / max(np.sum(w), _EPS))


def _ew_sum(samples, halflife: float) -> float:
    w, v = _ew(samples, halflife)
    return float(np.sum(w * v))


def _ew_percentile(samples, halflife: float, q: float) -> float:
    """Weighted percentile: the smallest value whose cumulative decay
    weight reaches ``q`` percent of the total."""
    w, v = _ew(samples, halflife)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w) / max(float(np.sum(w)), _EPS)
    idx = int(np.searchsorted(cum, q / 100.0, side="left"))
    return float(v[min(idx, len(v) - 1)])


@dataclass(frozen=True)
class Tenant:
    """Provisioned identity: the name requests carry, the fair-share
    ``weight`` operators assign, and the ``error_budget`` — the SLO miss
    fraction the tenant is allowed before its credit starts paying for
    it (SRE-style: 0.1 = one miss in ten is tolerated).

    ``credit_halflife_s`` switches the tenant's credit signals from the
    registry's hard sliding window (a sample counts fully for
    ``window`` events, then vanishes off a cliff) to an exponential
    decay in virtual time: a sample's influence halves every
    ``credit_halflife_s`` seconds, so one bad burst fades smoothly
    instead of dominating the score until it ages out all at once.
    ``None`` (the default) keeps the window behaviour bit-identical."""
    name: str
    weight: float = 1.0
    error_budget: float = 0.1
    credit_halflife_s: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if not 0.0 <= self.error_budget <= 1.0:
            raise ValueError(f"tenant {self.name!r}: error_budget must "
                             f"be in [0, 1], got {self.error_budget}")
        if self.credit_halflife_s is not None \
                and self.credit_halflife_s <= 0.0:
            raise ValueError(f"tenant {self.name!r}: credit_halflife_s "
                             f"must be > 0, "
                             f"got {self.credit_halflife_s}")


class TenantRegistry:
    """The tenant universe plus its live fairness state: sliding-window
    SLO/latency/reject signals feeding :meth:`credit`, and the
    per-(tenant, node) usage ledger feeding :meth:`weighted_share`.

    Signal observation is deterministic (windows are plain deques over
    virtual-time events), so seeded runs with tenants stay bit-identical
    across machines."""

    def __init__(self, tenants: Sequence[Tenant] = (), *,
                 window: int = 64, min_credit: float = 0.05):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 < min_credit <= 1.0:
            raise ValueError(f"min_credit must be in (0, 1], "
                             f"got {min_credit}")
        self.window = int(window)
        self.min_credit = float(min_credit)
        self._tenants: Dict[Optional[str], Tenant] = {}
        # sliding-window signals, per tenant key (None = untenanted)
        self._slo: Dict[Optional[str], deque] = {}
        self._lat_ratio: Dict[Optional[str], deque] = {}
        self._fresh_rejects: Dict[Optional[str], deque] = {}
        self.rejects: Dict[Optional[str], Dict[str, int]] = {}
        # usage ledger: tenant -> node id -> booked vector
        self._usage: Dict[Optional[str], Dict[int, ResourceVector]] = {}
        #: the registry's virtual clock — the max ``now`` any observe
        #: hook has seen.  Half-life tenants stamp their samples with
        #: it; untimed observations reuse the current value (all-equal
        #: stamps degrade the decay to the plain window mean).
        self._clock = 0.0
        for t in tenants:
            self.add(t)

    # --- the tenant universe ---------------------------------------------
    def add(self, tenant: Tenant) -> Tenant:
        if tenant.name in self._tenants:
            raise ValueError(f"tenant {tenant.name!r} already registered")
        self._tenants[tenant.name] = tenant
        return tenant

    def ensure(self, name: Optional[str]) -> Tenant:
        """Get-or-create: unknown names register at default weight, so
        a trace carrying a new tenant never crashes admission."""
        if name not in self._tenants:
            self._tenants[name] = Tenant(name=name or "",
                                         weight=1.0)
        return self._tenants[name]

    def get(self, name: Optional[str]) -> Tenant:
        return self._tenants.get(name) or Tenant(name=name or "")

    def names(self) -> Tuple[Optional[str], ...]:
        return tuple(self._tenants)

    def __contains__(self, name: Optional[str]) -> bool:
        return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    # --- signal observation ----------------------------------------------
    def _win(self, store: Dict, name: Optional[str]) -> deque:
        if name not in store:
            store[name] = deque(maxlen=self.window)
        return store[name]

    def _stamp(self, now: Optional[float]) -> float:
        if now is not None:
            self._clock = max(self._clock, float(now))
        return self._clock

    def _halflife(self, name: Optional[str]) -> Optional[float]:
        return self.get(name).credit_halflife_s

    def _observe(self, store: Dict, name: Optional[str], value,
                 now: Optional[float]) -> None:
        """Append one signal sample: raw value for window tenants
        (bit-identical to the pre-halflife registry), ``(t, value)``
        for half-life tenants.  The window still caps sample COUNT
        either way; the half-life only reweights what is inside it."""
        t = self._stamp(now)
        win = self._win(store, name)
        if self._halflife(name) is not None:
            win.append((t, value))
        else:
            win.append(value)

    def observe_slo(self, name: Optional[str], ok: bool,
                    now: Optional[float] = None) -> None:
        """One finished request's SLO verdict (both deadlines held)."""
        self._observe(self._slo, name, bool(ok), now)

    def observe_latency_ratio(self, name: Optional[str],
                              ratio: float,
                              now: Optional[float] = None) -> None:
        """One observed-latency / target ratio sample (TTFT over its
        deadline); the window's p99 feeds the latency score."""
        self._observe(self._lat_ratio, name, float(ratio), now)

    def observe_reject(self, name: Optional[str],
                       origin: str = "new",
                       now: Optional[float] = None) -> None:
        """One structured join reject.  Only ``origin == "new"`` counts
        toward the demand-prediction score — a requeued (preempted)
        request bouncing off admission is scheduler churn, not the
        tenant mis-declaring its demand."""
        by = self.rejects.setdefault(name, {})
        by[origin] = by.get(origin, 0) + 1
        self._observe(self._fresh_rejects, name, origin == "new", now)

    def observe_request(self, req) -> None:
        """Convenience hook for the engine's retire path: fold one
        finished :class:`~repro_torch.serve.request.Request` into the SLO and
        latency windows (stamped at its finish time, which is what the
        half-life decays against)."""
        self.observe_slo(req.tenant, req.meets_slo(), now=req.finish_t)
        if req.ttft_deadline is not None \
                and req.first_token_t is not None:
            self.observe_latency_ratio(
                req.tenant,
                (req.first_token_t - req.arrival) / req.ttft_deadline,
                now=req.finish_t)

    # --- credit -----------------------------------------------------------
    def credit(self, name: Optional[str]) -> float:
        """The live credit score in ``[min_credit, 1]`` — the mean of
        the signal scores that have data (see the module docstring for
        the formula).  A tenant with no history has full credit."""
        hl = self._halflife(name)
        scores: List[float] = []
        slo = self._slo.get(name)
        if slo:
            attain = _ew_mean(slo, hl) if hl is not None \
                else sum(slo) / len(slo)
            scores.append(attain)
            budget = self.get(name).error_budget
            miss = 1.0 - attain
            scores.append(min(max(1.0 - miss / budget, 0.0), 1.0)
                          if budget > 0.0 else (1.0 if miss == 0.0
                                                else 0.0))
        lat = self._lat_ratio.get(name)
        if lat:
            p99 = _ew_percentile(lat, hl, 99) if hl is not None \
                else float(np.percentile(np.asarray(lat, float), 99))
            scores.append(min(max(1.0 / max(p99, _EPS), 0.0), 1.0))
        rej = self._fresh_rejects.get(name)
        if rej:
            fresh = _ew_sum(rej, hl) if hl is not None else sum(rej)
            scores.append(1.0 / (1.0 + fresh / float(self.window)))
        if not scores:
            return 1.0
        return min(max(float(np.mean(scores)), self.min_credit), 1.0)

    def effective_weight(self, name: Optional[str]) -> float:
        """The credit-coupled DRF weight: provisioned weight times live
        credit, floored away from zero so shares stay finite."""
        return max(self.get(name).weight * self.credit(name), _EPS)

    # --- the usage ledger -------------------------------------------------
    def add_usage(self, name: Optional[str], nid: int,
                  vec: ResourceVector) -> None:
        by_node = self._usage.setdefault(name, {})
        by_node[nid] = by_node.get(nid, ResourceVector()) + vec

    def set_node_usage(self, nid: int,
                       by_tenant: Dict[Optional[str], ResourceVector]
                       ) -> None:
        """Reconcile one node's per-tenant usage (the engine calls this
        from its post-step ledger sync, so the registry's view matches
        the Node claim ledger exactly)."""
        for by_node in self._usage.values():
            by_node.pop(nid, None)
        for name, vec in by_tenant.items():
            self._usage.setdefault(name, {})[nid] = vec

    def usage(self, name: Optional[str],
              nid: Optional[int] = None) -> ResourceVector:
        by_node = self._usage.get(name, {})
        if nid is not None:
            return by_node.get(nid, ResourceVector())
        total = ResourceVector()
        for vec in by_node.values():
            total = total + vec
        return total

    # --- dominant shares --------------------------------------------------
    @staticmethod
    def dominant_share(vec: ResourceVector,
                       capacity: ResourceVector) -> float:
        """The DRF dominant share: max over capacitated axes of the
        tenant's usage fraction (axes the capacity does not carry are
        unconstrained and never dominate)."""
        share = 0.0
        for a, cap in capacity.items():
            if cap > _EPS:
                share = max(share, vec.get(a, 0.0) / cap)
        return share

    def weighted_share_of(self, name: Optional[str], vec: ResourceVector,
                          capacity: ResourceVector) -> float:
        """Dominant share of an explicit usage vector divided by the
        tenant's effective (credit-coupled) weight — the quantity DRF
        minimizes across tenants.  Lower credit divides by less, so the
        share only ever grows (credit monotonicity)."""
        return self.dominant_share(vec, capacity) \
            / self.effective_weight(name)

    def weighted_share(self, name: Optional[str],
                       capacity: ResourceVector,
                       nid: Optional[int] = None) -> float:
        return self.weighted_share_of(name, self.usage(name, nid),
                                      capacity)

    # --- serialization ----------------------------------------------------
    def to_dict(self) -> Dict:
        """Provisioned state only (weights, error budgets, knobs) —
        live signals and usage are runtime state and do not persist."""
        return {
            "window": self.window,
            "min_credit": self.min_credit,
            "tenants": [
                {"name": t.name, "weight": t.weight,
                 "error_budget": t.error_budget,
                 **({"credit_halflife_s": t.credit_halflife_s}
                    if t.credit_halflife_s is not None else {})}
                for k, t in self._tenants.items() if k is not None],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TenantRegistry":
        return cls([Tenant(name=row["name"],
                           weight=float(row.get("weight", 1.0)),
                           error_budget=float(row.get("error_budget",
                                                      0.1)),
                           credit_halflife_s=row.get(
                               "credit_halflife_s"))
                    for row in d.get("tenants", [])],
                   window=int(d.get("window", 64)),
                   min_credit=float(d.get("min_credit", 0.05)))

    def summary(self, capacity: Optional[ResourceVector] = None) -> Dict:
        """Per-tenant live view for CLI tables / metrics: credit,
        effective weight, reject counts, and (with a capacity) the
        current weighted dominant share."""
        out: Dict[str, Dict] = {}
        for key, t in self._tenants.items():
            if key is None:
                continue
            row = {"weight": t.weight,
                   "error_budget": t.error_budget,
                   "credit": self.credit(key),
                   "effective_weight": self.effective_weight(key),
                   "rejects": dict(self.rejects.get(key, {}))}
            if capacity is not None:
                row["weighted_share"] = self.weighted_share(key, capacity)
            out[t.name] = row
        return out


# ---------------------------------------------------------------------------
# weighted-DRF router
# ---------------------------------------------------------------------------

@register_router("drf")
class WeightedDRFRouter(Router):
    """Route to the node where the requesting tenant's weighted dominant
    share would be LOWEST after placement (progressive filling across
    nodes), so each tenant's footprint spreads instead of piling one
    replica full of one tenant.  Ties break on the generic worst-axis
    fit score, then the lowest node id (seeded determinism).

    The runtime binds ``self.tenancy`` (the :class:`TenantRegistry`)
    and ``self.tenant`` (the requesting tenant) before each ``route``
    call — the same late-binding pattern as ``uses_topology``.  With no
    registry bound this router IS ``least-loaded``, which keeps
    ``--router drf`` safe on untenanted deployments."""

    uses_tenancy = True
    tenancy: Optional[TenantRegistry] = None
    tenant: Optional[str] = None

    def route(self, demand, nodes, now=0.0):
        cands = [n for n in nodes if n.up] or list(nodes)
        reg = self.tenancy
        if reg is None:
            return max(cands,
                       key=lambda n: (_fit_score(n, demand), -n.nid))

        def key(n: Node):
            post = reg.usage(self.tenant, n.nid)
            if demand is not None:
                post = post + demand
            share = reg.weighted_share_of(self.tenant, post, n.capacity)
            return (-share, _fit_score(n, demand), -n.nid)
        return max(cands, key=key)


# ---------------------------------------------------------------------------
# per-node knapsack packing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Skip:
    """One candidate the packer offered but declined for lack of
    resources: the axis whose remaining headroom fell shortest and by
    how much (candidates never offered because the batch-slot cap
    filled first produce no Skip — they were not rejected, merely not
    reached this step, matching how the legacy FIFO path treats pending
    work beyond its prefix window)."""
    rid: int
    tenant: Optional[str]
    axis: Optional[str]
    deficit: float
    origin: str                     # "new" | "requeue"


def request_origin(req) -> str:
    """Where a join candidate came from: ``"requeue"`` when it has run
    before (preempted at least once), ``"new"`` on its first offer —
    the distinction per-tenant reject accounting needs to not
    double-count preemption churn."""
    return "requeue" if (req.admissions > 0 or req.preemptions > 0) \
        else "new"


def pack_step(registry: TenantRegistry, cands: Sequence,
              headroom: ResourceVector, capacity: ResourceVector,
              usage: Dict[Optional[str], ResourceVector],
              demand_vec: Callable[[object], ResourceVector],
              slots: int) -> Tuple[List, List[Skip]]:
    """The per-node knapsack: pick which queued requests join this step
    under the node's per-axis ``headroom``, in progressive-filling
    weighted-DRF order, instead of admitting a greedy FIFO prefix.

    Each round offers the next candidate of the tenant with the lowest
    weighted dominant share (``usage`` grows as admissions land, so
    shares re-rank every round; ties break on queue position, keeping
    the plan deterministic).  A candidate whose marginal demand vector
    fits the REMAINING headroom is admitted and subtracted; one that
    does not is skipped with a structured reason — later (smaller)
    candidates, including the same tenant's, are still offered, so the
    pack never admits less than the FIFO prefix would have and never
    exceeds the headroom on any axis.

    ``usage`` is mutated in place (admitted vectors accumulate) so the
    caller's eviction accounting and the join accounting agree."""
    queues: Dict[Optional[str], deque] = {}
    pos: Dict[int, int] = {}
    for i, r in enumerate(cands):
        queues.setdefault(r.tenant, deque()).append(r)
        pos[id(r)] = i
    admitted: List = []
    skips: List[Skip] = []
    used = ResourceVector()
    while queues and len(admitted) < slots:
        tenant = min(
            queues,
            key=lambda t: (registry.weighted_share_of(
                t, usage.get(t, ResourceVector()), capacity),
                pos[id(queues[t][0])]))
        r = queues[tenant].popleft()
        if not queues[tenant]:
            del queues[tenant]
        vec = demand_vec(r)
        if (used + vec).fits(headroom):
            admitted.append(r)
            used = used + vec
            usage[tenant] = usage.get(tenant, ResourceVector()) + vec
        else:
            rem = headroom.headroom(used)
            overs = {a: float(v - rem.get(a, 0.0))
                     for a, v in vec.items()
                     if a in rem and v > rem.get(a, 0.0) + 1e-9}
            axis = max(overs, key=overs.get) if overs else None
            skips.append(Skip(r.rid, tenant, axis,
                              overs.get(axis, 0.0), request_origin(r)))
    return admitted, skips
