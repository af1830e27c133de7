"""Serving-side metrics: TTFT, TPOT, goodput, preemption rate, and the
per-step binding-axis view.

The cluster simulator reports STP/ANTT per job; a serving system is
judged per *token*:

* **TTFT** — time to first token: first decoded token's timestamp minus
  arrival (queueing + prefill; preemption does not reset it).
* **TPOT** — time per output token after the first (decode cadence,
  averaged over each request's stream).
* **goodput** — completed requests' generated tokens per second of
  engine time: tokens of requests that never finished do not count, so
  over-admission that thrashes shows up as a goodput LOSS even though
  raw step throughput looks busy.
* **preemption rate** — evictions per admission (an admission is the
  first join or any re-join after eviction).
* **binding axes** — which resource axis bound each step's join inverse,
  histogrammed exactly like the simulator's per-axis counters, plus
  forced-step and occupancy accounting.  Forced admissions are counted
  from the unified ``StepDecision.forced_rids`` record (the continuous
  floor and the legacy wave path fill the same field).
* **SLO goodput** — tokens per second from completed requests that met
  BOTH their declared deadlines (``Request.ttft_deadline`` /
  ``tpot_deadline``): raw goodput that blows latency targets does not
  count, which is the serving analogue of counting only useful work.
* **node steps** — planned decode steps per replica
  :class:`~repro_torch.sched.cluster.Node` (router observability).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.batcher import StepDecision
from repro_torch.serve.request import Request, RequestState


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q)) if len(xs) \
        else 0.0


class ServingMetrics:
    """Accumulates per-step decisions and per-request lifecycles; the
    engine owns the timestamps (virtual time, so identical seeds give
    identical metrics)."""

    def __init__(self):
        self.steps: List[StepDecision] = []
        self.step_times: List[float] = []
        self.requests: List[Request] = []
        self._admissions = 0
        self._preemptions = 0
        self._forced_steps = 0
        self._forced_admissions = 0
        self.binding_axes: Dict[str, int] = {}
        self.node_steps: Dict[int, int] = {}
        #: completed KV-migration transfer durations (topology runs)
        self.kv_transfer_s: List[float] = []
        #: join candidates declined, histogrammed by the axis that
        #: bound the join inverse ("cap" when no axis was recorded)
        self.rejects_by_axis: Dict[str, int] = {}
        self._rejected_joins = 0
        #: the same declines split by provenance: "new" = first-offer
        #: work that didn't fit (demand mis-prediction), "requeue" =
        #: preempted work bouncing off re-admission (scheduler churn)
        self.rejects_by_origin: Dict[str, int] = {}
        #: per-link utilization (topology runs; see Topology.link_stats)
        self.link_stats: Dict[str, Dict] = {}
        #: per-tenant fairness accounting (tenancy runs; empty dicts
        #: otherwise, so untenanted summaries stay shape-stable)
        self._tenant_shares: Dict[str, List[float]] = {}
        self._tenant_rejects: Dict[str, Dict[str, int]] = {}
        #: elastic-runtime accounting (shrink grants, replica
        #: fail/repair, autoscale up/down).  All zero outside elastic
        #: runs, and the summary only carries an ``elastic`` section
        #: when something fired — flags-off summaries stay
        #: bit-identical to the pre-elastic shape.
        self._shrunk_joins = 0
        self._replica_events: Dict[str, int] = {}

    # --- recording --------------------------------------------------------
    def record_step(self, dec: StepDecision, dt: float) -> None:
        self.steps.append(dec)
        self.step_times.append(float(dt))
        self._admissions += len(dec.admitted)
        self._preemptions += len(dec.preempted)
        if dec.forced:
            self._forced_steps += 1
            # the unified per-request record: which rids ran over budget
            self._forced_admissions += len(dec.forced_rids)
        if dec.binding_axis is not None and dec.admitted:
            self.binding_axes[dec.binding_axis] = \
                self.binding_axes.get(dec.binding_axis, 0) + 1
        rejected = getattr(dec, "rejected", 0)
        if rejected:
            self._rejected_joins += rejected
            axis = getattr(dec, "reject_axis", None) or "cap"
            self.rejects_by_axis[axis] = \
                self.rejects_by_axis.get(axis, 0) + rejected
            new = getattr(dec, "rejected_new", 0)
            requeue = getattr(dec, "rejected_requeue", 0)
            if new or requeue:
                if new:
                    self.rejects_by_origin["new"] = \
                        self.rejects_by_origin.get("new", 0) + new
                if requeue:
                    self.rejects_by_origin["requeue"] = \
                        self.rejects_by_origin.get("requeue", 0) + requeue
        self.node_steps[dec.node] = self.node_steps.get(dec.node, 0) + 1
        shrunk = getattr(dec, "shrunk", ())
        if shrunk:
            self._shrunk_joins += len(shrunk)

    def record_request(self, req: Request) -> None:
        self.requests.append(req)

    def record_migration(self, duration_s: Optional[float]) -> None:
        """A preempted request's KV landed on another replica after
        riding a Transmission for ``duration_s`` virtual seconds."""
        if duration_s is not None:
            self.kv_transfer_s.append(float(duration_s))

    def record_link_stats(self, stats: Dict[str, Dict]) -> None:
        """Attach the topology's end-of-run per-link ledger (busy
        seconds/fraction, GB moved, peak concurrent flows)."""
        self.link_stats = {name: dict(st) for name, st in stats.items()}

    def record_replica_event(self, kind: str) -> None:
        """One elastic-runtime replica event: ``fail`` / ``repair``
        (failure injection) or ``scale_up`` / ``scale_down``
        (autoscaler)."""
        self._replica_events[kind] = self._replica_events.get(kind, 0) + 1

    def record_tenant_share(self, tenant: str, share: float) -> None:
        """One dominant-share sample (usage fraction of the binding
        axis) for a named tenant — the engine samples once per planned
        step on the stepping node."""
        self._tenant_shares.setdefault(tenant, []).append(float(share))

    def record_tenant_reject(self, tenant: Optional[str],
                             origin: str) -> None:
        """One declined join candidate attributed to its tenant, split
        by requeue-vs-new origin (untenanted requests bucket under
        ``""``)."""
        by = self._tenant_rejects.setdefault(tenant or "", {})
        by[origin] = by.get(origin, 0) + 1

    # --- summary ----------------------------------------------------------
    def summary(self, elapsed: Optional[float] = None) -> Dict:
        done = [r for r in self.requests
                if r.state == RequestState.FINISHED]
        elapsed = float(elapsed if elapsed is not None
                        else (self.steps[-1].t + self.step_times[-1]
                              if self.steps else 0.0))
        ttft = [r.first_token_t - r.arrival for r in done
                if r.first_token_t is not None]
        tpot = [(r.finish_t - r.first_token_t) / (r.tokens_decoded - 1)
                for r in done
                if r.finish_t is not None and r.first_token_t is not None
                and r.tokens_decoded > 1]
        good_tokens = sum(r.tokens_decoded for r in done)
        slo_done = [r for r in done if r.meets_slo()]
        slo_tokens = sum(r.tokens_decoded for r in slo_done)
        batches = [d.batch for d in self.steps if d.batch > 0]
        # per-tenant fairness view: goodput / SLO attainment / dominant
        # share per named tenant (empty when no request carries one)
        tnames = sorted({r.tenant for r in self.requests
                         if r.tenant is not None}
                        | set(self._tenant_shares)
                        | {k for k in self._tenant_rejects if k})
        tenants: Dict[str, Dict] = {}
        for name in tnames:
            treqs = [r for r in self.requests if r.tenant == name]
            tdone = [r for r in treqs
                     if r.state == RequestState.FINISHED]
            tslo = [r for r in tdone if r.meets_slo()]
            tgood = sum(r.tokens_decoded for r in tdone)
            tslo_tok = sum(r.tokens_decoded for r in tslo)
            shares = self._tenant_shares.get(name, [])
            tenants[name] = {
                "requests": len(treqs),
                "completed": len(tdone),
                "good_tokens": tgood,
                "goodput_tok_s": tgood / max(elapsed, 1e-12),
                "slo_good_tokens": tslo_tok,
                "slo_goodput_tok_s": tslo_tok / max(elapsed, 1e-12),
                "slo_attainment": len(tslo) / max(len(tdone), 1),
                "dominant_share_mean": float(np.mean(shares))
                if shares else 0.0,
                "dominant_share_peak": float(np.max(shares))
                if shares else 0.0,
                "rejects": dict(self._tenant_rejects.get(name, {})),
            }
        out = {
            "requests": len(self.requests),
            "completed": len(done),
            "steps": len(self.steps),
            "elapsed_s": elapsed,
            "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p95_s": _pct(ttft, 95),
            "tpot_mean_s": float(np.mean(tpot)) if tpot else 0.0,
            "goodput_tok_s": good_tokens / max(elapsed, 1e-12),
            "goodput_req_s": len(done) / max(elapsed, 1e-12),
            "good_tokens": good_tokens,
            # SLO goodput: only tokens of requests that met BOTH
            # deadlines count (requests with no deadlines always do)
            "slo_goodput_tok_s": slo_tokens / max(elapsed, 1e-12),
            "slo_good_tokens": slo_tokens,
            "slo_attainment": len(slo_done) / max(len(done), 1),
            "admissions": self._admissions,
            "preemptions": self._preemptions,
            "preemption_rate": self._preemptions
            / max(self._admissions, 1),
            "forced_steps": self._forced_steps,
            "forced_admissions": self._forced_admissions,
            "mean_batch": float(np.mean(batches)) if batches else 0.0,
            "binding_axes": dict(self.binding_axes),
            "node_steps": dict(self.node_steps),
            "migrations": len(self.kv_transfer_s),
            "kv_transfer_p99_s": _pct(self.kv_transfer_s, 99),
            # structured join-reject accounting (satellite of the obs
            # PR): deterministic, so goldens may pin these too
            "rejected_joins": self._rejected_joins,
            "rejects_by_axis": dict(self.rejects_by_axis),
            "rejects_by_origin": dict(self.rejects_by_origin),
            "links": {name: dict(st)
                      for name, st in self.link_stats.items()},
            "tenants": tenants,
        }
        if self._shrunk_joins or self._replica_events:
            out["elastic"] = {
                "shrunk_joins": self._shrunk_joins,
                "replica_events": dict(self._replica_events),
            }
        return out

    def format_summary(self, s: Optional[Dict] = None) -> str:
        s = s or self.summary()
        axes = " ".join(f"{a}:{n}" for a, n in
                        sorted(s["binding_axes"].items())) or "-"
        return (f"{s['completed']}/{s['requests']} requests in "
                f"{s['elapsed_s']:.2f}s ({s['steps']} steps, mean batch "
                f"{s['mean_batch']:.1f}) | goodput "
                f"{s['goodput_tok_s']:.1f} tok/s | TTFT "
                f"{s['ttft_mean_s'] * 1e3:.0f}ms (p95 "
                f"{s['ttft_p95_s'] * 1e3:.0f}ms) | TPOT "
                f"{s['tpot_mean_s'] * 1e3:.1f}ms | preemptions "
                f"{s['preemptions']} ({s['preemption_rate']:.2f}/adm) | "
                f"forced {s['forced_steps']} | binding [{axes}]")
