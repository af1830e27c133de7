"""Event-driven cluster simulator for memory-aware task co-location.

Reproduces the paper's evaluation mechanics: jobs arrive (batch at t=0
FCFS, or as an open arrival stream via ``arrivals=``), profile while
waiting (feature probe + 5%/10% calibration runs, whose processed items
CREDIT the job — no wasted cycles), then a dispatcher spawns executors
on hosts with spare memory and CPU headroom. Memory mis-prediction has
real consequences: moderate over-subscription causes paging (host-wide
slowdown), large overflow OOM-kills the executor and its items are
re-queued (paper Section 2.3).

Admission sizing (predict -> calibrate -> budget-inverse along the
binding axis of a vector budget: primary memory, CPU slack, secondary
axes) is owned by ``repro_torch.sched.admission.AdmissionController`` — the
same controller the serving driver uses.  Queue ordering and host-scan
order come from the ``repro_torch.sched.placement`` registry
(``SimConfig.placement``: fcfs / sjf / best-fit / arrival-aware);
policies only decide the budget each host offers and how to size under
it.

Policies: OURS (mixture-of-experts), QUASAR-like (single ANN estimator),
PAIRWISE (<=2 per host, claims all free memory), ONLINE-SEARCH (probing
overhead), ORACLE (ground truth, no profiling).

Fault tolerance (optional): Poisson host failures re-queue non-check-
pointed work; straggler executors get speculative backups.

Rates are piecewise-constant between events; every host-state change
re-times that host's executors (lazy re-heap with version counters).

Since the ClusterRuntime redesign the event clock, heap, and per-host
booked-capacity ledger live on the shared
``repro_torch.sched.cluster`` substrate (the same one the serving engine's
replicas run on): the simulator registers arrive/profiled/finish/fail
handlers on a :class:`~repro_torch.sched.cluster.ClusterRuntime` and
``Simulator.run`` is a thin shim over ``runtime.run`` — pinned
bit-identical to the pre-runtime loop by ``tests/test_cluster.py``.
"""
from __future__ import annotations

import itertools
import os
import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.experts import MemoryFunction
from repro_torch.core.workloads import AppProfile
# cluster/resources/placement are import-cycle-free (they never import
# repro_torch.core); admission/estimator are NOT — see the lazy imports in
# Policy.__init__ / Policy.bind
from repro_torch.sched.cluster import ClusterRuntime, ClusterState, Node
from repro_torch.sched.placement import get_placement
from repro_torch.sched.resources import DemandModel, ResourceVector

if TYPE_CHECKING:  # runtime import is lazy: repro_torch.sched.admission
    # imports repro_torch.core (experts), so importing it back at module
    # scope would be circular when repro_torch.sched loads first
    from repro_torch.sched.admission import AdmissionController
    from repro_torch.sched.estimator import DemandEstimate


def _default_placement() -> str:
    # benchmarks/run.py --placement selects the queue/host-scan order
    # for every SimConfig a bench module builds, without threading an
    # argument through each of them
    return os.environ.get("REPRO_PLACEMENT", "fcfs")


def _default_estimator() -> str:
    # benchmarks/run.py --estimator sweeps the demand estimator the same
    # way; "" means "wrap the policy's own predictor" (the faithful
    # bit-identical default)
    return os.environ.get("REPRO_ESTIMATOR", "")


@dataclass
class SimConfig:
    n_hosts: int = 40
    host_mem_gb: float = 64.0
    paging_slowdown: float = 8.0
    oom_overflow_frac: float = 0.25   # overflow beyond this -> OOM kill
    oom_waste_frac: float = 0.10      # runtime wasted by a killed executor
    profile_frac_lo: float = 0.08     # profiling time as a fraction of C_is
    profile_frac_hi: float = 0.15
    # items processed during profiling run at SINGLE-executor rate and
    # credit the job (paper: "no computing cycle is wasted") — a small,
    # honest credit, not a head start.
    profile_single_host: bool = True
    safety_margin: float = 0.0
    min_alloc_gb: float = 2.0
    tasks_per_slot: int = 4           # Spark task granularity per host slot
    pairwise_default_heap: float = 0.5  # primary executor's default claim
    cpu_slack: float = 1.15           # admit while sum(load) <= slack
    #   (loads are AVERAGES; transient >100% just time-shares — the
    #    proportional slowdown model charges for it)
    online_search_eta: float = 0.30   # ONLINE-SEARCH probe overhead
    online_alloc_lo: float = 0.65     # ONLINE-SEARCH allocation quality
    # fault tolerance
    failures: bool = False
    host_mtbf_s: float = 0.0          # 0 -> no failures
    repair_time_s: float = 300.0
    checkpoint_interval_s: float = 60.0
    straggler_prob: float = 0.0
    straggler_factor: float = 0.35
    speculative_backup: bool = True
    max_sim_time: float = 1e9
    # --- vector-resource admission ------------------------------------
    # The axis ``host_mem_gb`` capacitates and the calibrated memory
    # function predicts.  The paper's clusters budget host RAM; the
    # TPU-jobs universe budgets pod HBM (primary_axis="hbm") with host
    # staging RAM as a secondary axis in extra_capacity.
    primary_axis: str = "host_ram"
    # additional per-host axis capacities, e.g. {"host_ram": 96.0} when
    # the primary axis is hbm; jobs demand them via AppProfile.aux_demand
    extra_capacity: Dict[str, float] = field(default_factory=dict)
    # queue-ordering / host-scan policy (repro_torch.sched.placement registry)
    placement: str = field(default_factory=_default_placement)
    # demand estimator (repro_torch.sched.estimator registry: moe / oracle /
    # single-family / ann / conservative) for estimator-sweepable
    # policies (OURS; baselines keep their defining predictors).
    # "" = wrap the policy's own predictor — bit-identical to the
    # pre-estimator behaviour
    estimator: str = field(default_factory=_default_estimator)
    # --- network topology (repro_torch.sched.topology) ----------------------
    # preset name ("single-switch" / "two-rack" / "ring"); "" = no
    # fabric — every pre-topology schedule stays bit-identical.  With a
    # fabric bound and stage_gb_per_item > 0, each spawned executor's
    # input stages from the topology's ingress as a real Transmission
    # and the executor only starts processing when its last byte lands
    # (net contention now costs virtual time, not a closed-form curve)
    topology: str = ""
    stage_gb_per_item: float = 0.0
    topology_gbps: float = 10.0
    topology_latency_s: float = 0.0
    # --- elastic runtime (repro_torch.sched.elastic) -------------------------
    # shrink policy: an ElasticController.  When set, a job whose chunk
    # does NOT fit a host's budget may run on a FRACTION of its demanded
    # memory (spilling the rest) at the modeled slowdown from its
    # estimate's demand-vs-slowdown curve — charged into the executor's
    # rate, so virtual time pays for the memory cut.  None (default)
    # keeps binary admission, bit-identical.
    elastic: Optional[object] = None
    # deterministic seeded failure injection: a FailureSchedule whose
    # pre-drawn fail/repair events ride the runtime under its own event
    # kinds (the legacy Poisson ``failures``/``host_mtbf_s`` channel is
    # untouched and composable).  None (default) injects nothing.
    failure_plan: Optional[object] = None

    def host_capacity(self) -> ResourceVector:
        """Per-host capacity vector: the primary memory axis, the CPU
        slack (admission gate, paper Section 6.8), and any extra axes."""
        axes = {self.primary_axis: self.host_mem_gb,
                "cpu": self.cpu_slack}
        axes.update(self.extra_capacity)
        return ResourceVector(**axes)


@dataclass
class Job:
    jid: int
    app: AppProfile
    items: float                      # total M-items
    c_iso: float                      # isolated execution time (analytic)
    fn_hat: Optional[MemoryFunction] = None
    demand_est: Optional["DemandEstimate"] = None  # full multi-axis
    info: Dict = field(default_factory=dict)
    unassigned: float = 0.0
    done: float = 0.0
    arrival: float = 0.0              # open-arrival time (0 for batch)
    profiled_at: float = 0.0
    finish: Optional[float] = None
    conservative: bool = False
    active: int = 0                   # running executors (O(1) finish check)
    oom_count: int = 0
    tenant: Optional[str] = None      # owning tenant (fairness accounting)


@dataclass
class Executor:
    eid: int
    job: Job
    host: "Host"
    items_left: float
    mem_true: float
    mem_claimed: float
    rate_base: float
    last_t: float
    version: int = 0
    delay_until: float = 0.0          # online-search probe delay
    straggle: float = 1.0
    done_since_ckpt: float = 0.0
    claimed_vec: Optional[ResourceVector] = None  # full per-axis booking


@dataclass
class Host:
    """Executor-level host state.  Booked-capacity accounting lives on
    the wrapped :class:`~repro_torch.sched.cluster.Node` (the shared substrate
    the serving engine's replicas use too); the host keeps what is
    simulator-specific — live executors, true memory, paging."""
    hid: int
    mem_cap: float                    # primary-axis capacity (shortcut)
    execs: List[Executor] = field(default_factory=list)
    up: bool = True
    capacity: Optional[ResourceVector] = None  # full axis capacities
    node: Optional[Node] = None       # booked-claims ledger

    def __post_init__(self):
        if self.node is None:
            cap = self.capacity if self.capacity is not None \
                else ResourceVector(host_ram=self.mem_cap)
            self.node = Node(self.hid, cap)

    @property
    def mem_true(self) -> float:
        return sum(e.mem_true for e in self.execs)

    @property
    def mem_claimed(self) -> float:
        return sum(e.mem_claimed for e in self.execs)

    @property
    def cpu_used(self) -> float:
        return sum(e.job.app.cpu_load for e in self.execs)

    def free_vector(self) -> ResourceVector:
        """Unbooked capacity per axis (capacity minus booked claims),
        read off the node's claim ledger."""
        return self.node.headroom()

    def paging(self) -> bool:
        return self.mem_true > self.mem_cap


class Simulator:
    def __init__(self, jobs_spec: Optional[List[Tuple[AppProfile, float]]],
                 policy: "Policy", cfg: SimConfig, seed: int = 0,
                 arrivals: Optional[List] = None, tracer=None):
        """``jobs_spec`` is the closed batch (everything at t=0);
        ``arrivals`` (a list of ``repro_torch.sched.arrivals.Arrival``) instead
        feeds the cluster as an open queueing system — turnaround is then
        measured from each job's arrival time.  ``tracer`` (a
        ``repro_torch.obs.trace.Tracer``) collects job/executor lifecycle
        spans on the virtual clock; None (default) traces nothing and
        keeps results bit-identical."""
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.policy = policy
        bind = getattr(policy, "bind", None)
        if callable(bind):      # fix the config the policy predicts under
            bind(cfg)
        capacity = cfg.host_capacity()
        self.cluster = ClusterState.homogeneous(cfg.n_hosts, capacity)
        self.hosts = [Host(n.nid, cfg.host_mem_gb, capacity=capacity,
                           node=n) for n in self.cluster]
        # the shared event-driven substrate (repro_torch.sched.cluster): the
        # runtime owns the clock + heap + node ledger; the simulator
        # registers its workload-specific handlers on it.  Simulator.run
        # is a thin shim over runtime.run — results are pinned
        # bit-identical to the pre-runtime loop by tests/test_cluster.py
        self.runtime = ClusterRuntime(self.cluster, tracer=tracer)
        self.tracer = self.runtime.tracer
        self.telemetry = self.runtime.telemetry
        self.topology = None
        if cfg.topology:
            from repro_torch.sched.topology import get_topology
            self.topology = get_topology(
                cfg.topology, nodes=cfg.n_hosts,
                gbps=cfg.topology_gbps,
                latency_s=cfg.topology_latency_s).attach(self.runtime)
            self.runtime.topology = self.topology
        self.runtime.on("arrive", self._on_arrive)
        self.runtime.on("profiled", self._on_profiled)
        for kind in ("finish", "wake", "oom"):
            self.runtime.on(kind, self._make_exec_handler(kind))
        self.runtime.on("fail", self._on_fail)
        self.runtime.on("repair", self._on_repair)
        self.jobs: List[Job] = []
        if arrivals is not None:
            for jid, a in enumerate(sorted(arrivals, key=lambda a: a.t)):
                c_iso = a.items / (cfg.n_hosts * a.app.rate)
                self.jobs.append(Job(jid, a.app, a.items, c_iso,
                                     unassigned=a.items, arrival=a.t,
                                     tenant=getattr(a, "tenant", None)))
        else:
            for jid, (app, items) in enumerate(jobs_spec):
                c_iso = items / (cfg.n_hosts * app.rate)
                self.jobs.append(Job(jid, app, items, c_iso,
                                     unassigned=items))
        self.util_trace: List[Tuple[float, float]] = []
        self._eid = itertools.count()
        self.oom_count = 0
        self.paging_time = 0.0

    # --- event plumbing ---------------------------------------------------
    @property
    def t(self) -> float:
        """The virtual clock — owned by the runtime's event loop."""
        return self.runtime.t

    @property
    def binding_axes(self) -> Dict[str, int]:
        """Axis -> count of admission decisions it bound, aggregated
        over the cluster's nodes ("cap" = the Spark chunk /
        remaining-work cap bound before any resource)."""
        return self.cluster.binding_axes()

    def _push(self, t: float, kind: str, payload=None):
        self.runtime.push(t, kind, payload)

    def _rate(self, e: Executor) -> float:
        if self.t < e.delay_until or not e.host.up:
            return 0.0
        r = e.rate_base * e.straggle
        cpu = e.host.cpu_used
        if cpu > 1.0:
            r /= cpu
        if e.host.paging():
            r /= self.cfg.paging_slowdown
        return max(r, 1e-12)

    def _advance_host(self, host: Host):
        """Credit progress to now and re-time finish events."""
        for e in list(host.execs):
            dt = self.t - e.last_t
            if dt > 0:
                done = min(e.items_left, self._rate(e) * dt)
                e.items_left -= done
                e.job.done += done
                e.done_since_ckpt += done
                e.last_t = self.t
        for e in host.execs:
            e.version += 1
            rate = self._rate(e)
            if e.items_left <= 1e-12:
                self._push(self.t, "finish", (e, e.version))
            elif rate > 0:
                self._push(self.t + e.items_left / rate, "finish",
                           (e, e.version))
            elif e.delay_until > self.t:
                self._push(e.delay_until, "wake", (e, e.version))

    def _spawn(self, job: Job, host: Host, items: float, mem_true: float,
               mem_claimed: float, delay: float = 0.0,
               slowdown: float = 1.0, shrink_fraction: float = 1.0):
        """``slowdown`` > 1 charges a spill-aware shrunken grant into
        the executor's base rate (virtual time pays for the memory
        cut); ``shrink_fraction`` < 1 scales the side-car MEMORY-axis
        bookings by the granted fraction (the primary axis arrives
        pre-scaled in ``mem_claimed``).  Defaults are exact identities."""
        straggle = 1.0
        if self.cfg.straggler_prob > 0 and \
                self.rng.random() < self.cfg.straggler_prob:
            straggle = self.cfg.straggler_factor
        # full per-axis booking: the primary-axis claim, the executor's
        # average CPU load, and any secondary-axis demand at this split
        # — booked from the PREDICTED side-car curves when the job went
        # through an estimator (consistent with what admission decided
        # on), falling back to declared aux curves otherwise.  The
        # primary-axis-match guard mirrors Policy._demand_model: a job
        # estimated under a different primary axis was ADMITTED on the
        # declared curves, so it must book from them too
        de = job.demand_est
        if de is not None and \
                de.model.primary_axis == self.cfg.primary_axis:
            aux = {a: fn for a, fn in de.model.curves.items()
                   if a != self.cfg.primary_axis}
        else:
            aux = job.app.aux_demand
        axes = {a: float(fn(items)) for a, fn in aux.items()}
        if shrink_fraction != 1.0:
            from repro_torch.sched.resources import MEMORY_AXES
            axes = {a: (v * shrink_fraction if a in MEMORY_AXES else v)
                    for a, v in axes.items()}
        axes[self.cfg.primary_axis] = mem_claimed
        axes["cpu"] = job.app.cpu_load
        e = Executor(next(self._eid), job, host, items, mem_true,
                     mem_claimed, job.app.rate / slowdown, self.t,
                     delay_until=self.t + delay, straggle=straggle,
                     claimed_vec=ResourceVector(**axes))
        if slowdown != 1.0:
            self.telemetry.inc("elastic.shrink")
            if self.tracer is not None:
                self.tracer.instant(
                    "shrink", self.t, process="cluster", thread="execs",
                    args={"eid": e.eid, "jid": job.jid, "host": host.hid,
                          "fraction": shrink_fraction,
                          "slowdown": slowdown})
        job.unassigned -= items
        job.active += 1
        host.execs.append(e)
        host.node.book(e.eid, e.claimed_vec)
        if self.tracer is not None:
            self.tracer.async_begin(
                "exec", self.t, e.eid, cat="exec", process="cluster",
                thread="execs",
                args={"jid": job.jid, "host": host.hid,
                      "items": items, "claimed_gb": mem_claimed})
        # OOM check: large overflow kills the executor after wasted time
        over = host.mem_true - host.mem_cap
        if over > self.cfg.oom_overflow_frac * host.mem_cap:
            self.oom_count += 1
            waste = (self.cfg.oom_waste_frac * items
                     / max(job.app.rate, 1e-12))
            self._push(self.t + waste, "oom", (e, e.version))
        self._stage_input(e, items)
        self._advance_host(host)
        return e

    def _stage_input(self, e: Executor, items: float) -> None:
        """With a topology bound, the executor's input chunk rides the
        fabric from the ingress before any item processes: park it
        (``delay_until = inf`` — ``_rate`` reads 0) until the staging
        Transmission's last byte lands, then release and re-time.  The
        parked wake-at-inf event is superseded by the version bump, the
        usual stale-event discipline."""
        if self.topology is None or self.cfg.stage_gb_per_item <= 0.0:
            return
        dst = f"n{e.host.hid}"
        if not self.topology.has_node(dst) \
                or self.topology.ingress is None:
            return
        e.delay_until = float("inf")

        def staged(t, tr, e=e):
            if e not in e.host.execs:
                return            # OOM-killed / failed while staging
            e.delay_until = t
            self._advance_host(e.host)

        self.topology.transmit(
            self.topology.ingress, dst,
            items * self.cfg.stage_gb_per_item, now=self.t,
            tag="stage", on_complete=staged)

    def _remove_exec(self, e: Executor, requeue_items: float):
        if e in e.host.execs:
            e.host.execs.remove(e)
            e.host.node.release(e.eid)
            e.job.active -= 1
            if self.tracer is not None:
                self.tracer.async_end(
                    "exec", self.t, e.eid, cat="exec",
                    process="cluster", thread="execs",
                    args={"requeued": requeue_items})
        e.job.unassigned += requeue_items
        self._advance_host(e.host)

    def _maybe_finish(self, job: Job, t: float):
        tol = max(1e-6, 1e-7 * job.items)
        if job.finish is None and job.done >= job.items - tol \
                and job.unassigned <= tol and job.active == 0:
            job.finish = t
            if self.tracer is not None:
                end_args = {"oom_count": job.oom_count}
                if job.tenant is not None:
                    end_args["tenant"] = job.tenant
                self.tracer.async_end(
                    "job", t, job.jid, cat="job", process="cluster",
                    thread="jobs", args=end_args)

    # --- event handlers (registered on the ClusterRuntime) ------------------
    def _on_arrive(self, t: float, payload) -> None:
        job, frac = payload
        if self.tracer is not None:
            span_args = {"items": job.items, "app": job.app.name}
            if job.tenant is not None:
                span_args["tenant"] = job.tenant
            self.tracer.async_begin(
                "job", t, job.jid, cat="job", process="cluster",
                thread="jobs", args=span_args)
        if frac is not None:
            # profiling runs while the job waits; its processed
            # items credit the job (paper: no cycle is wasted)
            t_prof = frac * job.c_iso
            if self.cfg.profile_single_host:
                credit = min(t_prof * job.app.rate, 0.15 * job.items)
            else:
                credit = 0.15 * job.items
            job.done += credit
            job.unassigned -= credit
            self._push(t + t_prof, "profiled", job)
        else:
            self._push(t, "profiled", job)

    def _on_profiled(self, t: float, job) -> None:
        job.profiled_at = t
        job.fn_hat, job.info = self.policy.predict(job, self.rng)
        if self.tracer is not None:
            self.tracer.instant(
                "profiled", t, process="cluster", thread="jobs",
                args={"jid": job.jid,
                      "family": getattr(job.fn_hat, "family", None)})
        self.policy.dispatch(self)

    def _make_exec_handler(self, kind: str):
        def handler(t: float, payload):
            e, version = payload
            if e not in e.host.execs:
                return False  # executor already gone (stale event)
            if kind != "oom" and e.version != version:
                return False  # stale re-timed event
            self._advance_host(e.host)
            if kind == "oom" and e.items_left > 1e-9:
                if self.tracer is not None:
                    self.tracer.instant(
                        "oom", t, process="cluster", thread="execs",
                        args={"eid": e.eid, "jid": e.job.jid,
                              "host": e.host.hid})
                self._remove_exec(e, e.items_left)
                # scheduler reaction (paper Section 2.3: re-run an
                # OOM-killed executor in isolation): escalate — halve
                # budgets, and after 2 OOMs only place this job on
                # empty hosts
                e.job.oom_count += 1
                self.policy.dispatch(self, [e.host])
            elif e.items_left <= 1e-9:
                self._remove_exec(e, 0.0)
                self._maybe_finish(e.job, t)
                self.policy.dispatch(self, [e.host])
        return handler

    def _on_fail(self, t: float, host) -> None:
        if host.up:
            host.up = False
            host.node.up = False
            # re-queue non-checkpointed work
            for e in list(host.execs):
                lost = min(e.done_since_ckpt, e.job.done)
                e.job.done -= lost
                self._remove_exec(e, e.items_left + lost)
            self._push(t + self.cfg.repair_time_s, "repair", host)
        self._push(t + self.rng.exponential(self.cfg.host_mtbf_s),
                   "fail", host)

    def _on_repair(self, t: float, host) -> None:
        host.up = True
        host.node.up = True
        self.policy.dispatch(self, [host])

    # --- deterministic failure plan (repro_torch.sched.elastic) ----------------
    def _fail_host(self, t: float, idx: int) -> None:
        """FailureSchedule callback: the legacy ``fail`` body minus the
        Poisson re-arm and the repair push — the schedule owns both, so
        injecting a deterministic plan never touches the simulator RNG
        stream (seeded runs with ``failure_plan=None`` stay
        bit-identical)."""
        host = self.hosts[idx]
        if not host.up:
            return
        host.up = False
        host.node.up = False
        for e in list(host.execs):
            lost = min(e.done_since_ckpt, e.job.done)
            e.job.done -= lost
            self._remove_exec(e, e.items_left + lost)

    def _repair_host(self, t: float, idx: int) -> None:
        host = self.hosts[idx]
        if not host.up:
            self._on_repair(t, host)

    def _tick(self, t: float) -> None:
        self.util_trace.append(
            (t, sum(h.cpu_used for h in self.hosts if h.up)
             / max(len(self.hosts), 1)))

    # --- main loop ----------------------------------------------------------
    def run(self) -> Dict:
        """Thin shim over :meth:`ClusterRuntime.run`: seed the arrival
        (and failure) events, drain the loop, summarize.  Pinned
        bit-identical to the pre-runtime inline heap by the goldens in
        ``tests/test_cluster.py``."""
        cfg = self.cfg
        for job in self.jobs:
            # profile fraction drawn HERE (not at pop time) so the RNG
            # stream is identical between batch and open-arrival runs
            frac = self.rng.uniform(cfg.profile_frac_lo,
                                    cfg.profile_frac_hi) \
                if self.policy.uses_profiling else None
            self._push(job.arrival, "arrive", (job, frac))
        if cfg.failures and cfg.host_mtbf_s > 0:
            for h in self.hosts:
                self._push(self.rng.exponential(cfg.host_mtbf_s),
                           "fail", h)
        if cfg.failure_plan is not None:
            cfg.failure_plan.attach(
                self.runtime, on_fail=self._fail_host,
                on_repair=self._repair_host, n_targets=len(self.hosts))

        self.runtime.run(
            max_time=cfg.max_sim_time, tick=self._tick,
            until=lambda: all(j.finish is not None for j in self.jobs))

        # events drained: close out any numerically-finished jobs
        for job in self.jobs:
            self._maybe_finish(job, self.t)

        if not self.jobs:
            return {"stp": 0.0, "antt": 0.0, "antt_reduction": 0.0,
                    "makespan": 0.0, "c_cl": [], "c_is": [],
                    "arrivals": [], "finish_times": [], "unfinished": 0,
                    "oom_count": self.oom_count,
                    "binding_axes": dict(self.binding_axes),
                    "util_trace": self.util_trace}
        # turnaround is measured from each job's arrival (0 for batch);
        # unfinished jobs are CENSORED at the simulation cap, arrival-
        # relative and floored at c_iso. That is a LOWER bound on the
        # true turnaround, so STP/ANTT are optimistic bounds whenever
        # ``unfinished`` > 0 — compare policies on drained runs, or
        # check ``unfinished`` before trusting the aggregate.
        unfinished = sum(1 for j in self.jobs if j.finish is None)
        c_cl = np.asarray([j.finish - j.arrival if j.finish is not None
                           else max(cfg.max_sim_time - j.arrival, j.c_iso)
                           for j in self.jobs])
        c_is = np.asarray([j.c_iso for j in self.jobs])
        stp = float(np.sum(c_is / c_cl))
        antt = float(np.mean(c_cl / c_is))
        # the paper's Fig.6b baseline runs jobs ONE BY ONE: its turnaround
        # for job i includes waiting for jobs 1..i-1
        serial_turnaround = np.cumsum(c_is)
        antt_reduction = float(
            1.0 - np.mean(c_cl) / max(np.mean(serial_turnaround), 1e-12))
        return {"stp": stp, "antt": antt,
                "antt_reduction": antt_reduction,
                "makespan": float(np.max(c_cl)),
                "c_cl": c_cl.tolist(), "c_is": c_is.tolist(),
                "arrivals": [j.arrival for j in self.jobs],
                "finish_times": [j.finish for j in self.jobs],
                "unfinished": unfinished,
                "oom_count": self.oom_count,
                "binding_axes": dict(self.binding_axes),
                "util_trace": self.util_trace}


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

class Policy:
    """Base: estimator-driven co-location (the paper's runtime).

    Demand estimation goes through the ``repro_torch.sched.estimator``
    registry — selection order: the ``estimator`` constructor argument,
    else ``SimConfig.estimator``, else the policy's own ``predictor``
    wrapped in its faithful estimator (bit-identical to the
    pre-estimator code path).  Budget-inverse sizing and budget shading
    are delegated to the shared
    :class:`repro_torch.sched.admission.AdmissionController` (the same object
    the serving driver admits request batches through); queue ordering
    and host-scan order come from the ``repro_torch.sched.placement`` registry
    (``cfg.placement``)."""
    name = "base"
    uses_profiling = True
    #: whether ``SimConfig.estimator`` / ``benchmarks/run.py
    #: --estimator`` sweeps this policy's estimator.  Only the paper's
    #: own policy (OURS) is sweepable — baselines (oracle, quasar,
    #: pairwise, online-search) keep their defining predictors, so a
    #: sweep compares "OURS under estimator X" against stable baselines.
    estimator_sweepable = False

    def __init__(self, predictor=None,
                 admission: Optional["AdmissionController"] = None,
                 placement=None, estimator=None):
        """``placement`` (a name or PlacementPolicy instance) and
        ``estimator`` (a name or DemandEstimator instance) override
        ``SimConfig.placement`` / ``SimConfig.estimator`` for this
        policy only."""
        from repro_torch.sched.estimator import resolve_estimator
        self._owns_admission = admission is None
        if admission is None:
            from repro_torch.sched.admission import AdmissionController
            admission = AdmissionController()
        self.predictor = predictor
        self.admission = admission
        self.placement = get_placement(placement) \
            if isinstance(placement, str) else placement
        self._est_spec = estimator
        self._est = resolve_estimator(estimator, predictor=predictor)
        self._cfg: Optional[SimConfig] = None

    def bind(self, cfg: SimConfig) -> None:
        """Called by the Simulator before the run: fixes the config the
        policy predicts under (primary axis) and resolves the estimator
        (ctor arg > ``cfg.estimator`` > wrapped predictor)."""
        from repro_torch.sched.estimator import resolve_estimator
        self._cfg = cfg
        spec = self._est_spec
        if spec is None and self.estimator_sweepable:
            spec = cfg.estimator or None
        self._est = resolve_estimator(spec, predictor=self.predictor)
        # keep the policy-owned controller's estimator in sync (a
        # re-bind under a different SimConfig.estimator must not leave
        # a stale handle); a caller-supplied shared controller is never
        # clobbered
        if self._owns_admission:
            self.admission.estimator = self._est

    def _placement(self, cfg: SimConfig):
        return self.placement if self.placement is not None \
            else get_placement(cfg.placement)

    def predict(self, job: Job, rng) -> Tuple[MemoryFunction, Dict]:
        """Estimate the job's full multi-axis demand (primary curve +
        predicted side-cars) and remember it on the job; returns the
        primary curve + info exactly like the pre-estimator API."""
        from repro_torch.sched.estimator import JobTarget
        if self._est is None:                     # bare-predictor legacy
            return self.predictor.predict_function(job.app, job.items,
                                                   rng)
        primary = self._cfg.primary_axis if self._cfg is not None \
            else "host_ram"
        est = self._est.estimate(
            JobTarget(job.app, job.items, primary_axis=primary), rng=rng)
        job.demand_est = est
        if est.conservative:
            job.conservative = True
        return est.primary_fn, est.info

    def _demand_model(self, cfg: SimConfig, job: Job) -> DemandModel:
        """The job's per-axis demand: the estimated multi-axis model
        (calibrated primary curve + PREDICTED side-car curves) with the
        executor's average CPU load as a fixed gate (paper Section 6.8 —
        moved out of the dispatcher into the controller)."""
        est = job.demand_est
        if est is not None and est.model.primary_axis == cfg.primary_axis:
            return DemandModel(est.model.curves,
                               fixed={"cpu": job.app.cpu_load},
                               primary_axis=cfg.primary_axis)
        # legacy path (no estimate recorded): primary curve + DECLARED
        # side-car curves — deprecated since the estimator redesign
        curves = {cfg.primary_axis: job.fn_hat}
        if job.app.aux_demand:
            warnings.warn(
                "feeding declared AppProfile.aux_demand curves straight "
                "into admission is deprecated — route the job through a "
                "repro_torch.sched.estimator DemandEstimator, which PREDICTS "
                "the side-car curves from aux probes",
                DeprecationWarning, stacklevel=2)
            curves.update(job.app.aux_demand)
        return DemandModel(curves, fixed={"cpu": job.app.cpu_load},
                           primary_axis=cfg.primary_axis)

    def _sized_items(self, sim, job, host, budget) -> Optional[float]:
        """Budget-inverse executor sizing, shared by every predictor-
        driven policy: items = min over budgeted axes of the demand
        inverse, capped by the Spark partition chunk D/H. The chunk
        cap preserves job-level parallelism (an executor that cached the
        whole input would serialize the job); the binding-axis inverse is
        the paper's mechanism, vectorized. On an EMPTY host at least a
        chunk is taken even if it won't fully fit in cache (spill ==
        paging penalty)."""
        chunk = job.items / (sim.cfg.n_hosts * sim.cfg.tasks_per_slot)
        dec = self.admission.admit(self._demand_model(sim.cfg, job),
                                   budget,
                                   cap=min(job.unassigned, chunk),
                                   book=False)
        n = dec.units
        # the empty-host override may only relax the PRIMARY memory
        # axis (or the cap): overshooting it spills, and spill ==
        # paging penalty is modeled.  A fixed gate (cpu slack) or a
        # bound secondary axis has no overrun consequence model, so
        # forcing a chunk past it would book beyond capacity silently
        if not host.execs and \
                dec.binding_axis in (sim.cfg.primary_axis, None):
            n = min(job.unassigned, max(n, chunk))
        # an executor below a quarter chunk isn't worth co-locating (and
        # unbounded micro-executors would storm the event loop); the tail
        # of a nearly-done job is always placeable
        if n < min(chunk * 0.25, job.unassigned) - 1e-12 or n <= 1e-9:
            return None
        axis = dec.binding_axis or "cap"
        host.node.record_binding(axis)
        return n

    def spawn_params(self, sim, job, host,
                     budget: ResourceVector) -> Optional[Tuple]:
        """-> (items, mem_true, mem_claimed, delay) or the 6-tuple
        (+ slowdown, shrink_fraction) from the spill-aware fallback, or
        None."""
        n = self._sized_items(sim, job, host, budget)
        if n is None:
            return self._shrink_params(sim, job, host, budget)
        mem_true = job.app.measure(n)
        mem_claimed = self.admission.book(
            job.fn_hat, n, budget.get(sim.cfg.primary_axis, np.inf))
        return n, mem_true, mem_claimed, 0.0

    def _shrink_params(self, sim, job, host,
                       budget: ResourceVector) -> Optional[Tuple]:
        """Spill-aware fallback when the chunk does NOT fit: walk the
        job's demand-vs-slowdown curve to the largest memory fraction
        the budget covers and, if the ElasticController prices it under
        the slowdown cap, grant the FULL chunk on the shrunken claim —
        the executor runs at ``rate / slowdown`` (spilled items re-read
        from disk cost time, not correctness).  Returns the extended
        spawn tuple or None (= today's wait)."""
        cfg = sim.cfg
        est = job.demand_est
        curve = getattr(est, "shrink", None) if est is not None else None
        if cfg.elastic is None or curve is None or not curve.shrinkable:
            return None
        if est.model.primary_axis != cfg.primary_axis:
            return None          # admitted on declared curves — no fit
        chunk = min(job.unassigned,
                    job.items / (cfg.n_hosts * cfg.tasks_per_slot))
        if chunk <= 1e-9:
            return None
        dec = self.admission.shrink_target(
            self._demand_model(cfg, job), budget, units=chunk,
            curve=curve, elastic=cfg.elastic, book=False)
        if not dec:
            return None
        sh = dec.info["shrink"]
        f, slow = float(sh["fraction"]), float(sh["slowdown"])
        if f >= 1.0 - 1e-12:
            # fits outright — _sized_items already declined (floor);
            # shrinking must not become a floor bypass
            return None
        host.node.record_binding(sh["axis"] or "cap")
        # the executor genuinely caps its resident set at the granted
        # fraction (the rest spills) — mis-prediction still bites: if
        # the true working set overshoots the predicted one, f * true
        # overshoots the claim and paging/OOM consequences apply
        mem_true = f * job.app.measure(chunk)
        mem_claimed = min(
            f * float(job.fn_hat(chunk)),
            budget.get(cfg.primary_axis, np.inf))
        return chunk, mem_true, mem_claimed, 0.0, slow, f

    def _tenant_order(self, sim: Simulator, jobs: List[Job]) -> List[Job]:
        """Progressive-filling DRF interleave across tenants for the
        host-scan loop (the serving side's ``pack_step`` analogue):
        repeatedly hand the scan slot to the tenant with the LOWEST
        dominant share of booked cluster capacity — live executor
        claims plus the primary-axis chunks already granted this pass —
        taking that tenant's first placement-ordered job.  Equal-weight
        DRF; jobs without a tenant form their own pseudo-tenant.  Only
        reached when some ready job carries a tenant, so untenanted
        runs stay bit-identical."""
        cfg = sim.cfg
        total = {a: v * cfg.n_hosts
                 for a, v in cfg.host_capacity().items()}
        usage: Dict[Optional[str], Dict[str, float]] = {}
        for h in sim.hosts:
            for e in h.execs:
                if e.claimed_vec is None:
                    continue
                u = usage.setdefault(e.job.tenant, {})
                for a, v in e.claimed_vec.items():
                    u[a] = u.get(a, 0.0) + v

        def share(ten) -> float:
            return max((v / total[a]
                        for a, v in usage.get(ten, {}).items()
                        if total.get(a, 0.0) > 0.0), default=0.0)

        queues: Dict[Optional[str], List[Job]] = {}
        order: List[Optional[str]] = []   # first-seen tie-break
        for j in jobs:
            if j.tenant not in queues:
                queues[j.tenant] = []
                order.append(j.tenant)
            queues[j.tenant].append(j)
        out: List[Job] = []
        while any(queues[t] for t in order):
            pick = min((t for t in order if queues[t]),
                       key=lambda t: (share(t), order.index(t)))
            job = queues[pick].pop(0)
            out.append(job)
            # charge the job's likely next grant (one primary-axis
            # chunk) so the NEXT slot goes to whoever is now behind —
            # this is what interleaves instead of draining one tenant
            chunk = min(job.unassigned,
                        job.items / (cfg.n_hosts * cfg.tasks_per_slot))
            if job.fn_hat is not None:
                u = usage.setdefault(pick, {})
                a = cfg.primary_axis
                u[a] = u.get(a, 0.0) + float(job.fn_hat(chunk))
        return out

    def dispatch(self, sim: Simulator, hosts=None):
        """Offer capacity to jobs in placement order. ``hosts`` narrows
        the scan to the hosts whose state changed (executor finish/OOM/
        repair) — a full cluster scan happens only when a new job
        becomes schedulable."""
        cfg = sim.cfg
        hosts = hosts if hosts is not None else sim.hosts
        placement = self._placement(cfg)
        ready = [j for j in sim.jobs
                 if j.fn_hat is not None and j.unassigned > 1e-9]
        ordered = placement.order_jobs(ready, now=sim.t)
        if any(j.tenant is not None for j in ordered):
            ordered = self._tenant_order(sim, ordered)
        for job in ordered:
            for host in placement.order_hosts(job, hosts,
                                              cfg.primary_axis):
                if not host.up or job.unassigned <= 1e-9:
                    continue
                if any(e.job is job for e in host.execs):
                    continue  # one executor per (job, host)
                if job.oom_count >= 2 and host.execs:
                    continue  # isolation re-run after repeated OOM
                free = host.free_vector()
                if free.get(cfg.primary_axis, 0.0) < cfg.min_alloc_gb:
                    continue
                # CPU admission lives in the controller now: the free
                # vector carries the cpu axis and the demand model's
                # fixed cpu load gates it inside admit()
                budget = self.admission.effective_budget(
                    free, safety_margin=cfg.safety_margin,
                    conservative=getattr(job, "conservative", False),
                    oom_count=job.oom_count)
                params = self.spawn_params(sim, job, host, budget)
                if params is None:
                    continue
                n, mt, mc, delay = params[:4]
                if len(params) > 4:      # spill-aware shrunken grant
                    sim._spawn(job, host, n, mt, mc, delay,
                               slowdown=params[4],
                               shrink_fraction=params[5])
                else:
                    sim._spawn(job, host, n, mt, mc, delay)


class OursPolicy(Policy):
    name = "ours"
    estimator_sweepable = True

    def __init__(self, predictor=None,
                 admission: Optional["AdmissionController"] = None,
                 refresher=None, placement=None, estimator=None):
        """``refresher`` (repro_torch.sched.online.OnlineRefresher) folds each
        profiled arrival's calibration curve back into the estimator
        (``partial_update`` through the registry handle) — the
        open-arrival online-learning loop."""
        super().__init__(predictor, admission, placement, estimator)
        self.refresher = refresher

    def predict(self, job, rng):
        fn, info = super().predict(job, rng)
        if not info.get("confident", True):
            job.conservative = True
        if self.refresher is not None and info.get("calib"):
            xs, ys = zip(*info["calib"])
            info["refreshed"] = self.refresher.observe(
                job.app.features, xs, ys,
                confident=info.get("confident"))
        return fn, info


class QuasarPolicy(Policy):
    name = "quasar"


class OraclePolicy(Policy):
    """Prophetic memory prediction. Jobs flow through the same pipeline
    (same arrival staggering) — only the prediction is perfect, so Oracle
    is the schedule-dynamics-matched upper bound for OURS (the paper
    reports "% of Oracle performance" in exactly this sense)."""
    name = "oracle"
    uses_profiling = True


class OnlineSearchPolicy(Policy):
    """Descent-search for the right input size: probing overhead per
    executor launch + suboptimal final allocation (paper Section 6.5)."""
    name = "online"
    uses_profiling = False

    def __init__(self):
        super().__init__(None)

    def predict(self, job, rng):
        return job.app.true_fn, {"family": job.app.family}

    def spawn_params(self, sim, job, host, budget):
        n_opt = self._sized_items(sim, job, host, budget)
        if n_opt is None:
            return None
        qual = sim.rng.uniform(sim.cfg.online_alloc_lo, 1.0)
        n = n_opt * qual
        mem_true = job.app.measure(n)
        delay = sim.cfg.online_search_eta * n / max(job.app.rate, 1e-12)
        mem_claimed = self.admission.book(
            job.fn_hat, n, budget.get(sim.cfg.primary_axis, np.inf))
        return n, mem_true, mem_claimed, delay


class PairwisePolicy(Policy):
    """<=2 executors per host; the co-located one claims ALL free memory
    and takes a Spark-default item chunk (no memory model)."""
    name = "pairwise"
    uses_profiling = False

    def __init__(self):
        super().__init__(None)

    def predict(self, job, rng):
        return job.app.true_fn, {}  # never used for sizing

    def dispatch(self, sim: Simulator, hosts=None):
        cfg = sim.cfg
        hosts = hosts if hosts is not None else sim.hosts
        placement = self._placement(cfg)
        ready = [j for j in sim.jobs
                 if j.fn_hat is not None and j.unassigned > 1e-9]
        for job in placement.order_jobs(ready, now=sim.t):
            for host in placement.order_hosts(job, hosts,
                                              cfg.primary_axis):
                if not host.up or job.unassigned <= 1e-9:
                    continue
                if len(host.execs) >= 2:
                    continue
                if any(e.job is job for e in host.execs):
                    continue
                if job.oom_count >= 2 and host.execs:
                    continue  # isolation re-run after repeated OOM
                free = host.free_vector().get(cfg.primary_axis, 0.0)
                if free < cfg.min_alloc_gb:
                    continue
                # primary executor claims the Spark default heap; the
                # co-located one claims ALL remaining free memory (paper:
                # "sets the maximum heap size of the co-locating task to
                # the size of free memory") -> nothing beyond pairwise.
                claim = (cfg.pairwise_default_heap * host.mem_cap
                         if not host.execs else free)
                claim = min(claim, free)
                chunk = min(job.unassigned,
                            job.items / (cfg.n_hosts * cfg.tasks_per_slot))
                mem_true = job.app.measure(chunk)
                sim._spawn(job, host, chunk, mem_true, claim)


def make_policies(moe_predictor, ann_predictor) -> Dict[str, Policy]:
    from repro_torch.core.predictor import OraclePredictor
    return {
        "ours": OursPolicy(moe_predictor),
        "quasar": QuasarPolicy(ann_predictor),
        "pairwise": PairwisePolicy(),
        "online": OnlineSearchPolicy(),
        "oracle": OraclePolicy(OraclePredictor()),
    }
