"""The serving loop: continuous batching as step events on replica Nodes.

Two modes over the same queue, demand model, budget, and backend:

* ``continuous`` — the default: the engine runs on the shared
  :class:`~repro_torch.sched.cluster.ClusterRuntime` substrate.  Each of the
  1..N replicas is a :class:`~repro_torch.sched.cluster.Node` (per-replica
  budget capacity, a live ledger of in-flight request footprints) with
  its own backend and :class:`~repro_torch.serve.batcher.ContinuousBatcher`;
  every decode step is a ``step`` event on the runtime's virtual clock,
  so replicas advance independently and interleave in time order.
  Released requests are routed to a replica by the ``Router`` registry
  (``single`` / ``least-loaded`` / ``net-aware``) using their predicted
  multi-axis demand vector — ``net-aware`` spreads load over the
  replicas' ``net`` headroom, which is what makes multi-replica serving
  routing over the net axis real.  Preempted requests requeue on their
  own replica (their recomputable KV is local state) — unless a
  ``topology`` is bound and ``migrate=True``, in which case eviction
  compares the MODELED KV-transfer time (live paged footprint over the
  bottleneck link's residual fair share) against the local recompute
  cost and, when the wire wins, ships the KV to an adoptable replica as
  a real :class:`~repro_torch.sched.topology.Transmission` on the same event
  loop; the destination seats it with ``backend.adopt`` (no prefill
  reruns).  With ``ingress_gb_per_token > 0`` routed requests also ride
  the fabric from the topology's ingress before they can join, so a
  shared narrow uplink costs real TTFT.  ``topology=None`` (default)
  keeps every schedule bit-identical to the pre-topology engine.
* ``wave``       — the legacy ``launch/serve.py`` behaviour for
  comparison: single replica, admission once per wave via
  ``admit_batch`` against the worst-case (full-context) footprint, no
  joins until the whole wave drains.

With one replica the event loop degenerates to the exact pre-runtime
sequential loop — schedules and metrics are pinned bit-identical by the
goldens in ``tests/test_cluster.py``.

Time is virtual (backend cost model), so identical seeds give identical
schedules and metrics on any machine; the jax backend's real compute
rides inside those steps.

Termination is structural, not best-effort: every planned step decodes
one token — or, on chunked-prefill backends, advances one prefill
chunk — of at least one request (and tokens, once decoded, survive
preemption via recompute), and every idle wake either consumes a future
arrival or ends that replica's event chain, so the loop runs at most
``sum(max_new_tokens) + replicas * len(requests)`` planned steps
(scaled by the worst per-admission chunk count when a backend prefills
in chunks) — a preemption storm cannot live-lock.  ``max_steps`` is an
assertion backstop on that bound, not a tuning knob.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.experts import MemoryFunction
from repro_torch.obs.telemetry import sample_node
from repro_torch.sched.admission import AdmissionController
from repro_torch.sched.cluster import ClusterRuntime, ClusterState, Node, Router
from repro_torch.sched.elastic import Autoscaler, pick_spawn_node
from repro_torch.sched.resources import DemandModel, ResourceVector
from repro_torch.sched.tenancy import Tenant, TenantRegistry
from repro_torch.sched.topology import Topology
from repro_torch.serve.backends import Backend, SimBackend
from repro_torch.serve.batcher import (ContinuousBatcher, ServingDemand,
                                 StepDecision)
from repro_torch.serve.metrics import ServingMetrics
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request, RequestState

MODES = ("continuous", "wave")

#: the per-node ledger key for the resident model weights (booked once
#: per replica; requests book their own growing KV/side-car vectors)
_WEIGHTS_KEY = "__weights__"


class Engine:
    """Drives a request population to completion under a resource budget.

    ``budget`` is PER REPLICA (each replica Node gets the full vector as
    its capacity); ``replicas``/``router`` select the cluster shape and
    the routing policy.  ``run()`` returns the metrics summary; the
    step-by-step record stays on ``engine.metrics`` for the invariant
    tests and benchmarks.
    """

    def __init__(self, requests: Sequence[Request],
                 demand: ServingDemand,
                 budget: Union[float, ResourceVector],
                 backend: Optional[Backend] = None,
                 mode: str = "continuous",
                 placement: str = "fcfs",
                 max_batch: int = 16,
                 controller: Optional[AdmissionController] = None,
                 replicas: int = 1,
                 router: Union[str, Router] = "single",
                 backends: Optional[Sequence[Backend]] = None,
                 topology=None,
                 migrate: bool = False,
                 ingress_gb_per_token: float = 0.0,
                 budgets: Optional[Sequence[ResourceVector]] = None,
                 tracer=None,
                 tenants: Union[TenantRegistry, Sequence[Tenant],
                                None] = None,
                 elastic=None,
                 failures=None,
                 autoscaler=None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (choose from {MODES})")
        if not isinstance(budget, ResourceVector):
            budget = ResourceVector(hbm=float(budget))
        if mode != "continuous" and (elastic is not None
                                     or failures is not None
                                     or autoscaler is not None):
            raise ValueError("elastic / failures / autoscaler run on "
                             "the continuous engine (wave is the "
                             "legacy shim)")
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        #: the elastic runtime (all default-off, bit-identical when
        #: unset): ``elastic`` (ElasticController) turns on spill-aware
        #: shrunken joins in the batchers; ``failures``
        #: (FailureSchedule) injects deterministic replica fail/repair
        #: events; ``autoscaler`` (Autoscaler) spawns/drains replicas
        #: from queue-depth and SLO-attainment trends.  With an
        #: autoscaler the fleet is PRE-PROVISIONED to ``max_replicas``
        #: — the spares exist as down Nodes (no capacity, invisible to
        #: the router) until a scale-up flips them live.
        self.elastic = elastic
        self.failures = failures
        self.autoscaler = autoscaler
        self._initial_replicas = self.replicas
        if autoscaler is not None:
            self.replicas = max(self.replicas,
                                int(autoscaler.max_replicas))
        if mode == "wave" and self.replicas != 1:
            raise ValueError("wave mode is the single-replica legacy "
                             "path — use mode='continuous' with "
                             "replicas > 1")
        if mode == "wave" and (topology is not None
                               or budgets is not None):
            raise ValueError("topology / heterogeneous budgets need "
                             "mode='continuous' (wave is the legacy "
                             "shim)")
        if migrate and topology is None:
            raise ValueError("migrate=True needs a topology — KV moves "
                             "over modeled links")
        self.mode = mode
        self.demand = demand
        self.budget = budget
        # one backend per replica: an explicit list or a single backend
        # instance (one replica only); default SimBackends
        if backends is not None and backend is not None:
            raise ValueError("pass either backend= or backends=, "
                             "not both")
        if backends is not None:
            self.backends = list(backends)
            if len(self.backends) != self.replicas:
                raise ValueError(
                    f"got {len(self.backends)} backends for "
                    f"{self.replicas} replicas")
        elif backend is not None:
            if self.replicas != 1:
                raise ValueError("pass backends=[...] (one per replica) "
                                 "when replicas > 1")
            self.backends = [backend]
        else:
            self.backends = [SimBackend() for _ in range(self.replicas)]
        self.backend = self.backends[0]
        self.controller = controller or AdmissionController()
        self.max_batch = int(max_batch)
        self.requests = list(requests)
        for be in self.backends:
            max_len = getattr(be, "max_len", None)
            if max_len is None:
                continue
            for r in self.requests:
                if r.prompt_len + r.max_new_tokens > max_len:
                    raise ValueError(
                        f"request {r.rid}: prompt+new "
                        f"{r.prompt_len + r.max_new_tokens} exceeds the "
                        f"backend's max_len {max_len}")
        self.queue = RequestQueue(self.requests, placement=placement)
        # the shared substrate: one Node per replica, capacity = the
        # per-replica budget (or an explicit per-replica vector when the
        # cell is heterogeneous), weights booked once on each
        if budgets is not None:
            budgets = list(budgets)
            if len(budgets) != self.replicas:
                raise ValueError(f"got {len(budgets)} budgets for "
                                 f"{self.replicas} replicas")
            cluster = ClusterState(
                [Node(i, b) for i, b in enumerate(budgets)])
        else:
            cluster = ClusterState.homogeneous(self.replicas, budget)
        self.budgets = budgets
        for node in cluster:
            node.book(_WEIGHTS_KEY, ResourceVector(hbm=demand.weights_gb))
        # autoscaler spares start DOWN: routers skip them, no steps run
        # on them, and a scale-up flips one live
        for nid in range(self._initial_replicas, self.replicas):
            cluster[nid].up = False
        #: None (the default) keeps the legacy FIFO-prefix plan and
        #: routing bit-identical; a registry (or plain Tenant list)
        #: turns on weighted-DRF fairness in the router, the batchers'
        #: knapsack joins, and per-tenant metrics
        if tenants is None or isinstance(tenants, TenantRegistry):
            self.tenancy = tenants
        else:
            self.tenancy = TenantRegistry(tenants)
        if self.tenancy is not None:
            for r in self.requests:
                if r.tenant is not None:
                    self.tenancy.ensure(r.tenant)
        self.runtime = ClusterRuntime(cluster, router=router,
                                      topology=topology, tracer=tracer,
                                      tenancy=self.tenancy)
        #: None by default — every span/instant below is gated on it,
        #: so untraced runs stay bit-identical to the pre-obs engine
        self.tracer = self.runtime.tracer
        self.telemetry = self.runtime.telemetry
        self.topology = self.runtime.topology
        self.migrate = bool(migrate)
        self.ingress_gb_per_token = float(ingress_gb_per_token)
        self.batchers = [ContinuousBatcher(
            demand, budgets[r] if budgets is not None else budget,
            controller=self.controller,
            placement=self.queue.placement, max_batch=self.max_batch,
            node=r, tenancy=self.tenancy,
            elastic=elastic) for r in range(self.replicas)]
        self.batcher = self.batchers[0]
        self.metrics = ServingMetrics()
        for r in self.requests:
            self.metrics.record_request(r)
        # structural bound: one decoded token per planned step minimum,
        # plus one idle-advance per (arrival, replica) pair.  Chunked
        # prefill relaxes "one token per step" to "one token OR one
        # prefill chunk per step": between productive units a request
        # consumes at most ceil(context / chunk) chunk-only steps, so
        # the bound scales by that factor.
        base_bound = sum(r.max_new_tokens for r in self.requests) \
            + self.replicas * len(self.requests) + 8
        chunk_mult = 1
        for be in self.backends:
            chunk = getattr(be, "prefill_chunk", 0)
            if chunk and self.requests:
                worst = max(-(-(r.prompt_len + r.max_new_tokens) // chunk)
                            for r in self.requests)
                chunk_mult = max(chunk_mult, 1 + worst)
        self.max_steps = base_bound * chunk_mult
        if failures is not None or autoscaler is not None:
            # fail/repair and scale events add idle wakes and recompute
            # churn beyond the structural bound; slacken the backstop
            # (still an assertion against live-lock, not a knob)
            self.max_steps = self.max_steps * 4 + 256
        # per-replica scheduling state (continuous mode)
        self._pending: List[List[Request]] = \
            [[] for _ in range(self.replicas)]
        self._running: List[List[Request]] = \
            [[] for _ in range(self.replicas)]
        self._clocks: List[float] = [0.0] * self.replicas
        self._by_rid: Dict[int, Request] = {r.rid: r for r in
                                            self.requests}
        self._step_no = 0
        # topology state: requests riding a Transmission toward replica
        # d sit in _in_transit[d] (committed load, not yet joinable);
        # rids whose KV-cache landed via migration adopt instead of
        # recomputing on their next join
        self._in_transit: List[List[Request]] = \
            [[] for _ in range(self.replicas)]
        self._kv_ready: set = set()
        self._step_gen: List[int] = [0] * self.replicas
        #: replicas currently failed (failure injection): their step
        #: chains die on arrival and repair pushes a fresh one.  A
        #: scaled-DOWN replica is NOT in here — it keeps stepping until
        #: its running set drains.
        self._failed: set = set()

    # --- routing ----------------------------------------------------------
    def _route_released(self, now: float) -> None:
        """Move arrived requests into a replica's pending list, chosen
        by the router from the request's predicted demand vector against
        per-node headroom.  The routed request books its demand on the
        node IMMEDIATELY (a queued request is committed load: it will
        run there), so a burst of simultaneous arrivals sees shrinking
        headroom and spreads across replicas instead of piling onto the
        first node."""
        for req in self.queue.drain_released(now):
            vec = self.demand.request_vector(req)
            node = self.runtime.route(vec, now=now, tenant=req.tenant)
            node.book(req.rid, vec)
            if self.tenancy is not None:
                # the routed request is committed tenant load NOW, so a
                # burst sees each other's growing shares and spreads
                # (the fairness analogue of the node booking above)
                self.tenancy.add_usage(req.tenant, node.nid, vec)
            if self.tracer is not None:
                span_args = {"node": node.nid, "prompt": req.prompt_len}
                if req.tenant is not None:
                    span_args["tenant"] = req.tenant
                self.tracer.async_begin(
                    "req", now, req.rid, cat="request",
                    process="requests", thread="lifecycle",
                    args=span_args)
            if not self._ingress_transfer(req, node.nid, now):
                self._pending[node.nid].append(req)

    def _ingress_transfer(self, req: Request, dst: int,
                          now: float) -> bool:
        """When a topology with an ingress is bound and prompts cost
        bytes, a routed request rides a Transmission from the ingress
        and only becomes pending when its last byte lands — a shared
        narrow uplink now costs real TTFT instead of being invisible to
        a per-node net counter."""
        topo = self.topology
        if (topo is None or topo.ingress is None
                or self.ingress_gb_per_token <= 0.0):
            return False
        name = Topology.replica_name(dst)
        if not topo.has_node(name):
            return False
        self._in_transit[dst].append(req)
        topo.transmit(
            topo.ingress, name,
            req.prompt_len * self.ingress_gb_per_token, now=now,
            tag="ingress",
            on_complete=lambda t, tr, rid=req.rid, d=dst:
                self._on_delivered(t, rid, d))
        return True

    def _on_delivered(self, t: float, rid: int, dst: int) -> None:
        req = self._by_rid[rid]
        self._in_transit[dst].remove(req)
        self._pending[dst].append(req)
        self._push_step(max(t, self._clocks[dst]), dst)

    # --- candidate filtering ---------------------------------------------
    def _candidates_for(self, ridx: int, now: float) -> List[Request]:
        """Replica ``ridx``'s pending requests its backend can
        physically join right now (position/window constraints), in
        placement order."""
        backend = self.backends[ridx]
        pending = self.queue.placement.order_jobs(
            list(self._pending[ridx]), now=now)
        if backend.position and \
                backend.position % backend.join_stride:
            return []  # joins quantize to the backend's sync points
        if backend.empty:
            # empty batch restarts: the backend picks the cohort that
            # can physically restart together (dense: greedy shared
            # position window; paged: page reservations)
            return backend.restart_cohort(pending)
        return backend.filter_joinable(pending)

    # --- KV migration (topology-bound clusters) ---------------------------
    def _live_kv_gb(self, ridx: int, req: Request) -> float:
        """The request's LIVE KV footprint on this backend — the paged
        ledger's allocated pages when there is one (what would actually
        move over the wire), the raw context length otherwise."""
        alloc = getattr(self.backends[ridx], "alloc", None)
        tokens = req.context_len
        if alloc is not None:
            try:
                tokens = len(alloc.pages_of(req.rid)) * alloc.page_size
            except KeyError:
                pass
        return self.demand.kv_gb(tokens)

    def _plan_migrations(self, evicted: Sequence[Request], ridx: int,
                         now: float) -> Dict[int, tuple]:
        """migrate-vs-recompute: for each evicted request, pick the
        adoptable replica with the cheapest MODELED transfer (path
        latency + KV bytes over the bottleneck link's residual fair
        share at current contention) and migrate iff that beats
        rebuilding the context locally.  Sized from the live paged
        footprint BEFORE the backend releases the pages.  Returns
        ``rid -> (dst nid, kv GB)``."""
        out: Dict[int, tuple] = {}
        topo = self.topology
        backend = self.backends[ridx]
        src = Topology.replica_name(ridx)
        if not topo.has_node(src):
            return out
        for r in evicted:
            recompute_s = backend.recompute_cost(r)
            if recompute_s is None:
                continue
            kv_gb = self._live_kv_gb(ridx, r)
            best = None
            for n in self.runtime.cluster:
                if n.nid == ridx or not n.up:
                    continue
                if not self.backends[n.nid].can_adopt:
                    continue
                name = Topology.replica_name(n.nid)
                if not topo.has_node(name):
                    continue
                est = topo.estimate_transfer_s(src, name, kv_gb)
                if best is None or (est, n.nid) < best[:2]:
                    best = (est, n.nid)
            if best is not None and best[0] < recompute_s:
                out[r.rid] = (best[1], kv_gb)
        return out

    def _start_migration(self, req: Request, src: int, dst: int,
                         kv_gb: float, now: float) -> None:
        self._in_transit[dst].append(req)
        node = self.runtime.cluster[dst]
        vec = self.demand.request_vector(req)
        if req.rid in node:
            node.rebook(req.rid, vec)
        else:
            node.book(req.rid, vec)   # committed load on the new home
        self.topology.transmit(
            Topology.replica_name(src), Topology.replica_name(dst),
            kv_gb, now=now, tag="kv-migration",
            on_complete=lambda t, tr, rid=req.rid, d=dst:
                self._on_kv_arrived(t, rid, d, tr))

    def _on_kv_arrived(self, t: float, rid: int, dst: int,
                       transmission) -> None:
        req = self._by_rid[rid]
        self._in_transit[dst].remove(req)
        self._kv_ready.add(rid)
        self._pending[dst].append(req)
        self.metrics.record_migration(transmission.duration_s)
        self._push_step(max(t, self._clocks[dst]), dst)

    # --- shared step application -----------------------------------------
    def _apply(self, plan: StepDecision, ridx: int, now: float) -> float:
        """Evict, requeue (same replica, or migrate the KV when the
        wire is cheaper than recompute), join/adopt.  Returns the join
        (prefill) cost."""
        running = self._running[ridx]
        batcher = self.batchers[ridx]
        # register shrink grants BEFORE joins run: the frozen granted
        # vector is sized at the plan-time context, and the backend's
        # join/prefill may advance it
        for rid, frac, slow in plan.shrunk:
            batcher.register_shrunk(self._by_rid[rid], frac, slow)
            if self.tracer is not None:
                self.tracer.instant(
                    "shrink", now, process=f"replica{ridx}",
                    thread="events",
                    args={"rid": rid, "fraction": frac,
                          "slowdown": slow})
        evicted = [self._by_rid[rid] for rid in plan.preempted]
        if evicted:
            moves = self._plan_migrations(evicted, ridx, now) \
                if (self.migrate and self.topology is not None) else {}
            self.backends[ridx].remove(evicted)
            for r in evicted:
                r.preemptions += 1
                running.remove(r)
                r.state = RequestState.QUEUED
                batcher.shrunk.pop(r.rid, None)
                if r.rid in moves:
                    dst, kv_gb = moves[r.rid]
                    self._start_migration(r, ridx, dst, kv_gb, now)
                else:
                    self._pending[ridx].append(r)
        joined = [self._by_rid[rid] for rid in plan.admitted]
        dt = 0.0
        if joined:
            taken = {id(r) for r in joined}
            self._pending[ridx] = [r for r in self._pending[ridx]
                                   if id(r) not in taken]
            adopted = [r for r in joined if r.rid in self._kv_ready]
            fresh = [r for r in joined if r.rid not in self._kv_ready]
            if adopted:
                # KV already landed over the wire: seat without prefill
                dt += self.backends[ridx].adopt(adopted, now)
                for r in adopted:
                    self._kv_ready.discard(r.rid)
            if fresh:
                dt += self.backends[ridx].join(fresh, now)
            for r in joined:
                r.admissions += 1
                r.state = RequestState.RUNNING
                if self.tracer is not None:
                    self.tracer.instant(
                        "join", now, process=f"replica{ridx}",
                        thread="events", args={"rid": r.rid})
            running.extend(joined)
        return dt

    def _retire(self, ridx: int, now: float) -> None:
        running = self._running[ridx]
        done = [r for r in running if r.done]
        if done:
            self.backends[ridx].remove(done)
            for r in done:
                r.state = RequestState.FINISHED
                r.finish_t = now
                running.remove(r)
                self.batchers[ridx].shrunk.pop(r.rid, None)
                if self.tenancy is not None:
                    self.tenancy.observe_request(r)
                if self.autoscaler is not None:
                    self.autoscaler.observe_finished(r.meets_slo())
                self._trace_req_end(r, now)

    def _trace_req_end(self, r: Request, now: float) -> None:
        """Close the request's async lifecycle span.  ``t1`` carries the
        raw virtual seconds so the trace report can recompute goodput
        (tokens / elapsed) bit-identically — the µs timestamp alone
        loses float precision on the round-trip."""
        if self.tracer is not None:
            end_args = {"tokens": r.tokens_decoded, "t1": now}
            if r.tenant is not None:
                end_args["tenant"] = r.tenant
            self.tracer.async_end(
                "req", now, r.rid, cat="request", process="requests",
                thread="lifecycle", args=end_args)

    def _sync_node(self, ridx: int) -> None:
        """Reconcile the replica Node's claim ledger with its committed
        load — the running set plus the locally-queued set (queued
        requests booked at route time; preempted ones requeue locally
        and stay booked).  After every step the node's booked vector ==
        weights + sum of committed request demands (the conservation
        invariant ``tests/test_cluster.py`` pins)."""
        node = self.runtime.cluster[ridx]
        live = {r.rid: r for r in self._running[ridx]}
        for r in self._pending[ridx]:
            live[r.rid] = r
        for r in self._in_transit[ridx]:
            live[r.rid] = r           # inbound KV/prompt: committed load
        for key in node.keys():
            if key != _WEIGHTS_KEY and key not in live:
                node.release(key)
        by_tenant: Dict[Optional[str], ResourceVector] = {}
        shrunk = self.batchers[ridx].shrunk
        for rid, r in live.items():
            fs = shrunk.get(rid)
            # a live shrink grant books its FROZEN granted vector (the
            # spilled remainder is off-budget by construction)
            vec = fs[2] if fs is not None \
                else self.demand.request_vector(r)
            if rid in node:
                node.rebook(rid, vec)
            else:
                node.book(rid, vec)
            if self.tenancy is not None:
                by_tenant[r.tenant] = \
                    by_tenant.get(r.tenant, ResourceVector()) + vec
        if self.tenancy is not None:
            # registry ledger follows the node ledger exactly
            self.tenancy.set_node_usage(ridx, by_tenant)

    # --- elastic runtime: failures and autoscaling ------------------------
    def _fail_replica(self, t: float, ridx: int) -> None:
        """Failure injection: the replica goes dark.  Its live requests
        drain through the existing migrate-vs-recompute path (a
        controlled drain ships KV when the wire beats recompute;
        otherwise the request requeues and recomputes), its queued
        requests re-route to live replicas as requeue-origin work, and
        its step chain dies until repair."""
        if ridx in self._failed or ridx >= self.replicas:
            return
        self._failed.add(ridx)
        node = self.runtime.cluster[ridx]
        node.up = False
        self.metrics.record_replica_event("fail")
        running = self._running[ridx]
        if running:
            moves = self._plan_migrations(running, ridx, t) \
                if (self.migrate and self.topology is not None) else {}
            self.backends[ridx].remove(running)
            batcher = self.batchers[ridx]
            for r in list(running):
                r.preemptions += 1
                r.state = RequestState.QUEUED
                batcher.shrunk.pop(r.rid, None)
                if r.rid in moves:
                    dst, kv_gb = moves[r.rid]
                    self._start_migration(r, ridx, dst, kv_gb, t)
                else:
                    self._pending[ridx].append(r)
            running.clear()
        self._drain_pending(ridx, t)
        self._sync_node(ridx)

    def _repair_replica(self, t: float, ridx: int) -> None:
        """The failed replica comes back empty (weights resident, no
        KV) and re-enters routing; a fresh step chain re-admits
        whatever parked on it while everything else was down."""
        if ridx not in self._failed:
            return
        self._failed.discard(ridx)
        self.runtime.cluster[ridx].up = True
        self.metrics.record_replica_event("repair")
        self._push_step(max(t, self._clocks[ridx]), ridx)

    def _drain_pending(self, ridx: int, t: float) -> None:
        """Re-route a down replica's queued requests to live replicas
        (requeue-origin re-admission: they keep their admission /
        preemption history).  Routers fall back to down nodes when
        nothing is up, so a candidate that routes back to a down node
        parks locally and re-enters service on repair."""
        stranded = list(self._pending[ridx])
        if not stranded:
            return
        self._pending[ridx] = []
        woken = set()
        for req in stranded:
            vec = self.demand.request_vector(req)
            node = self.runtime.route(vec, now=t, tenant=req.tenant)
            if not node.up or node.nid == ridx \
                    or node.nid in self._failed:
                self._pending[ridx].append(req)   # nowhere to go
                continue
            self._pending[node.nid].append(req)
            woken.add(node.nid)
        for nid in sorted(woken):
            self._sync_node(nid)
            self._push_step(max(t, self._clocks[nid]), nid)

    def _on_autoscale(self, t: float, _payload) -> Optional[bool]:
        """One autoscaler tick: observe queue depth and SLO attainment,
        spawn a spare (topology-aware: the rack with the most ingress
        uplink headroom) or drain the emptiest autoscaled replica, then
        re-arm — until no work remains anywhere."""
        aus = self.autoscaler
        depth = sum(len(p) for p in self._pending) \
            + sum(len(x) for x in self._in_transit)
        busy = any(self._running)
        if depth == 0 and not busy \
                and self.queue.next_arrival() is None:
            return False          # drained for good: stop the re-arm
        active = [n.nid for n in self.runtime.cluster
                  if n.up and n.nid not in self._failed]
        action = aus.observe(t, queue_depth=float(depth),
                             active=len(active))
        if action == "up":
            spares = [n.nid for n in self.runtime.cluster
                      if not n.up and n.nid not in self._failed]
            nid = pick_spawn_node(spares, self.topology)
            if nid is not None:
                self.runtime.cluster[nid].up = True
                self.metrics.record_replica_event("scale_up")
                if self.tracer is not None:
                    self.tracer.instant(
                        "scale-up", t, process="autoscaler",
                        thread="events", args={"node": nid})
                self._push_step(max(t, self._clocks[nid]), nid)
        elif action == "down":
            # only autoscaled replicas drain; the base fleet persists
            cands = [nid for nid in active
                     if nid >= self._initial_replicas]
            if cands:
                nid = min(cands, key=lambda n: (
                    len(self._running[n]) + len(self._pending[n])
                    + len(self._in_transit[n]), -n))
                self.runtime.cluster[nid].up = False
                self.metrics.record_replica_event("scale_down")
                if self.tracer is not None:
                    self.tracer.instant(
                        "scale-down", t, process="autoscaler",
                        thread="events", args={"node": nid})
                # queued work re-routes now; running work finishes on
                # the draining replica (its step chain keeps going)
                self._drain_pending(nid, t)
                self._sync_node(nid)
        self.runtime.push(t + aus.interval_s, Autoscaler.KIND, None)

    # --- the loops --------------------------------------------------------
    def run(self) -> Dict:
        t = self._run_continuous() if self.mode == "continuous" \
            else self._run_wave()
        if self.topology is not None:
            self.metrics.record_link_stats(
                self.topology.link_stats(now=t, elapsed=t))
        return self.metrics.summary(elapsed=t)

    # --- continuous mode: step events on the ClusterRuntime ---------------
    def _push_step(self, t: float, ridx: int) -> None:
        """Schedule replica ``ridx``'s next step.  With no topology the
        payload is the bare replica index — the exact legacy event
        stream, bit-identical.  With one, transmission completions can
        wake a replica that already has a step outstanding, so payloads
        carry a generation and each push supersedes the previous event
        (at most one LIVE step per replica — the same stale-event
        discipline as the simulator's re-timed finishes).  Failure
        injection and autoscaling wake replicas the same way (repair,
        scale-up), so they force generation payloads too."""
        if self.topology is None and self.failures is None \
                and self.autoscaler is None:
            self.runtime.push(t, "step", ridx)
        else:
            self._step_gen[ridx] += 1
            self.runtime.push(t, "step", (ridx, self._step_gen[ridx]))

    def _on_step(self, t: float, payload):
        """One decode step on a replica — or an idle wake that consumes
        the next arrival.  Exactly the body of the pre-runtime
        sequential loop, dispatched per replica by the event clock."""
        if isinstance(payload, tuple):
            ridx, gen = payload
            if gen != self._step_gen[ridx]:
                return False          # superseded by a delivery wake
        else:
            ridx = payload
        if ridx in self._failed:
            return False  # failed replica: chain dies; repair re-pushes
        self._route_released(t)
        running = self._running[ridx]
        cands = self._candidates_for(ridx, t)
        if not running and not cands:
            nxt = self.queue.next_arrival()
            if nxt is None:
                if self._pending[ridx]:
                    # pending exists but nothing can join (should be
                    # impossible: empty batch accepts any valid request)
                    raise RuntimeError("serving deadlock: pending "
                                       "requests but no candidates")
                return False  # replica idle for good: chain ends
            self._push_step(nxt, ridx)
            return False      # idle wake, not a planned step
        plan = self.batchers[ridx].plan_step(running, cands, t,
                                             self._step_no)
        dt_join = self._apply(plan, ridx, t)
        dt_decode = self.backends[ridx].decode(running)
        shrunk = self.batchers[ridx].shrunk
        if shrunk:
            # a decode step is lockstep across the batch: the slowest
            # member — the deepest shrink grant, paying its modeled
            # spill slowdown — sets the step time
            dt_decode *= max((shrunk[r.rid][1] for r in running
                              if r.rid in shrunk), default=1.0)
        dt = dt_join + dt_decode
        t_end = t + dt
        self._step_no += 1
        for r in running:
            # chunked-prefill backends keep a request running before it
            # has emitted anything; TTFT stamps only once a token exists
            if r.first_token_t is None and r.tokens_decoded:
                r.first_token_t = t_end
        self._retire(ridx, t_end)
        self._sync_node(ridx)
        self.metrics.record_step(plan, dt)
        if self.tenancy is not None:
            self._observe_tenancy(plan, ridx)
        if self.tracer is not None:
            self._trace_step(plan, ridx, t, t_end, dt_join)
        if self._step_no > self.max_steps:
            raise RuntimeError(
                f"engine exceeded its structural step bound "
                f"({self.max_steps}) — termination invariant broken")
        self._clocks[ridx] = t_end
        self._push_step(t_end, ridx)

    def _observe_tenancy(self, plan: StepDecision, ridx: int) -> None:
        """Fold one step into the fairness state: per-tenant reject
        signals (requeue-vs-new, so preemption churn doesn't read as
        demand mis-prediction) into the registry's credit windows and
        the metrics' per-tenant counters, plus a dominant-share sample
        per named tenant on the stepping node."""
        reg = self.tenancy
        for rid in plan.rejected_rids:
            r = self._by_rid[rid]
            origin = "requeue" if (r.admissions > 0
                                   or r.preemptions > 0) else "new"
            reg.observe_reject(r.tenant, origin, now=plan.t)
            self.metrics.record_tenant_reject(r.tenant, origin)
        node = self.runtime.cluster[ridx]
        for name in reg.names():
            if name is None:
                continue
            self.metrics.record_tenant_share(
                name, reg.dominant_share(reg.usage(name, ridx),
                                         node.capacity))

    def _trace_step(self, plan: StepDecision, ridx: int, t: float,
                    t_end: float, dt_join: float) -> None:
        """One 'step' span per planned step on the replica's track,
        split into prefill/decode sub-phases, with preempt/forced
        instants and per-axis node utilization counter samples.  The
        span args carry raw virtual seconds ('t0'/'t1') so the report's
        busy-time integral is float-exact, not a µs round-trip."""
        proc = f"replica{ridx}"
        tr = self.tracer
        tr.complete("step", t, t_end, process=proc, thread="steps",
                    cat="serving",
                    args={"step": plan.step, "batch": plan.batch,
                          "admitted": len(plan.admitted),
                          "preempted": len(plan.preempted),
                          "binding": plan.binding_axis,
                          "t0": t, "t1": t_end})
        if dt_join > 0.0:
            tr.complete("prefill", t, t + dt_join, process=proc,
                        thread="phases", cat="serving",
                        args={"t0": t, "t1": t + dt_join})
        if t_end > t + dt_join:
            tr.complete("decode", t + dt_join, t_end, process=proc,
                        thread="phases", cat="serving",
                        args={"t0": t + dt_join, "t1": t_end})
        for rid in plan.preempted:
            tr.instant("preempt", t, process=proc, thread="events",
                       args={"rid": rid})
        if plan.forced:
            tr.instant("forced", t, process=proc, thread="events",
                       args={"rids": list(plan.forced_rids)})
        node = self.runtime.cluster[ridx]
        tr.counter(f"node{ridx}:util", t_end,
                   {axis: node.utilization(axis)
                    for axis in node.capacity.axes}, process=proc)
        sample_node(self.telemetry, node, t_end)

    def _run_continuous(self) -> float:
        self.runtime.on("step", self._on_step)
        if self.failures is not None:
            # failures target the base fleet; autoscaled spares are the
            # relief capacity
            self.failures.attach(
                self.runtime, on_fail=self._fail_replica,
                on_repair=self._repair_replica,
                n_targets=self._initial_replicas)
        if self.autoscaler is not None:
            self.runtime.on(Autoscaler.KIND, self._on_autoscale)
            self.runtime.push(self.autoscaler.interval_s,
                              Autoscaler.KIND, None)
        for ridx in range(self._initial_replicas):
            self._push_step(0.0, ridx)
        self.runtime.run()
        return max(self._clocks)

    # --- wave mode (legacy, single replica) -------------------------------
    def _wave_admission(self, cands: Sequence[Request]):
        """Once-per-wave admission against the worst-case footprint:
        every slot booked at the wave's longest full context (the
        pre-engine ``launch/serve.py`` behaviour)."""
        lmax = max(r.prefill_len + r.remaining_new for r in cands)
        curves = {"hbm": MemoryFunction(
            "affine", self.demand.weights_gb,
            self.demand.kv_gb(lmax))}
        for axis, per_req in self.demand.per_request_axes().items():
            curves[axis] = MemoryFunction("affine", 0.0, per_req)
        dm = DemandModel(curves, primary_axis="hbm")
        return self.controller.admit_batch(
            dm, self.budget, min_batch=1,
            max_batch=min(self.max_batch, len(cands)))

    def _run_wave(self) -> float:
        t, step = 0.0, 0
        while self.queue.next_arrival() is not None or self._pending[0]:
            self._route_released(t)
            cands = self._candidates_for(0, t)
            if not cands:
                nxt = self.queue.next_arrival()
                if nxt is None:
                    raise RuntimeError("serving deadlock in wave mode")
                t = nxt
                continue
            dec = self._wave_admission(cands)
            wave = cands[:int(dec.units)]
            forced = bool(dec.info.get("forced"))
            plan = StepDecision(
                step=step, t=t, admitted=tuple(r.rid for r in wave),
                preempted=(), batch=len(wave),
                booked=self.demand.booked(wave, 0), budget=self.budget,
                binding_axis=dec.binding_axis,
                forced=forced,
                forced_axes=tuple(dec.info.get("forced_axes", ())),
                # the unified record shape: a forced wave names every
                # request it force-admitted, like the batcher's floor
                forced_rids=tuple(r.rid for r in wave) if forced else ())
            dt = self._apply(plan, 0, t)
            wave_live = [self._by_rid[rid] for rid in plan.admitted]
            self.metrics.record_step(plan, dt)
            step += 1            # step ids stay unique and monotone
            t += dt
            for r in wave_live:  # the wave's prefill emitted one token
                if r.first_token_t is None and r.tokens_decoded:
                    r.first_token_t = t
            self._sync_node(0)
            # drain the whole wave: finished requests idle in their
            # slots (full-occupancy step cost) until the last finishes
            while any(not r.done for r in wave_live):
                sdt = self.backend.decode(wave_live)
                t += sdt
                for r in wave_live:
                    if r.first_token_t is None and r.tokens_decoded:
                        r.first_token_t = t
                self.metrics.record_step(StepDecision(
                    step=step, t=t, admitted=(), preempted=(),
                    batch=len(wave_live),
                    booked=self.demand.booked(wave_live, 0),
                    budget=self.budget, binding_axis=None,
                    forced=plan.forced,
                    forced_axes=plan.forced_axes,
                    forced_rids=plan.forced_rids), sdt)
                step += 1
                if step > self.max_steps:
                    raise RuntimeError("wave mode exceeded its "
                                       "structural step bound")
            for r in wave_live:
                r.state = RequestState.FINISHED
                r.finish_t = t
                self._running[0].remove(r)
                if self.tenancy is not None:
                    self.tenancy.observe_request(r)
                self._trace_req_end(r, t)
            self.backend.remove(wave_live)
            self._sync_node(0)
        return t
