"""Event-driven ClusterRuntime: ONE node/route/clock substrate under the
batch simulator and the serving engine.

Before this module the paper's online decision loop — admit work against
per-node headroom, advance a virtual clock, react to completions — was
implemented twice: once as the wave-advance heap in
``core/simulator.py::Simulator.run`` (batch jobs over ``Host``s) and
once as the step loop in ``serve/engine.py::Engine`` (requests over a
single implicit replica).  Every cluster-level follow-on (multi-replica
routing over the ``net`` axis, SLO-goodput, axis-shaded budgets) would
have had to be built twice.  This module factors the shared substrate
out, in the event-driven replay style of the related schedulers
(Firmament's ``ReplaySimulation()``):

* :class:`EventLoop`   — a virtual-clock event heap (arrival /
  completion / step / refresh events, FIFO-stable within a timestamp);
  no fixed-quantum wave advance — time moves exactly to the next event.
* :class:`Node`        — booked per-axis capacity accounting for one
  schedulable node (a simulator ``Host`` or a serving replica): a
  :class:`~repro_torch.sched.resources.ResourceVector` capacity, a keyed
  ledger of booked claim vectors, headroom queries, and the binding-axis
  decision counters that used to live on the consumers.
* :class:`ClusterState` — N nodes with cluster-wide headroom /
  binding-axis aggregation.
* a ``Router`` registry mirroring ``sched/placement.py``
  (``register_router`` / ``get_router`` / ``available_routers``):
  ``single``, ``least-loaded``, ``net-aware`` — routes each admitted
  job/request to a node using the *estimator's multi-axis demand
  vector* against per-node headroom (the ``net-aware`` router is what
  makes multi-replica serving routing over the ``net`` axis real).
* :class:`ClusterRuntime` — ties them together: push events, register
  handlers per event kind, ``run()`` the clock, ``route()`` demands.

Consumers: ``core/simulator.py`` registers its arrive/profiled/finish/
fail handlers on a runtime and ``Simulator.run`` is now a thin shim
(results pinned bit-identical by ``tests/test_cluster.py`` goldens);
``serve/engine.py`` runs continuous batching as ``step`` events over
1..N replica Nodes (``launch/serve.py --replicas N --router
net-aware``).

Like ``placement``/``resources``, this module imports nothing from
``repro_torch.core`` — it is import-cycle-free and loadable first.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Type, Union)

from repro_torch.obs.telemetry import Telemetry
from repro_torch.sched.resources import ResourceVector

_EPS = 1e-12


# ---------------------------------------------------------------------------
# EventLoop
# ---------------------------------------------------------------------------

class EventLoop:
    """Virtual-clock event heap.

    Events are ``(t, seq, kind, payload)`` tuples ordered by time with a
    monotone sequence number breaking ties, so two events at the same
    timestamp dispatch in push order (FIFO) and payloads are never
    compared — exactly the discipline the simulator's inline heap used,
    which is what keeps the legacy goldens bit-identical.

    The loop does not advance ``t`` itself: whoever drains it (normally
    :meth:`ClusterRuntime.run`) sets the clock, because policies differ
    on whether an over-horizon event moves time before the run stops.
    """

    __slots__ = ("_heap", "_seq", "t")

    def __init__(self):
        self._heap: List[Tuple] = []
        self._seq = itertools.count()
        self.t = 0.0

    def push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def pop(self) -> Tuple[float, int, str, object]:
        return heapq.heappop(self._heap)

    def peek_t(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# ---------------------------------------------------------------------------
# Node / ClusterState
# ---------------------------------------------------------------------------

class Node:
    """Booked per-axis capacity accounting for one schedulable node.

    A node is where admitted work lands: a simulator host's executor
    claims or a serving replica's in-flight request footprints.  Claims
    are keyed (executor id, request id, ...) so release/rebook are exact,
    and the headroom computation mirrors the pre-refactor
    ``Host.free_vector`` float-for-float: per axis, sum the claims in
    insertion order and subtract from capacity.
    """

    __slots__ = ("nid", "capacity", "_claims", "binding_axes", "up")

    def __init__(self, nid: int, capacity: ResourceVector):
        self.nid = int(nid)
        self.capacity = capacity
        self._claims: Dict[object, ResourceVector] = {}
        #: axis -> count of admission decisions it bound on this node
        self.binding_axes: Dict[str, int] = {}
        self.up = True

    # --- the claim ledger -------------------------------------------------
    def book(self, key, vec: ResourceVector) -> None:
        if key in self._claims:
            raise KeyError(f"claim {key!r} already booked on node "
                           f"{self.nid} — use rebook()")
        self._claims[key] = vec

    def rebook(self, key, vec: ResourceVector) -> None:
        """Replace a live claim (a serving request's KV grows every
        step) without changing its ledger position."""
        if key not in self._claims:
            raise KeyError(f"claim {key!r} not booked on node {self.nid}")
        self._claims[key] = vec

    def release(self, key) -> ResourceVector:
        return self._claims.pop(key)

    def claim(self, key) -> Optional[ResourceVector]:
        return self._claims.get(key)

    def keys(self) -> List[object]:
        """Live claim keys, in booking order (a snapshot — safe to
        release() while iterating it)."""
        return list(self._claims)

    def __contains__(self, key) -> bool:
        return key in self._claims

    @property
    def n_claims(self) -> int:
        return len(self._claims)

    # --- queries ----------------------------------------------------------
    @property
    def booked(self) -> ResourceVector:
        """Total booked demand over every axis any claim carries."""
        total = ResourceVector()
        for v in self._claims.values():
            total = total + v
        return total

    def headroom(self) -> ResourceVector:
        """Unbooked capacity per capacity axis.  Bit-identical to the
        legacy ``Host.free_vector``: per-axis sums over claims in
        insertion order (missing axes contribute 0.0)."""
        used = {a: sum(v.get(a, 0.0) for v in self._claims.values())
                for a in self.capacity.axes}
        return self.capacity.headroom(ResourceVector(**used))

    def utilization(self, axis: str) -> float:
        """Booked fraction of ``axis`` (0.0 when the axis is not
        capacitated — an unconstrained axis is never 'loaded')."""
        cap = self.capacity.get(axis, 0.0)
        if cap <= _EPS:
            return 0.0
        return sum(v.get(axis, 0.0)
                   for v in self._claims.values()) / cap

    def record_binding(self, axis: str) -> None:
        self.binding_axes[axis] = self.binding_axes.get(axis, 0) + 1

    def __repr__(self) -> str:
        return (f"Node({self.nid}, claims={len(self._claims)}, "
                f"capacity={self.capacity!r})")


class ClusterState:
    """N nodes with cluster-wide aggregation queries."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes = list(nodes)

    @classmethod
    def homogeneous(cls, n: int, capacity: ResourceVector
                    ) -> "ClusterState":
        return cls([Node(i, capacity) for i in range(n)])

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, i: int) -> Node:
        return self.nodes[i]

    def up_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.up]

    def headroom(self) -> List[ResourceVector]:
        return [n.headroom() for n in self.nodes]

    def binding_axes(self) -> Dict[str, int]:
        """Cluster-wide binding-axis histogram (sum over nodes)."""
        out: Dict[str, int] = {}
        for n in self.nodes:
            for a, c in n.binding_axes.items():
                out[a] = out.get(a, 0) + c
        return out


# ---------------------------------------------------------------------------
# Router registry (mirrors repro_torch.sched.placement)
# ---------------------------------------------------------------------------

class Router:
    """Routing protocol: pick the node an admitted unit of work lands
    on, given its predicted multi-axis demand vector.  Subclass +
    ``@register_router(name)``.

    ``route`` must be a *pure deterministic choice* (no RNG, no
    mutation): it sees per-node headroom and the demand and returns one
    of the nodes — ties must resolve to the lowest node id so seeded
    runs stay reproducible.  Admission (does it actually fit?) stays
    with the consumer's controller; a router only says *where to try*.
    """

    name = "base"
    #: routers that score on link state set this True; the runtime then
    #: binds its Topology (if any) onto ``self.topology`` before routing
    uses_topology = False
    topology = None
    #: routers that score per-tenant fair shares set this True; the
    #: runtime then binds its TenantRegistry (if any) onto
    #: ``self.tenancy`` and the requesting tenant onto ``self.tenant``
    #: before routing (see repro_torch.sched.tenancy)
    uses_tenancy = False
    tenancy = None
    tenant = None

    def route(self, demand: Optional[ResourceVector],
              nodes: Sequence[Node], now: float = 0.0) -> Node:
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Router]] = {}


def register_router(name: str):
    """Class decorator adding a router to the registry under ``name``."""
    def deco(cls: Type[Router]) -> Type[Router]:
        if not issubclass(cls, Router):
            raise TypeError(f"{cls!r} is not a Router")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_router(name: str) -> Router:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown router {name!r} "
                       f"(available: {available_routers()})") from None


def available_routers() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def _fit_score(node: Node, demand: Optional[ResourceVector]) -> float:
    """How comfortably ``demand`` fits ``node``: the min over demanded,
    capacitated axes of the headroom fraction (worst-axis view, so a
    node choked on ANY needed axis scores low).  With no overlapping
    axes (or no demand) the same worst-axis view runs over ALL
    capacitated axes instead."""
    head = node.headroom()
    fracs = []
    axes = (demand.axes if demand is not None else ())
    for a in axes:
        cap = node.capacity.get(a, 0.0)
        if cap > _EPS:
            fracs.append(head.get(a, 0.0) / cap)
    if not fracs:
        fracs = [head.get(a, 0.0) / node.capacity[a]
                 for a in node.capacity.axes
                 if node.capacity[a] > _EPS] or [0.0]
    return min(fracs)


@register_router("single")
class SingleRouter(Router):
    """Everything lands on the first up node — the implicit pre-runtime
    behaviour of the one-replica serving engine, kept as the routing
    baseline the multi-replica sweeps compare against."""

    def route(self, demand, nodes, now=0.0):
        for n in nodes:
            if n.up:
                return n
        return nodes[0]


@register_router("least-loaded")
class LeastLoadedRouter(Router):
    """Best worst-axis headroom fraction for THIS demand vector (stable
    argmax: ties go to the lowest node id)."""

    def route(self, demand, nodes, now=0.0):
        cands = [n for n in nodes if n.up] or list(nodes)
        return max(cands, key=lambda n: (_fit_score(n, demand), -n.nid))


@register_router("net-aware")
class NetAwareRouter(Router):
    """Route on the ``net`` axis first: the node with the most free
    egress/interconnect bandwidth fraction wins; the generic fit score
    breaks ties and covers clusters that do not budget ``net`` at all
    (where this router degrades to ``least-loaded``).

    DEPRECATED-but-pinned: this is the per-node-counter view of the
    network — it cannot see shared links.  New topology-bound clusters
    should use ``topo-aware`` (``repro_torch.sched.topology``), which scores
    by bottleneck-link residual bandwidth along the actual route; this
    shim stays byte-identical, golden-pinned."""

    def route(self, demand, nodes, now=0.0):
        cands = [n for n in nodes if n.up] or list(nodes)

        def key(n: Node):
            cap = n.capacity.get("net", 0.0)
            net = n.headroom().get("net", 0.0) / cap if cap > _EPS \
                else -1.0
            return (net, _fit_score(n, demand), -n.nid)
        return max(cands, key=key)


# ---------------------------------------------------------------------------
# ClusterRuntime
# ---------------------------------------------------------------------------

class ClusterRuntime:
    """The event-driven substrate: a virtual clock over cluster state.

    Consumers register one handler per event kind (``on``), push timed
    events, and ``run()`` the loop; the runtime owns the clock and the
    node ledger, and ``route()`` asks the configured router where a
    demand vector should land.  The runtime is deliberately free of
    workload semantics — jobs, requests, profiling, preemption all live
    in the consumers' handlers — which is what lets ONE loop serve both
    the batch simulator and the serving engine.
    """

    def __init__(self, cluster: ClusterState,
                 router: Union[str, Router, None] = None,
                 topology=None, tracer=None,
                 telemetry: Optional[Telemetry] = None,
                 tenancy=None):
        self.loop = EventLoop()
        self.cluster = cluster
        self.router = get_router(router) if isinstance(router, str) \
            else router
        self._handlers: Dict[str, Callable[[float, object], None]] = {}
        #: optional repro_torch.obs.trace.Tracer — None (the default) means
        #: no trace is collected and dispatch pays only a None check,
        #: so untraced runs stay bit-identical to the pre-obs runtime
        self.tracer = tracer
        #: always-on counter/gauge registry: deterministic per-kind
        #: event counts live in counters, wall-clock rates ONLY in
        #: gauges (never surfaced in seed-pinned summaries)
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        #: optional repro_torch.sched.topology.Topology; when set, its
        #: transmission events run on this loop and topology-aware
        #: routers see it (default None keeps every schedule identical)
        self.topology = None
        if topology is not None:
            self.topology = topology.attach(self)
        #: optional repro_torch.sched.tenancy.TenantRegistry; tenancy-aware
        #: routers (``uses_tenancy``) see it at route time, exactly the
        #: late-binding pattern topology uses (default None keeps every
        #: schedule identical — drf degrades to least-loaded)
        self.tenancy = tenancy

    # --- clock / events ---------------------------------------------------
    @property
    def t(self) -> float:
        return self.loop.t

    def push(self, t: float, kind: str, payload=None) -> None:
        self.loop.push(t, kind, payload)

    def on(self, kind: str,
           handler: Callable[[float, object], None]) -> None:
        """Register ``handler(t, payload)`` for event ``kind`` (one per
        kind; re-registering replaces).  A handler may return ``False``
        to mark the event stale (an executor already gone, a re-timed
        completion superseded): stale events advance the clock but skip
        the post-event ``tick``/``until`` hooks, exactly like the
        legacy loops' ``continue``."""
        self._handlers[kind] = handler

    # --- routing ----------------------------------------------------------
    def route(self, demand: Optional[ResourceVector] = None,
              now: Optional[float] = None,
              tenant: Optional[str] = None) -> Node:
        if self.router is None:
            raise RuntimeError("this ClusterRuntime has no router — "
                               "construct it with router=<name or "
                               "Router instance>")
        if getattr(self.router, "uses_topology", False):
            self.router.topology = self.topology
        if getattr(self.router, "uses_tenancy", False):
            self.router.tenancy = self.tenancy
            self.router.tenant = tenant
        return self.router.route(demand, self.cluster.nodes,
                                 now=self.t if now is None else now)

    # --- the loop ---------------------------------------------------------
    def run(self, *, max_time: float = float("inf"),
            until: Optional[Callable[[], bool]] = None,
            tick: Optional[Callable[[float], None]] = None) -> float:
        """Drain events in time order until the heap empties, an event
        lands past ``max_time`` (the clock does NOT advance to it —
        legacy horizon semantics), or ``until()`` returns True after an
        event.  ``tick(t)`` runs after every dispatched event (trace
        collection).  Returns the final clock.

        Every dispatched event counts into ``telemetry.counters``
        (``events.<kind>``, ``events.stale.<kind>``) and, with a tracer
        bound, emits one zero-duration slice per event kind on the
        ``runtime`` track — the span-per-event-kind view of the loop.
        Wall-clock throughput (events/sec of REAL time) lands only in
        ``telemetry.gauges`` so it can never leak into seed-pinned
        summaries."""
        tracer, tm = self.tracer, self.telemetry
        dispatched = 0
        wall0 = time.perf_counter()
        while self.loop:
            t, _, kind, payload = self.loop.pop()
            if t > max_time:
                break
            self.loop.t = t
            try:
                handler = self._handlers[kind]
            except KeyError:
                raise KeyError(f"no handler registered for event kind "
                               f"{kind!r}") from None
            tm.inc(f"events.{kind}")
            dispatched += 1
            if handler(t, payload) is False:
                tm.inc(f"events.stale.{kind}")
                if tracer is not None:
                    tracer.instant(f"stale:{kind}", t,
                                   process="runtime", thread=kind)
                continue                       # stale event (see on())
            if tracer is not None:
                tracer.complete(f"event:{kind}", t, t,
                                process="runtime", thread=kind)
            if tick is not None:
                tick(t)
            if until is not None and until():
                break
        wall = time.perf_counter() - wall0
        tm.inc("events.dispatched", dispatched)
        tm.set_gauge("wall_s", tm.gauges.get("wall_s", 0.0) + wall)
        if wall > 0.0:
            tm.set_gauge("events_per_s_wall", dispatched / wall)
        return self.loop.t
