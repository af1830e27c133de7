"""Network topology as a first-class ClusterRuntime citizen: Links,
Transmissions, and fair-share bandwidth partitioning on the EventLoop.

Until this module, the ``net`` axis was fiction twice over: admission
booked a *declared* linear contention curve
(``ModelTarget.net_gbps_per_req``) and routing saw only per-node
counters — no link could congest, no transfer cost virtual time, and a
preempted request could only requeue locally because moving its KV had
no price.  This module makes cross-node traffic REAL on the shared
virtual clock, in the style of the Helix simulator's
``NetworkLink``/``TransmissionObject`` pair:

* :class:`Link`         — one directed edge: bandwidth (GB/s), fixed
  latency, and a ledger of in-flight :class:`Transmission`\\ s.  The
  link's bandwidth is **fair-share partitioned**: each of ``n``
  concurrent flows gets ``bandwidth / n``.
* :class:`Transmission` — one transfer (``gb`` bytes over a path of
  links): progress is advanced lazily and its completion event is
  re-timed (generation-counted, so superseded events are stale — the
  same discipline as the simulator's re-timed ``finish`` events)
  whenever a flow joins or leaves any link on its path.
* :class:`Topology`     — named nodes + directed links with
  deterministic shortest-hop path lookup.  ``attach(runtime)`` registers
  the ``net-start``/``net-done`` handlers on a
  :class:`~repro_torch.sched.cluster.ClusterRuntime`; ``transmit()`` then runs
  transfers as real events on that loop.  Completed transfers are
  logged as measured ``(bytes, duration)`` probes —
  :meth:`Topology.net_probes` feeds them to the estimator registry
  (``ModelTarget.net_probes``), replacing the declared net constant
  with a curve fitted through the existing two-point family selection.
* ``register_topology`` — a preset registry mirroring the router /
  placement / estimator registries: ``single-switch``, ``two-rack``,
  ``ring``.  Replica node ``nid`` maps to topology node ``n<nid>``;
  every preset also has an ``ingress`` node (where request payloads
  enter the cluster).
* :class:`TopoAwareRouter` (``topo-aware``) — scores candidate nodes by
  **path headroom**: the bottleneck link's residual fair share along
  the ingress route (what one more flow would actually get), not a
  per-node scalar.  Degrades to ``least-loaded`` when no topology is
  bound (the ``net-aware`` router stays registered as the
  deprecated-but-pinned per-node-counter shim).

The fair-share model gives a hard lower bound the property tests pin:
a transfer of ``gb`` bytes over a path whose narrowest link has
bandwidth ``B`` can never complete before ``latency + gb / B`` — it
could only ever get *less* than the exclusive bandwidth.

Like the rest of ``repro_torch.sched``, this module imports nothing from
``repro_torch.core`` or ``repro_torch.serve``.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.cluster import Router, _fit_score, register_router

_EPS = 1e-12


class Link:
    """One directed edge: ``bandwidth`` GB/s shared fairly among the
    in-flight transmissions in its ledger, plus a fixed propagation
    latency charged once per transfer before any byte moves."""

    __slots__ = ("name", "src", "dst", "gbps", "latency_s", "flows",
                 "busy_s", "bytes_gb", "peak_flows", "_busy_since")

    def __init__(self, src: str, dst: str, gbps: float,
                 latency_s: float = 0.0, name: Optional[str] = None):
        if gbps <= 0.0:
            raise ValueError(f"link {src}->{dst}: bandwidth must be > 0")
        if latency_s < 0.0:
            raise ValueError(f"link {src}->{dst}: latency must be >= 0")
        self.src = str(src)
        self.dst = str(dst)
        self.gbps = float(gbps)
        self.latency_s = float(latency_s)
        self.name = name or f"{self.src}->{self.dst}"
        #: tid -> in-flight Transmission (the per-link ledger)
        self.flows: Dict[int, "Transmission"] = {}
        #: virtual seconds with >= 1 flow in the ledger (closed
        #: intervals; in-progress busy is added by ``Topology.link_stats``)
        self.busy_s = 0.0
        #: GB actually moved over this link (credited as flows advance)
        self.bytes_gb = 0.0
        #: highest concurrent-flow count ever seen
        self.peak_flows = 0
        self._busy_since: Optional[float] = None

    @property
    def n_flows(self) -> int:
        return len(self.flows)

    def add_flow(self, tr: "Transmission", now: float) -> None:
        """Ledger insert + busy/peak bookkeeping (0 -> 1 flows opens a
        busy interval)."""
        if not self.flows:
            self._busy_since = now
        self.flows[tr.tid] = tr
        if len(self.flows) > self.peak_flows:
            self.peak_flows = len(self.flows)

    def drop_flow(self, tid: int, now: float) -> None:
        """Ledger remove; the last flow leaving closes the busy
        interval into ``busy_s``."""
        if self.flows.pop(tid, None) is not None and not self.flows \
                and self._busy_since is not None:
            self.busy_s += max(now - self._busy_since, 0.0)
            self._busy_since = None

    def fair_share(self) -> float:
        """GB/s each CURRENT flow gets (full bandwidth when idle)."""
        return self.gbps / max(len(self.flows), 1)

    def residual_gbps(self) -> float:
        """GB/s one MORE flow would get — the router's headroom view."""
        return self.gbps / (len(self.flows) + 1)

    def __repr__(self) -> str:
        return (f"Link({self.name}, {self.gbps}GB/s, "
                f"{self.n_flows} flows)")


class Transmission:
    """One transfer in flight: ``gb`` bytes over ``path``.  Progress
    (``done_gb``) advances lazily at the current fair-share ``rate``;
    ``gen`` counts re-timings so superseded completion events read as
    stale, exactly like the simulator's executor ``version``."""

    __slots__ = ("tid", "src", "dst", "gb", "tag", "path", "start_t",
                 "t_last", "done_gb", "rate", "gen", "finish_t",
                 "on_complete")

    def __init__(self, tid: int, src: str, dst: str, gb: float,
                 path: Tuple[Link, ...], start_t: float,
                 tag: str = "", on_complete: Optional[Callable] = None):
        self.tid = tid
        self.src = src
        self.dst = dst
        self.gb = float(gb)
        self.tag = tag
        self.path = path
        self.start_t = float(start_t)
        self.t_last = float(start_t)
        self.done_gb = 0.0
        self.rate = 0.0
        self.gen = 0
        self.finish_t: Optional[float] = None
        self.on_complete = on_complete

    @property
    def remaining_gb(self) -> float:
        return max(self.gb - self.done_gb, 0.0)

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.finish_t is None \
            else self.finish_t - self.start_t

    def __repr__(self) -> str:
        return (f"Transmission({self.tid}, {self.src}->{self.dst}, "
                f"{self.done_gb:.3g}/{self.gb:.3g}GB)")


class Topology:
    """Named nodes + directed links, with transfers as real events.

    Convention: serving replica / simulator host ``nid`` is topology
    node ``n<nid>`` (:meth:`replica_name`); ``ingress`` names the node
    where request payloads enter.  Paths are shortest-hop BFS with
    insertion-ordered (deterministic) tie-breaking, cached per
    ``(src, dst)``.
    """

    def __init__(self, name: str = "", ingress: Optional[str] = None):
        self.name = name
        self.ingress = ingress
        self._nodes: Dict[str, None] = {}
        self._adj: Dict[str, List[Link]] = {}
        self._paths: Dict[Tuple[str, str], Tuple[Link, ...]] = {}
        self._runtime = None
        self._tids = itertools.count()
        self._active: Dict[int, Transmission] = {}
        self._log: List[Transmission] = []

    # --- construction -----------------------------------------------------
    def add_node(self, name: str) -> None:
        self._nodes.setdefault(str(name), None)
        self._adj.setdefault(str(name), [])

    def add_link(self, src: str, dst: str, gbps: float,
                 latency_s: float = 0.0) -> Link:
        """One DIRECTED edge (use :meth:`add_duplex` for both ways)."""
        for n in (src, dst):
            if n not in self._nodes:
                raise KeyError(f"unknown topology node {n!r} — "
                               f"add_node() it first")
        link = Link(src, dst, gbps, latency_s)
        self._adj[src].append(link)
        self._paths.clear()           # edges changed: route cache stale
        return link

    def add_duplex(self, a: str, b: str, gbps: float,
                   latency_s: float = 0.0) -> Tuple[Link, Link]:
        """Two independent directed links (full-duplex: each direction
        has its own bandwidth and flow ledger)."""
        return (self.add_link(a, b, gbps, latency_s),
                self.add_link(b, a, gbps, latency_s))

    def nodes(self) -> Tuple[str, ...]:
        return tuple(self._nodes)

    def links(self) -> Tuple[Link, ...]:
        return tuple(l for adj in self._adj.values() for l in adj)

    @staticmethod
    def replica_name(nid: int) -> str:
        """Topology node name for cluster node ``nid``."""
        return f"n{int(nid)}"

    def has_node(self, name: str) -> bool:
        return name in self._nodes

    # --- path lookup ------------------------------------------------------
    def path(self, src: str, dst: str) -> Tuple[Link, ...]:
        """Shortest-hop path ``src -> dst`` (BFS over insertion-ordered
        adjacency, so ties are deterministic).  Empty tuple when
        ``src == dst``; raises when unreachable."""
        key = (src, dst)
        hit = self._paths.get(key)
        if hit is not None:
            return hit
        for n in (src, dst):
            if n not in self._nodes:
                raise KeyError(f"unknown topology node {n!r}")
        if src == dst:
            self._paths[key] = ()
            return ()
        prev: Dict[str, Link] = {}
        q = deque([src])
        seen = {src}
        while q:
            cur = q.popleft()
            for link in self._adj[cur]:
                if link.dst in seen:
                    continue
                seen.add(link.dst)
                prev[link.dst] = link
                if link.dst == dst:
                    q.clear()
                    break
                q.append(link.dst)
        if dst not in prev:
            raise KeyError(f"no path {src!r} -> {dst!r} in topology "
                           f"{self.name!r}")
        hops: List[Link] = []
        cur = dst
        while cur != src:
            link = prev[cur]
            hops.append(link)
            cur = link.src
        out = tuple(reversed(hops))
        self._paths[key] = out
        return out

    def latency_s(self, src: str, dst: str) -> float:
        return sum(l.latency_s for l in self.path(src, dst))

    def exclusive_gbps(self, src: str, dst: str) -> float:
        """Bottleneck bandwidth with the path to itself: the best any
        single transfer could ever see (the lower-bound divisor)."""
        p = self.path(src, dst)
        return min((l.gbps for l in p), default=float("inf"))

    def path_residual_gbps(self, src: str, dst: str) -> float:
        """Bottleneck RESIDUAL fair share along the path: the GB/s one
        more flow would get given the current in-flight ledgers — the
        ``topo-aware`` router's scoring signal."""
        p = self.path(src, dst)
        return min((l.residual_gbps() for l in p), default=float("inf"))

    def estimate_transfer_s(self, src: str, dst: str, gb: float) -> float:
        """Modeled time for a ``gb`` transfer starting NOW at the
        current contention (residual share held constant) — what the
        migrate-vs-recompute decision compares against recompute cost."""
        res = self.path_residual_gbps(src, dst)
        if res == float("inf"):
            return 0.0
        return self.latency_s(src, dst) + float(gb) / max(res, _EPS)

    # --- transmissions on the event loop ----------------------------------
    def attach(self, runtime) -> "Topology":
        """Bind to a :class:`~repro_torch.sched.cluster.ClusterRuntime`:
        register the transmission event handlers on its loop.  Safe to
        call once per runtime; transfers then run as ``net-start`` /
        ``net-done`` events interleaved with the consumer's own."""
        self._runtime = runtime
        runtime.on("net-start", self._on_start)
        runtime.on("net-done", self._on_done)
        return self

    def transmit(self, src: str, dst: str, gb: float,
                 now: Optional[float] = None, tag: str = "",
                 on_complete: Optional[Callable] = None) -> Transmission:
        """Start a transfer; ``on_complete(t, transmission)`` fires when
        the last byte lands.  The transfer holds a slot in every link
        ledger along the path from ``now + path latency`` (pipe delay)
        until completion, repartitioning each link's fair share as it
        joins and leaves."""
        if self._runtime is None:
            raise RuntimeError("topology not attached to a "
                               "ClusterRuntime — call attach() first")
        t0 = self._runtime.t if now is None else float(now)
        path = self.path(src, dst)
        tr = Transmission(next(self._tids), src, dst, max(float(gb), 0.0),
                          path, t0, tag=tag, on_complete=on_complete)
        self._active[tr.tid] = tr
        if not path or tr.gb <= _EPS:
            # same-node (or empty) transfer: completes after latency,
            # still through the loop so callbacks stay event-ordered
            tr.done_gb = tr.gb
            self._runtime.push(t0 + self.latency_s(src, dst),
                               "net-done", (tr.tid, tr.gen))
        else:
            self._runtime.push(t0 + sum(l.latency_s for l in path),
                               "net-start", tr.tid)
        return tr

    def _on_start(self, t: float, tid: int):
        tr = self._active.get(tid)
        if tr is None:
            return False                      # cancelled before start
        for link in tr.path:
            link.add_flow(tr, t)
        tr.t_last = t
        self._repartition(t)
        self._trace_links(t, tr.path)

    def _on_done(self, t: float, payload):
        tid, gen = payload
        tr = self._active.get(tid)
        if tr is None or tr.gen != gen:
            return False                      # superseded re-timing
        self._advance(t)
        if tr.remaining_gb > 1e-9 * max(tr.gb, 1.0):
            self._retime(t)                   # numeric drift: re-time
            return False
        self._finalize(tr, t)

    # --- fair-share mechanics ---------------------------------------------
    def _started(self) -> List[Transmission]:
        """Active flows that are past their pipe delay (hold link
        slots), in tid order for determinism."""
        seen: Dict[int, Transmission] = {}
        for link in self.links():
            seen.update(link.flows)
        return [seen[tid] for tid in sorted(seen)]

    def _advance(self, now: float) -> None:
        for tr in self._started():
            dt = now - tr.t_last
            if dt > 0.0:
                moved = min(tr.gb, tr.done_gb + tr.rate * dt) \
                    - tr.done_gb
                tr.done_gb += moved
                if moved > 0.0:
                    for link in tr.path:
                        link.bytes_gb += moved
            tr.t_last = now

    def _retime(self, now: float) -> None:
        """Recompute every started flow's fair-share rate (min over its
        path of ``link bandwidth / link flows``) and push a fresh
        generation-stamped completion event."""
        for tr in self._started():
            tr.rate = min(l.fair_share() for l in tr.path)
            tr.gen += 1
            eta = now + tr.remaining_gb / max(tr.rate, _EPS)
            self._runtime.push(eta, "net-done", (tr.tid, tr.gen))

    def _repartition(self, now: float) -> None:
        self._advance(now)
        self._retime(now)

    def _finalize(self, tr: Transmission, t: float) -> None:
        for link in tr.path:
            link.drop_flow(tr.tid, t)
        del self._active[tr.tid]
        tr.finish_t = t
        tr.done_gb = tr.gb
        self._log.append(tr)
        self._repartition(t)                  # survivors speed up
        tracer = getattr(self._runtime, "tracer", None)
        if tracer is not None:
            tag = tr.tag or "net"
            tracer.complete(f"xfer:{tag}", tr.start_t, t,
                            process="network", thread=tag,
                            cat="network",
                            args={"gb": tr.gb, "src": tr.src,
                                  "dst": tr.dst, "tid": tr.tid,
                                  "t0": tr.start_t, "t1": t})
        self._trace_links(t, tr.path)
        if tr.on_complete is not None:
            tr.on_complete(t, tr)

    def _trace_links(self, t: float, path: Sequence[Link]) -> None:
        """Counter-track samples of the affected links' flow counts —
        the report integrates these into per-link busy fractions."""
        tracer = getattr(self._runtime, "tracer", None)
        if tracer is None:
            return
        for link in path:
            tracer.counter(f"link:{link.name}", t,
                           {"flows": link.n_flows}, process="network")

    def link_stats(self, now: Optional[float] = None,
                   elapsed: Optional[float] = None) -> Dict[str, Dict]:
        """Per-link utilization ledger: busy virtual seconds (including
        any interval still open at ``now``), busy fraction of
        ``elapsed``, GB moved, and peak concurrent flows."""
        out: Dict[str, Dict] = {}
        for link in self.links():
            busy = link.busy_s
            if link._busy_since is not None and now is not None:
                busy += max(float(now) - link._busy_since, 0.0)
            out[link.name] = {
                "busy_s": busy,
                "busy_frac": busy / elapsed
                if elapsed is not None and elapsed > 0.0 else 0.0,
                "bytes_gb": link.bytes_gb,
                "peak_flows": link.peak_flows,
            }
        return out

    # --- measured probes ---------------------------------------------------
    def completed(self, tag: Optional[str] = None) -> List[Transmission]:
        return [tr for tr in self._log
                if tag is None or tr.tag == tag]

    def net_probes(self, tag: Optional[str] = None,
                   max_points: int = 64) -> Tuple[Tuple[float, float], ...]:
        """Measured ``(bytes GB, duration s)`` pairs from completed
        transmissions — the probes ``ModelTarget.net_probes`` feeds the
        two-point family-selection fit, replacing the declared
        ``net_gbps_per_req`` constant with observed behaviour (the fit's
        intercept absorbs latency, its slope the effective inverse
        bandwidth under the contention the run actually saw)."""
        pts = [(tr.gb, tr.duration_s) for tr in self.completed(tag)
               if tr.duration_s is not None and tr.duration_s > 0.0
               and tr.gb > 0.0]
        return tuple(pts[-int(max_points):])

    def transfer_times(self, tag: Optional[str] = None) -> List[float]:
        return [tr.duration_s for tr in self.completed(tag)
                if tr.duration_s is not None]

    @property
    def in_flight(self) -> int:
        return len(self._active)

    def __repr__(self) -> str:
        return (f"Topology({self.name!r}, {len(self._nodes)} nodes, "
                f"{len(self.links())} links, {self.in_flight} in flight)")


# ---------------------------------------------------------------------------
# Preset registry (mirrors the router / placement / estimator registries)
# ---------------------------------------------------------------------------

_TOPO_REGISTRY: Dict[str, Callable[..., Topology]] = {}


def register_topology(name: str):
    """Decorator adding a topology builder (``**kwargs -> Topology``)
    to the preset registry under ``name``."""
    def deco(fn: Callable[..., Topology]) -> Callable[..., Topology]:
        _TOPO_REGISTRY[name] = fn
        return fn
    return deco


def get_topology(name: str, **kwargs) -> Topology:
    try:
        builder = _TOPO_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r} (available: "
                       f"{available_topologies()})") from None
    return builder(**kwargs)


def available_topologies() -> Tuple[str, ...]:
    return tuple(_TOPO_REGISTRY)


def _add_replicas(topo: Topology, nodes: int) -> List[str]:
    names = [Topology.replica_name(i) for i in range(int(nodes))]
    for n in names:
        topo.add_node(n)
    return names


@register_topology("single-switch")
def single_switch(nodes: int = 2, gbps: float = 10.0,
                  ingress_gbps: Optional[float] = None,
                  latency_s: float = 0.0) -> Topology:
    """``ingress -> sw -> n<i>``: one shared switch; every node hangs
    off it at ``gbps`` full duplex, ingress feeds the switch at
    ``ingress_gbps`` (default: same as the node links, so the shared
    ingress uplink is the natural contention point)."""
    topo = Topology("single-switch", ingress="ingress")
    topo.add_node("ingress")
    topo.add_node("sw")
    topo.add_duplex("ingress", "sw",
                    gbps if ingress_gbps is None else ingress_gbps,
                    latency_s)
    for n in _add_replicas(topo, nodes):
        topo.add_duplex("sw", n, gbps, latency_s)
    return topo


@register_topology("two-rack")
def two_rack(nodes: int = 4, gbps: float = 10.0,
             uplink_gbps=2.5, latency_s: float = 0.0) -> Topology:
    """``ingress -> core -> rack{0,1} -> n<i>``: nodes split evenly
    (first half on rack 0); the rack uplinks are the narrow links.
    ``uplink_gbps`` may be a scalar or a per-rack ``(r0, r1)`` pair —
    heterogeneous rack uplinks are how the benchmarks make topology
    blindness observable."""
    if int(nodes) < 2:
        raise ValueError("two-rack needs >= 2 nodes")
    up = tuple(uplink_gbps) if isinstance(uplink_gbps, (tuple, list)) \
        else (float(uplink_gbps), float(uplink_gbps))
    topo = Topology("two-rack", ingress="ingress")
    for n in ("ingress", "core", "rack0", "rack1"):
        topo.add_node(n)
    topo.add_duplex("ingress", "core", 2.0 * gbps, latency_s)
    topo.add_duplex("core", "rack0", up[0], latency_s)
    topo.add_duplex("core", "rack1", up[1], latency_s)
    names = _add_replicas(topo, nodes)
    half = (len(names) + 1) // 2
    for i, n in enumerate(names):
        topo.add_duplex("rack0" if i < half else "rack1", n,
                        gbps, latency_s)
    return topo


@register_topology("ring")
def ring(nodes: int = 4, gbps: float = 10.0,
         ingress_gbps: Optional[float] = None,
         latency_s: float = 0.0) -> Topology:
    """``n0 -> n1 -> ... -> n0`` duplex ring; ingress hangs off ``n0``,
    so far-side nodes pay multi-hop paths (hop count is what the
    shortest-hop router trades against link residuals)."""
    if int(nodes) < 2:
        raise ValueError("ring needs >= 2 nodes")
    topo = Topology("ring", ingress="ingress")
    topo.add_node("ingress")
    names = _add_replicas(topo, nodes)
    topo.add_duplex("ingress", names[0],
                    gbps if ingress_gbps is None else ingress_gbps,
                    latency_s)
    for i, n in enumerate(names):
        topo.add_duplex(n, names[(i + 1) % len(names)], gbps, latency_s)
    return topo


# ---------------------------------------------------------------------------
# The topology-aware router
# ---------------------------------------------------------------------------

@register_router("topo-aware")
class TopoAwareRouter(Router):
    """Route on PATH headroom: the bottleneck link's residual fair
    share from the ingress to each candidate node (what delivering one
    more request would actually get), with the generic worst-axis fit
    score breaking ties.  The :class:`~repro_torch.sched.cluster.ClusterRuntime`
    binds ``self.topology`` before each route; with none bound this
    degrades to ``least-loaded`` (and ``net-aware`` remains the
    deprecated per-node-counter shim, golden-pinned)."""

    uses_topology = True

    def route(self, demand, nodes, now=0.0):
        cands = [n for n in nodes if n.up] or list(nodes)
        topo = self.topology
        if topo is None or topo.ingress is None:
            return max(cands,
                       key=lambda n: (_fit_score(n, demand), -n.nid))

        def key(n):
            name = Topology.replica_name(n.nid)
            if not topo.has_node(name):
                res = 0.0                 # off-fabric node: last resort
            else:
                res = topo.path_residual_gbps(topo.ingress, name)
            return (res, _fit_score(n, demand), -n.nid)
        return max(cands, key=key)
