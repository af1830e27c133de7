"""Production serving driver: a thin CLI over the continuous-batching
engine (``repro_torch.serve``).

Admission routes through ``repro_torch.sched.AdmissionController`` — the SAME
predict -> two-point-calibrate -> budget-inverse controller the cluster
simulator's policies use — with requests as the work unit and the
serving footprint on the **hbm axis** of a
:class:`~repro_torch.sched.resources.ResourceVector` budget.  The default
``--mode continuous`` re-decides admission **every decode step**: new
prefills join the running batch when the binding-axis inverse says their
KV fits, finished requests retire immediately, and lowest-priority
requests are evicted-and-requeued (with recompute) when decode growth
would breach the budget.  ``--mode wave`` keeps the pre-engine
behaviour — one admission per wave against the worst-case footprint —
for comparison.

The serving footprint comes from the ``repro_torch.sched.estimator`` registry
(``--estimator kv-growth|conservative``): the ``kv-growth`` estimator
owns the per-``(config, max_len)`` two-point affine calibration cache;
``conservative`` pads the KV slope.  Passing ``--host-ram-gb`` adds a
second budgeted axis (pinned host staging memory per request), and
``--net-gbps`` a third (egress bandwidth per in-flight request — the
live ``net`` axis); the metrics report which axis bound each join.
Forced over-budget progress (a single request that does not fit) is
flagged on the decision and logged, never booked silently.

Queue order and preemption priority are pluggable via the
``repro_torch.sched.placement`` registry (``--placement
fcfs|sjf|best-fit|arrival-aware``): ``sjf`` serves short requests first,
shrinking padding and mean TTFT.

``--device`` picks where the model runs: ``cuda`` (the default) runs on
the card, and attention goes through the hand-written CUDA kernels
(paged decode; with ``--backend dense``, flash prefill and dense
decode); ``cpu`` runs the plain PyTorch versions and must be asked for.
There is no fallback: ``--device cuda`` without a card raises.

``--backend paged`` (default) serves over the page-granular KV backend:
fixed ``--page-size`` token blocks from a shared pool, per-request page
tables, and ``--prefill-chunk``-token prefill slices interleaved with
decode steps — requests join at any step, and admission books
page-quantized KV demand (the estimator carries ``page_size`` through
``ServingDemand``).  ``--backend dense`` keeps the slot-compacted cache
(shared position, full-prompt prefill stalls) for comparison.

``--replicas N`` serves over N replica Nodes on the shared
``repro_torch.sched.cluster`` runtime — each replica gets its own backend and
the full per-replica budget (``--replica-hbm 8,8,4`` makes the cell
heterogeneous), and arriving requests are routed by the ``--router``
registry entry (``single`` / ``least-loaded`` / ``net-aware`` /
``topo-aware``; the deprecated net-aware router spreads load over the
replicas' ``net``-axis headroom when ``--net-gbps`` budgets it).

``--tenants gold:2,bronze:1`` runs multi-tenant fairness
(``repro_torch.sched.tenancy``): requests cycle over the named tenants,
admission/eviction run the credit-scored weighted-DRF knapsack, and
``--router drf`` routes each request to the node where its tenant's
weighted dominant share stays lowest; a per-tenant summary table
(credit, goodput, SLO attainment, dominant share, rejects) prints at
exit.

``--topology two-rack`` binds a ``repro_torch.sched.topology`` preset: prompt
payloads ride real ingress :class:`Transmission` events
(``--ingress-gb-per-token``), the ``topo-aware`` router scores
bottleneck-link path headroom, ``--migrate`` lets preempted requests
move their KV to another replica when the modeled transfer beats local
recompute, and observed transmissions feed the estimator's measured net
curve after the run.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 8 --prompt-len 128 --decode-steps 32 --budget-gb 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.sched import (Autoscaler, ElasticController,
                               FailureSchedule, ModelTarget, ResourceVector,
                               Tenant, TenantRegistry, available_placements,
                               available_routers, available_topologies,
                               get_estimator, get_topology)
from repro_torch.serve import (Engine, Request, ServingDemand, TorchBackend,
                               TorchPagedBackend, pages_for)

#: estimators that make sense for a serving deployment (job-side ones
#: like moe/oracle need an AppProfile target)
SERVE_ESTIMATORS = ("kv-growth", "conservative")


def build_requests(args, rng: np.random.Generator, tenants=None):
    """Heterogeneous prompt/decode lengths make step-level membership
    churn real: short requests retire early (continuous mode backfills
    their slots), long prompts dominate padding (sjf shrinks it).
    With ``--tenants``, requests cycle round-robin over the tenant
    names so every tenant sees the same workload mix."""
    reqs = []
    names = [t.name for t in tenants] if tenants else None
    for i in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 1),
                                args.prompt_len + 1))
        new = int(rng.integers(max(args.decode_steps // 2, 1),
                               args.decode_steps + 1))
        arrival = float(i) / args.rate if args.rate > 0 else 0.0
        reqs.append(Request(rid=i, prompt_len=plen, max_new_tokens=new,
                            arrival=arrival,
                            tenant=names[i % len(names)]
                            if names else None))
    return reqs


def parse_tenants(spec: str):
    """``name:weight,name:weight,...`` (weight optional, default 1.0)
    into a Tenant list for the registry."""
    tenants = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        tenants.append(Tenant(name=name.strip(),
                              weight=float(weight) if weight else 1.0))
    return tenants


def main(argv=None) -> dict:
    """Serve ``argv`` (``sys.argv[1:]`` when None).  Returns the engine's
    summary, the engine, the backends and the wall time of
    ``engine.run()``: ``{"summary", "engine", "backends", "wall_s"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="continuous",
                    choices=("continuous", "wave"),
                    help="step-level admission vs legacy per-wave")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--budget-gb", type=float, default=1.0,
                    help="HBM budget for weights + KV")
    ap.add_argument("--host-ram-gb", type=float, default=0.0,
                    help="host staging budget (0 = unconstrained)")
    ap.add_argument("--host-ram-per-req-gb", type=float, default=0.05,
                    help="pinned host memory per in-flight request")
    ap.add_argument("--net-gbps", type=float, default=0.0,
                    help="egress bandwidth budget (0 = unconstrained)")
    ap.add_argument("--net-gbps-per-req", type=float, default=0.1,
                    help="egress bandwidth per in-flight request")
    ap.add_argument("--estimator", default="kv-growth",
                    choices=SERVE_ESTIMATORS,
                    help="demand estimator (repro_torch.sched.estimator "
                         "registry); conservative pads the KV slope")
    ap.add_argument("--placement", default="fcfs",
                    choices=available_placements(),
                    help="queue order + preemption priority "
                         "(sjf = short requests first)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="request arrival rate /s (0 = all at t=0)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--backend", default="paged",
                    choices=("paged", "dense"),
                    help="paged = block-granular KV + chunked prefill "
                         "(joins any step); dense = slot-compacted "
                         "cache (shared position)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (paged backend); "
                         "demand books page-quantized KV")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prefill chunk in tokens (paged backend): "
                         "prompts prefill in chunks interleaved with "
                         "decode steps")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas (each gets its own backend "
                         "and the full per-replica budget)")
    ap.add_argument("--router", default="single",
                    choices=available_routers(),
                    help="how arriving requests are routed to replicas "
                         "(repro_torch.sched.cluster registry)")
    ap.add_argument("--topology", default="",
                    choices=("",) + available_topologies(),
                    help="bind a network preset (repro_torch.sched.topology): "
                         "prompts ride real ingress Transmissions and "
                         "the topo-aware router scores path headroom; "
                         "'' = no fabric (bit-identical legacy "
                         "schedules)")
    ap.add_argument("--migrate", action="store_true",
                    help="preempted requests may migrate their KV to "
                         "another replica when the modeled transfer "
                         "beats local recompute (needs --topology; "
                         "real-cache model backends cannot adopt foreign "
                         "KV, so they always recompute)")
    ap.add_argument("--ingress-gb-per-token", type=float, default=0.0,
                    help="prompt payload GB per token staged from the "
                         "topology ingress (0 = prompts appear "
                         "instantly, pre-topology behaviour)")
    ap.add_argument("--replica-hbm", default="",
                    help="comma-separated per-replica HBM capacities in "
                         "GB, e.g. '8,8,4' — a heterogeneous cell "
                         "(must list exactly --replicas values; "
                         "overrides --budget-gb per node)")
    ap.add_argument("--tenants", default="",
                    help="comma-separated 'name:weight' tenant specs "
                         "(weight optional, default 1.0), e.g. "
                         "'gold:2,bronze:1' — requests cycle over the "
                         "tenants round-robin, the engine runs "
                         "credit-scored weighted-DRF fairness (pair "
                         "with --router drf), and a per-tenant summary "
                         "table prints at exit; '' = untenanted "
                         "(bit-identical legacy schedules)")
    ap.add_argument("--elastic", action="store_true",
                    help="spill-aware shrunken joins: a request that "
                         "does not fit may be admitted at a memory "
                         "fraction its demand-vs-slowdown curve prices "
                         "under --elastic-max-slowdown (the spilled "
                         "remainder is paid as decode-step slowdown); "
                         "off = bit-identical legacy admission")
    ap.add_argument("--elastic-max-slowdown", type=float, default=2.5,
                    help="largest modeled slowdown a shrunken "
                         "admission may pay (the ElasticController "
                         "cap)")
    ap.add_argument("--failures", type=float, default=0.0,
                    help="inject deterministic replica failures with "
                         "this mean-time-between-failures in virtual "
                         "seconds (0 = off); failed replicas drain "
                         "through migrate-vs-recompute and repair "
                         "after --repair-s")
    ap.add_argument("--repair-s", type=float, default=1.0,
                    help="virtual seconds a failed replica stays down")
    ap.add_argument("--failure-horizon-s", type=float, default=30.0,
                    help="failures are drawn on [0, horizon) virtual "
                         "seconds")
    ap.add_argument("--autoscale", type=int, default=0,
                    help="autoscale the fleet up to this many replicas "
                         "from queue-depth and SLO-attainment trends "
                         "(0 = off; spares above --replicas are "
                         "pre-provisioned down and spawned "
                         "topology-aware)")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.25,
                    help="autoscaler observation cadence in virtual "
                         "seconds")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace_event JSON of "
                         "the run to this path (virtual-clock spans: "
                         "steps, prefill/decode, transfers, request "
                         "lifecycles; open at https://ui.perfetto.dev "
                         "or summarize with scripts/trace_report.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs: cuda (the card, with the "
                         "CUDA attention kernels) or cpu (plain PyTorch); "
                         "no fallback from one to the other")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass "
                           "--device cpu to serve on the CPU")

    cfg = get_config(args.arch, smoke=args.smoke)
    max_len = args.prompt_len + args.decode_steps + 1

    page_size = args.page_size if args.backend == "paged" else 1
    estimator = get_estimator(args.estimator)
    estimate = estimator.estimate(ModelTarget(
        cfg, max_len,
        host_ram_per_req_gb=args.host_ram_per_req_gb
        if args.host_ram_gb > 0.0 else 0.0,
        net_gbps_per_req=args.net_gbps_per_req
        if args.net_gbps > 0.0 else 0.0,
        page_size=page_size))
    if estimate.conservative:
        print(f"estimator {args.estimator!r}: conservative estimate "
              f"(KV slope padded x{estimate.info.get('pad')})")
    demand = ServingDemand.from_estimate(estimate, max_len)
    budget_axes = {"hbm": float(args.budget_gb)}
    if args.host_ram_gb > 0.0:
        budget_axes["host_ram"] = float(args.host_ram_gb)
    if args.net_gbps > 0.0:
        budget_axes["net"] = float(args.net_gbps)
    budget = ResourceVector(**budget_axes)

    elastic = ElasticController(
        max_slowdown=args.elastic_max_slowdown) if args.elastic \
        else None
    failures = None
    if args.failures > 0.0:
        if args.mode != "continuous":
            ap.error("--failures needs --mode continuous")
        failures = FailureSchedule.poisson(
            seed=args.seed, mtbf_s=args.failures,
            n_targets=args.replicas,
            horizon_s=args.failure_horizon_s,
            repair_s=args.repair_s)
    autoscaler = None
    fleet = args.replicas
    if args.autoscale > 0:
        if args.mode != "continuous":
            ap.error("--autoscale needs --mode continuous")
        if args.autoscale < args.replicas:
            ap.error(f"--autoscale {args.autoscale} is below "
                     f"--replicas {args.replicas}")
        autoscaler = Autoscaler(max_replicas=args.autoscale,
                                min_replicas=args.replicas,
                                interval_s=args.autoscale_interval_s)
        # the whole elastic fleet is pre-provisioned: spares idle as
        # down Nodes (and topology racks) until a scale-up flips one
        fleet = args.autoscale

    budgets = None
    if args.replica_hbm:
        hbm = [float(v) for v in args.replica_hbm.split(",")]
        if len(hbm) != fleet:
            ap.error(f"--replica-hbm lists {len(hbm)} values for a "
                     f"fleet of {fleet} (--replicas, or --autoscale "
                     f"when set)")
        budgets = [ResourceVector(**{**budget_axes, "hbm": h})
                   for h in hbm]

    topology = None
    if args.topology:
        topology = get_topology(args.topology, nodes=fleet)
    elif args.migrate:
        ap.error("--migrate needs --topology")

    tenancy = None
    tenant_list = None
    if args.tenants:
        tenant_list = parse_tenants(args.tenants)
        if not tenant_list:
            ap.error("--tenants given but no tenant specs parsed")
        tenancy = TenantRegistry(tenant_list)

    rng = np.random.default_rng(args.seed)
    requests = build_requests(args, rng, tenants=tenant_list)
    if args.backend == "paged":
        # pool sized so max_batch worst-case requests can reserve, +1
        # for the scratch page
        num_pages = 1 + args.max_batch * pages_for(max_len, page_size)
        backends = [TorchPagedBackend(cfg, num_pages=num_pages,
                                      page_size=page_size,
                                      prefill_chunk=args.prefill_chunk,
                                      seed=args.seed + r,
                                      device=args.device)
                    for r in range(fleet)]
    else:
        backends = [TorchBackend(cfg, max_len=max_len, seed=args.seed + r,
                                 device=args.device)
                    for r in range(fleet)]
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    engine = Engine(requests, demand, budget, mode=args.mode,
                    placement=args.placement, max_batch=args.max_batch,
                    replicas=args.replicas, router=args.router,
                    backends=backends, topology=topology,
                    migrate=args.migrate,
                    ingress_gb_per_token=args.ingress_gb_per_token,
                    budgets=budgets, tracer=tracer, tenants=tenancy,
                    elastic=elastic, failures=failures,
                    autoscaler=autoscaler)

    axes = ", ".join(
        f"{a}={v:.3g}" + ("Gbps" if a == "net" else "GB")
        for a, v in budget.items())
    kind = (f"paged (page={page_size}, chunk={args.prefill_chunk})"
            if args.backend == "paged" else "dense (slot-compacted cache)")
    dev = (torch.cuda.get_device_name(0) if args.device == "cuda"
           else "cpu")
    print(f"serving {args.requests} requests on {dev}, mode={args.mode}, "
          f"backend={kind}, placement={args.placement}, "
          f"replicas={args.replicas} (router={args.router}), "
          f"budget/replica [{axes}]")
    if budgets is not None:
        caps = " ".join(f"n{i}:{b['hbm']:.3g}GB"
                        for i, b in enumerate(budgets))
        print(f"heterogeneous cell [{caps}]")
    if topology is not None:
        print(f"topology {args.topology!r} bound "
              f"(migrate={'on' if args.migrate else 'off'}, "
              f"ingress {args.ingress_gb_per_token:.3g} GB/token)")
    if tenancy is not None:
        specs = " ".join(f"{t.name}:{t.weight:g}" for t in tenant_list)
        print(f"tenancy [{specs}] (credit-scored weighted-DRF; "
              f"router={args.router!r})")
    if elastic is not None or failures is not None \
            or autoscaler is not None:
        bits = []
        if elastic is not None:
            bits.append(f"shrink cap x{args.elastic_max_slowdown:g}")
        if failures is not None:
            bits.append(f"failures mtbf={args.failures:g}s "
                        f"({len(failures.failures)} drawn, "
                        f"repair {args.repair_s:g}s)")
        if autoscaler is not None:
            bits.append(f"autoscale {args.replicas}->{args.autoscale} "
                        f"(every {args.autoscale_interval_s:g}s)")
        print(f"elastic runtime: {', '.join(bits)}")
    t0 = time.time()
    summary = engine.run()
    wall = time.time() - t0
    print(engine.metrics.format_summary(summary))
    if args.replicas > 1:
        spread = " ".join(f"n{n}:{c}" for n, c in
                          sorted(summary["node_steps"].items()))
        print(f"router {args.router!r} step spread [{spread}]")
    if summary["forced_steps"]:
        # forced progress is observable, not silent: some step ran a
        # single request whose footprint alone exceeds the budget
        print(f"WARNING: {summary['forced_steps']} step(s) forced over "
              f"budget (single-request floor); expect paging/"
              f"preemption risk")
    tot = summary["good_tokens"]
    print(f"served {summary['completed']} requests / {tot} tokens in "
          f"{wall:.1f}s wall ({tot / max(wall, 1e-9):.1f} tok/s wall, "
          f"{summary['goodput_tok_s']:.1f} tok/s virtual)")
    if tenancy is not None and summary["tenants"]:
        print(f"{'tenant':<12} {'weight':>6} {'credit':>6} "
              f"{'done':>6} {'goodput':>9} {'slo':>6} "
              f"{'share':>7} {'rejects':>8}")
        for name, st in summary["tenants"].items():
            t = tenancy.get(name)
            rej = sum(st["rejects"].values())
            print(f"{name:<12} {t.weight:>6g} "
                  f"{tenancy.credit(name):>6.2f} "
                  f"{st['completed']:>3}/{st['requests']:<3}"
                  f"{st['goodput_tok_s']:>8.1f} "
                  f"{st['slo_attainment']:>6.2f} "
                  f"{st['dominant_share_mean']:>7.3f} {rej:>8}")
    if summary.get("elastic"):
        el = summary["elastic"]
        ev = " ".join(f"{k}:{n}" for k, n in
                      sorted(el["replica_events"].items())) or "-"
        print(f"elastic: {el['shrunk_joins']} shrunken join(s), "
              f"replica events [{ev}]")
    if tracer is not None:
        tracer.dump(args.trace)
        print(f"trace: {len(tracer)} events -> {args.trace} "
              f"(summarize: python scripts/trace_report.py "
              f"{args.trace})")
    if args.backend == "paged":
        waste = np.mean([be.waste_ratio() for be in backends])
        print(f"paged KV: {waste:.1%} of resident page slots held no "
              f"live token (a dense cache would hold the full "
              f"batch*max_len grid)")
    if topology is not None:
        print(f"network: {summary['migrations']} KV migration(s), "
              f"{len(topology.completed())} transmission(s) completed")
        probes = topology.net_probes()
        if len(probes) >= 2:
            # feed observed (GB, duration) pairs back through the
            # estimator: the measured net curve replaces the declared
            # per-request constant on the next estimate
            measured = estimator.estimate(ModelTarget(
                cfg, max_len,
                net_gbps_per_req=args.net_gbps_per_req
                if args.net_gbps > 0.0 else 0.0,
                page_size=page_size, net_probes=probes))
            info = measured.info.get("net_measured")
            if info:
                print(f"measured net curve from {info['n_probes']} "
                      f"probe(s): {info['gbps_per_req']:.3g} Gbps/req "
                      f"({info['family']}, conf="
                      f"{measured.confidence.get('net', 0.0):.2f}) vs "
                      f"declared {args.net_gbps_per_req:.3g}")
    return {"summary": summary, "engine": engine, "backends": backends,
            "wall_s": wall}


if __name__ == "__main__":
    main()
