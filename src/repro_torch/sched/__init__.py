"""Online scheduling subsystem: the paper's runtime, factored out.

Eight parts, shared by the cluster simulator (``core/simulator.py``) and
the serving driver (``launch/serve.py``):

* ``cluster``    — the event-driven :class:`ClusterRuntime` substrate:
  a virtual-clock :class:`EventLoop`, per-node booked-capacity
  :class:`Node` ledgers, :class:`ClusterState`, and the ``Router``
  registry (``single`` / ``least-loaded`` / ``net-aware`` /
  ``topo-aware``) that routes each admitted job/request to a node by
  its predicted multi-axis demand.  BOTH the batch simulator and the
  serving engine run on this one loop (``Simulator.run`` and
  single-replica ``Engine`` results are golden-pinned bit-identical to
  the pre-runtime paths).

* ``topology``   — the network as a first-class runtime citizen:
  :class:`Link` (fair-share bandwidth partitioning over a per-link
  in-flight ledger), :class:`Transmission` events on the same
  :class:`EventLoop`, :class:`Topology` presets
  (``single-switch`` / ``two-rack`` / ``ring`` via
  ``register_topology``), the ``topo-aware`` router (bottleneck-link
  residual path headroom), and measured ``net_probes()`` feeding the
  estimator registry.

* ``estimator``  — :class:`DemandEstimator` registry (``moe`` /
  ``oracle`` / ``single-family`` / ``ann`` / ``conservative`` /
  ``kv-growth``): ONE ``estimate(target, probes) -> DemandEstimate``
  entry point producing the full multi-axis demand model (predicted
  side-car curves included) with per-axis confidence and the
  conservative-fallback flag.  Selectable via ``SimConfig.estimator``,
  ``benchmarks/run.py --estimator``, ``launch/serve.py --estimator``.

* ``resources``  — :class:`ResourceVector` (named axes ``host_ram`` /
  ``cpu`` / ``hbm`` / ``net`` with ``+``/``-``/``fits``/``headroom``
  algebra) and :class:`DemandModel` (per-axis demand curves + fixed
  per-placement loads), so admission reasons about multiple resources
  jointly instead of one GB number.
* ``admission``  — :class:`AdmissionController`: predict -> two-point
  calibrate -> budget-inverse admission along the *binding axis* (min
  over per-axis inverses), plus the scheduler's budget-shading rules
  (safety margin, conservative fallback, OOM backoff).  The scalar
  ``admit(fn, budget_gb)`` API remains as a shim over single-axis
  vectors.
* ``placement``  — :class:`PlacementPolicy` registry (``fcfs`` /
  ``sjf`` / ``best-fit`` / ``arrival-aware``): queue ordering and
  host-scan order, extracted from the dispatcher and selectable per run.
* ``arrivals``   — open-arrival workload generation: Poisson or
  trace-driven arrival streams with per-class input-size mixes over an
  application universe, so the system runs as a continuously-fed queue
  rather than a batch at t=0.
* ``tenancy``    — multi-tenant fairness: :class:`Tenant` /
  :class:`TenantRegistry` (credit scores from live SLO / latency /
  reject signals, a per-(tenant, node) usage ledger), the ``drf``
  weighted-DRF router (dominant share over credit-coupled weight), and
  the per-node knapsack packer (:func:`pack_step`) the continuous
  batcher runs instead of greedy FIFO when a registry is bound.
* ``online``     — :class:`OnlineRefresher`: folds newly profiled
  arrivals back into a fitted :class:`~repro_torch.core.predictor.MoEPredictor`
  (KNN append + scaler-bound widening) without a refit.
* ``elastic``    — the elastic runtime: :class:`SlowdownCurve`
  (demand-vs-slowdown, fit from spill-model probes), the
  :class:`ElasticController` shrink-vs-wait-vs-reject policy behind
  ``AdmissionController.shrink_target``, deterministic
  :class:`FailureSchedule` fail/repair injection, and the
  queue/SLO-trend :class:`Autoscaler` with topology-aware spawn
  placement (:func:`pick_spawn_node`).
"""
from repro_torch.sched.resources import (  # noqa: F401
    AXES,
    MEMORY_AXES,
    DemandModel,
    ResourceVector,
    single_axis,
)
from repro_torch.sched.cluster import (  # noqa: F401
    ClusterRuntime,
    ClusterState,
    EventLoop,
    Node,
    Router,
    available_routers,
    get_router,
    register_router,
)
from repro_torch.sched.topology import (  # noqa: F401
    Link,
    TopoAwareRouter,
    Topology,
    Transmission,
    available_topologies,
    get_topology,
    register_topology,
)
from repro_torch.sched.admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
)
from repro_torch.sched.estimator import (  # noqa: F401
    DemandEstimate,
    DemandEstimator,
    JobTarget,
    ModelTarget,
    available_estimators,
    get_estimator,
    register_estimator,
    resolve_estimator,
    wrap_predictor,
)
from repro_torch.sched.placement import (  # noqa: F401
    PlacementPolicy,
    available_placements,
    get_placement,
    register_placement,
)
from repro_torch.sched.arrivals import (  # noqa: F401
    Arrival,
    ArrivalConfig,
    load_trace_jsonl,
    poisson_arrivals,
    trace_arrivals,
)
from repro_torch.sched.tenancy import (  # noqa: F401
    Tenant,
    TenantRegistry,
    WeightedDRFRouter,
    pack_step,
    request_origin,
)
from repro_torch.sched.elastic import (  # noqa: F401
    Autoscaler,
    ElasticController,
    ElasticDecision,
    FailureSchedule,
    SlowdownCurve,
    fit_slowdown_curve,
    pick_spawn_node,
    shrink_vector,
)
from repro_torch.sched.online import OnlineRefresher  # noqa: F401
