"""Continuous-batching serving engine driven by step-level vector
admission — the serving-side runtime of the paper's co-location scheme.

The engine, batcher, queue, request and metrics modules are verbatim
copies of the JAX package's (numpy only); the model backend is
PyTorch.

* ``request`` — :class:`Request` lifecycle (queued/running/finished,
  evict-and-requeue-with-recompute preemption).
* ``queue``   — :class:`RequestQueue` over ``sched.arrivals`` streams
  with pluggable placement ordering.
* ``batcher`` — :class:`ContinuousBatcher`: per-step vector admission
  producing :class:`StepDecision` records.
* ``backends`` — :class:`Backend` and :class:`SimBackend` (virtual-time
  cost model for benchmarks/tests).
* ``paged``   — page-granular KV backends: :class:`PageAllocator`,
  :class:`PagedSimBackend` / :class:`DenseSimBackend`, and
  :class:`TorchPagedBackend` (chunked prefill + paged decode over a
  shared page pool, on the card through the CUDA paged-decode kernel).
* ``engine``  — :class:`Engine`: the serving loop over 1..N replicas.
* ``metrics`` — :class:`ServingMetrics`: TTFT / TPOT / goodput / SLO
  goodput / preemption rate.
"""
from repro_torch.serve.request import Request, RequestState  # noqa: F401
from repro_torch.serve.queue import (  # noqa: F401
    RequestQueue,
    requests_from_arrivals,
)
from repro_torch.serve.batcher import (  # noqa: F401
    ContinuousBatcher,
    PrefixCurve,
    ServingDemand,
    StepDecision,
)
from repro_torch.serve.backends import (  # noqa: F401
    Backend,
    SimBackend,
)
from repro_torch.serve.paged import (  # noqa: F401
    DenseSimBackend,
    PageAllocator,
    PagedSimBackend,
    TorchPagedBackend,
    pages_for,
)
from repro_torch.serve.engine import MODES, Engine  # noqa: F401
from repro_torch.serve.metrics import ServingMetrics  # noqa: F401
