"""Observability: tracing + telemetry over the virtual-clock runtime.

Two small, dependency-free primitives the whole stack hooks into:

* ``trace``     — :class:`Tracer`: Chrome/Perfetto ``trace_event``
  JSON spans, instants, counters and async spans, stamped from the
  VIRTUAL clock (``ts = t * 1e6`` µs), so a seeded run emits a
  byte-identical trace on any machine.  :class:`NullTracer` is the
  disabled default; :func:`validate_chrome_trace` checks schema and
  span-nesting invariants before a trace is written.
* ``telemetry`` — :class:`Telemetry`: a plain counter / gauge /
  timeline registry.  Deterministic counts (events per kind, stale
  drops) live in ``counters``; wall-clock rates (events/sec) live ONLY
  in ``gauges`` so they can never leak into seed-pinned summaries.
* ``report``    — :func:`~repro_torch.obs.report.summarize`: rebuild the
  run's story from the trace alone (queueing / prefill / decode /
  transfer breakdown, per-node and per-link occupancy, goodput,
  migrations) — the library behind ``scripts/trace_report.py``.

Like ``repro_torch.sched.cluster``, this package imports nothing from
``repro_torch.core`` or ``repro_torch.serve`` (stdlib only), so the runtime can
import it without cycles.
"""
from repro_torch.obs.telemetry import Telemetry  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    NullTracer,
    Tracer,
    validate_chrome_trace,
)
