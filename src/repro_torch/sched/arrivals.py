"""Open-arrival workload generation.

The paper evaluates a closed batch (all jobs present at t=0); a runtime
system faces a continuous stream. This module turns an application
universe (``repro_torch.core.workloads``) into timed arrival streams:

* :func:`poisson_arrivals` — memoryless arrivals at a configurable rate
  with a per-class input-size mix (small/medium/large, paper Table 4)
  and optional per-app weighting.
* :func:`trace_arrivals`   — replay an explicit ``(t, app, size)`` trace
  (e.g. recorded from production) against the universe.

Streams are plain sorted lists of :class:`Arrival`; the simulator turns
each into a job whose turnaround is measured from its arrival time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.workloads import INPUT_SIZES_M_ITEMS, AppProfile

# default per-class mix: production streams skew small (many interactive
# queries) with a heavy tail of large analytics jobs
DEFAULT_SIZE_WEIGHTS: Dict[str, float] = {
    "small": 0.5, "medium": 0.35, "large": 0.15,
}


@dataclass(frozen=True)
class Arrival:
    t: float              # arrival time (s)
    app: AppProfile
    items: float          # input size in M-items
    tenant: Optional[str] = None  # owning tenant (fairness accounting)


@dataclass
class ArrivalConfig:
    rate_per_s: float = 0.02          # Poisson arrival rate (jobs/s)
    n_jobs: int = 20                  # stream length
    horizon_s: Optional[float] = None  # truncate the stream at this time
    size_weights: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_SIZE_WEIGHTS))
    app_weights: Optional[Sequence[float]] = None  # per-app mix (uniform)


def sample_input_size(rng: np.random.Generator,
                      size_weights: Optional[Dict[str, float]] = None
                      ) -> float:
    """Draw an input size (M-items) from the class mix over the paper's
    small/medium/large sizes (Table 4)."""
    weights = size_weights or DEFAULT_SIZE_WEIGHTS
    classes = [c for c in INPUT_SIZES_M_ITEMS if weights.get(c, 0.0) > 0]
    p = np.asarray([weights[c] for c in classes], float)
    p /= p.sum()
    cls = classes[int(rng.choice(len(classes), p=p))]
    return float(INPUT_SIZES_M_ITEMS[cls])


def poisson_arrivals(apps: Sequence[AppProfile], acfg: ArrivalConfig,
                     seed: Union[int, Sequence[int]] = 0,
                     tenant: Optional[str] = None) -> List[Arrival]:
    """Open Poisson stream: exponential inter-arrival gaps at
    ``rate_per_s``, app drawn from ``app_weights`` (uniform by default),
    size from the per-class mix. ``seed`` takes anything
    ``np.random.default_rng`` accepts (ints or int sequences).
    ``tenant`` stamps every arrival with an owning tenant (merge
    per-tenant streams with ``sorted(a + b, key=lambda x: x.t)``)."""
    if acfg.rate_per_s <= 0:
        raise ValueError("rate_per_s must be positive")
    rng = np.random.default_rng(seed)
    p = None
    if acfg.app_weights is not None:
        p = np.asarray(acfg.app_weights, float)
        if len(p) != len(apps):
            raise ValueError("app_weights length != number of apps")
        p = p / p.sum()
    out: List[Arrival] = []
    t = 0.0
    for _ in range(acfg.n_jobs):
        t += float(rng.exponential(1.0 / acfg.rate_per_s))
        if acfg.horizon_s is not None and t > acfg.horizon_s:
            break
        app = apps[int(rng.choice(len(apps), p=p))]
        out.append(Arrival(t, app, sample_input_size(rng,
                                                     acfg.size_weights),
                           tenant=tenant))
    return out


def trace_arrivals(trace: Sequence[Tuple],
                   apps: Sequence[AppProfile]) -> List[Arrival]:
    """Replay ``(t, app_name, size)`` rows; ``size`` is either a class
    name from the paper's Table 4 or an explicit M-items value.  Rows
    may carry a fourth element, the owning tenant name (or None)."""
    by_name = {a.name: a for a in apps}
    out: List[Arrival] = []
    for row in trace:
        t, name, size = row[0], row[1], row[2]
        tenant = row[3] if len(row) > 3 else None
        if name not in by_name:
            raise KeyError(f"unknown application {name!r}")
        items = INPUT_SIZES_M_ITEMS[size] if isinstance(size, str) \
            else float(size)
        out.append(Arrival(float(t), by_name[name], float(items),
                           tenant=None if tenant is None else str(tenant)))
    return sorted(out, key=lambda a: a.t)


def load_trace_jsonl(path: str,
                     apps: Sequence[AppProfile]) -> List[Arrival]:
    """Replay a recorded JSONL trace against an application universe —
    the entry point for real-cluster-log replay.

    Each non-blank line is an object with ``t`` (arrival seconds),
    ``app`` (a name in ``apps``), either ``items`` (explicit M-items)
    or ``size`` (a Table-4 class name: small/medium/large), and an
    optional ``tenant`` (owning tenant name for fairness accounting).
    Rows may be out of order in the file; the stream comes back
    time-sorted, via the same validation as :func:`trace_arrivals`."""
    import json

    rows: List[Tuple] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad JSON: {e}") from None
            if "t" not in rec or "app" not in rec:
                raise ValueError(
                    f"{path}:{ln}: trace rows need 't' and 'app'")
            if "items" in rec:
                size: Union[str, float] = float(rec["items"])
            elif "size" in rec:
                size = str(rec["size"])
                if size not in INPUT_SIZES_M_ITEMS:
                    raise ValueError(
                        f"{path}:{ln}: unknown size class {size!r} "
                        f"(known: {tuple(INPUT_SIZES_M_ITEMS)})")
            else:
                raise ValueError(
                    f"{path}:{ln}: trace rows need 'items' or 'size'")
            tenant = rec.get("tenant")
            rows.append((float(rec["t"]), str(rec["app"]), size,
                         None if tenant is None else str(tenant)))
    return trace_arrivals(rows, apps)
