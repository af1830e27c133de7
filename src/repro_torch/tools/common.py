"""What the port's tools share: ``name,value,derived`` rows, result files,
the bench environment, a timer and the port's dry-run records.

The port's own copy of what they need from ``benchmarks/common.py``:
results go to ``results/bench_torch_<name>.json``, and the dry-run
records read are the port's (``repro_torch.launch.dryrun``'s
``results/dryrun.json``), never the JAX dry-run's.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "results")
N_MIXES = int(os.environ.get("REPRO_BENCH_MIXES", "8"))
# tiny n_jobs/n_hosts/n_mixes everywhere: an end-to-end pass over the
# plumbing, not a measurement
SMOKE = os.environ.get("REPRO_BENCH_SMOKE", "") == "1"
#: ``python -m repro_torch.launch.dryrun``'s default ``--out``
DRYRUN_JSON = os.path.join(RESULTS_DIR, "dryrun.json")


def load_dryrun(path: str = DRYRUN_JSON) -> Optional[dict]:
    """The port's dry-run records at ``path``, or None without a file."""
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def emit(name: str, value, derived: str = ""):
    print(f"{name},{value},{derived}")


def save_result(bench: str, payload: dict):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"bench_torch_{bench}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, repeats: int = 3, **kw):
    """Median host seconds of ``repeats`` calls after one warm-up call,
    the card synchronised before each clock read."""
    fn(*args, **kw)  # warmup
    ts = []
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device(name: str) -> torch.device:
    """``--device``: the card (``cuda``, which raises without one: no
    tool falls back to the CPU) or ``cpu``."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run on the CPU")
    return dev
