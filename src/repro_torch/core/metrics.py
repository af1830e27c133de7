"""Scenario runner + STP/ANTT aggregation (paper Section 5.2/5.3).

Scenarios L1..L10 mix 2..30 randomly-selected applications; each scenario
runs ``n_mixes`` different mixes; results are geometric-mean aggregated;
min/max preserved for the error bars of Fig. 6.

Open-arrival extension: :func:`run_open_scenario` feeds the simulator a
continuous (Poisson/trace) stream instead of a batch and
:func:`windowed_metrics` reports STP/ANTT per completion-time window, so
a long-running cluster's throughput can be watched over time rather than
summarized once at drain.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.core.workloads import INPUT_SIZES_M_ITEMS, AppProfile

SCENARIOS = {  # paper Table 3
    "L1": 2, "L2": 6, "L3": 7, "L4": 9, "L5": 11,
    "L6": 13, "L7": 19, "L8": 23, "L9": 26, "L10": 30,
}


def gmean(xs) -> float:
    xs = np.asarray(xs, float)
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-12)))))


def make_mix(apps: List[AppProfile], n_jobs: int,
             rng: np.random.Generator) -> List:
    """Random app mix with random input sizes (small/medium/large)."""
    chosen = rng.choice(len(apps), size=n_jobs,
                        replace=n_jobs > len(apps))
    sizes = list(INPUT_SIZES_M_ITEMS.values())
    return [(apps[i], float(sizes[rng.integers(len(sizes))]))
            for i in chosen]


@dataclass
class ScenarioResult:
    stp_gmean: float
    antt_gmean: float
    antt_reduction_mean: float   # vs the serial one-by-one baseline
    stp_min: float
    stp_max: float
    antt_min: float
    antt_max: float
    oom_total: int
    # axis -> count of admission decisions that axis bound ("cap" = the
    # Spark chunk / remaining-work cap), summed over mixes — the
    # observability hook for multi-axis (vector-budget) scenarios
    binding_axes: Dict[str, int] = None


def _merge_counts(total: Dict[str, int], part: Dict[str, int]) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def run_scenario(apps: List[AppProfile], policy_factory, n_jobs: int,
                 n_mixes: int = 20, cfg: Optional[SimConfig] = None,
                 seed: int = 0) -> ScenarioResult:
    """policy_factory: (mix_seed) -> Policy (fresh per mix so predictors
    can be LOOCV-refit when needed)."""
    cfg = cfg or SimConfig()
    stps, antts, reds, ooms = [], [], [], 0
    binding: Dict[str, int] = {}
    for mix in range(n_mixes):
        rng = np.random.default_rng([seed, mix, n_jobs])
        jobs = make_mix(apps, n_jobs, rng)
        policy = policy_factory(mix)
        sim = Simulator(jobs, policy, cfg, seed=seed * 1000 + mix)
        out = sim.run()
        stps.append(out["stp"])
        antts.append(out["antt"])
        reds.append(out["antt_reduction"])
        ooms += out["oom_count"]
        _merge_counts(binding, out["binding_axes"])
    return ScenarioResult(
        stp_gmean=gmean(stps), antt_gmean=gmean(antts),
        antt_reduction_mean=float(np.mean(reds)),
        stp_min=float(np.min(stps)), stp_max=float(np.max(stps)),
        antt_min=float(np.min(antts)), antt_max=float(np.max(antts)),
        oom_total=ooms, binding_axes=binding)


def windowed_metrics(result: Dict, window_s: float) -> List[Dict]:
    """Per-window STP/ANTT over an (open-arrival) simulator result.

    Jobs are bucketed by COMPLETION time; each window reports the STP
    (sum of c_iso/turnaround) and ANTT (mean turnaround/c_iso) of the
    jobs it retired, plus the in-flight count at the window edge. The
    final window also carries an ``unfinished`` count (jobs that never
    completed before the run ended)."""
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    arr = np.asarray(result["arrivals"], float)
    fin = np.asarray([np.nan if f is None else f
                      for f in result["finish_times"]], float)
    c_is = np.asarray(result["c_is"], float)
    if len(arr) == 0:
        return []
    # windows must span the LAST event of either kind — truncating at
    # the last completion would hide late arrivals from arrived/in_flight
    t_end = float(arr.max())
    if np.any(np.isfinite(fin)):
        t_end = max(t_end, float(np.nanmax(fin)))
    n_win = max(int(math.ceil((t_end + 1e-9) / window_s)), 1)
    out: List[Dict] = []
    for w in range(n_win):
        t0, t1 = w * window_s, (w + 1) * window_s
        done = np.isfinite(fin) & (fin >= t0) & \
            (fin < t1 if w < n_win - 1 else fin <= t1 + 1e-9)
        turn = fin[done] - arr[done]
        in_flight = int(np.sum((arr <= t1)
                               & (~np.isfinite(fin) | (fin > t1))))
        out.append({
            "t0": t0, "t1": t1, "completed": int(done.sum()),
            "stp": float(np.sum(c_is[done] / np.maximum(turn, 1e-12))),
            "antt": float(np.mean(turn / np.maximum(c_is[done], 1e-12)))
            if done.any() else 0.0,
            "arrived": int(np.sum((arr >= t0) & (arr < t1))),
            "in_flight": in_flight,
        })
    out[-1]["unfinished"] = int(np.sum(~np.isfinite(fin)))
    return out


def run_open_scenario(apps: List[AppProfile], policy_factory,
                      arrival_cfg, n_streams: int = 4,
                      cfg: Optional[SimConfig] = None, seed: int = 0,
                      window_s: Optional[float] = None) -> Dict:
    """Open-arrival counterpart of :func:`run_scenario`: ``n_streams``
    independent Poisson streams over the app universe, gmean-aggregated
    overall STP/ANTT plus (optionally) per-window traces."""
    from repro_torch.sched.arrivals import poisson_arrivals
    cfg = cfg or SimConfig()
    stps, antts, ooms = [], [], 0
    windows: List[List[Dict]] = []
    binding: Dict[str, int] = {}
    unfinished = empty_streams = 0
    for stream in range(n_streams):
        # workload and simulator randomness must be INDEPENDENT — the
        # same integer would seed identical bitstreams for both
        arrivals = poisson_arrivals(apps, arrival_cfg,
                                    seed=[seed, stream])
        if not arrivals:
            # a horizon-truncated empty stream has no jobs to score;
            # folding its stp=0 into the gmean would collapse the
            # aggregate to ~0 for every policy
            empty_streams += 1
            continue
        policy = policy_factory(stream)
        sim = Simulator(None, policy, cfg, seed=seed * 1000 + stream,
                        arrivals=arrivals)
        res = sim.run()
        unfinished += res["unfinished"]
        stps.append(res["stp"])
        antts.append(res["antt"])
        ooms += res["oom_count"]
        _merge_counts(binding, res["binding_axes"])
        if window_s is not None:
            windows.append(windowed_metrics(res, window_s))
    if not stps:
        raise ValueError(
            f"all {n_streams} arrival streams were empty — raise "
            f"rate_per_s/n_jobs or widen horizon_s")
    return {"stp_gmean": gmean(stps), "antt_gmean": gmean(antts),
            "stp_min": float(np.min(stps)), "stp_max": float(np.max(stps)),
            "oom_total": ooms, "unfinished_total": unfinished,
            "empty_streams": empty_streams, "windows": windows,
            "binding_axes": binding}


def run_all_scenarios(apps, policy_factories: Dict[str, object],
                      scenarios: Optional[Sequence[str]] = None,
                      n_mixes: int = 20, cfg: Optional[SimConfig] = None,
                      seed: int = 0) -> Dict[str, Dict[str, ScenarioResult]]:
    """-> {policy: {scenario: ScenarioResult}}."""
    scenarios = list(scenarios or SCENARIOS)
    out: Dict[str, Dict[str, ScenarioResult]] = {}
    for pname, factory in policy_factories.items():
        out[pname] = {}
        for sc in scenarios:
            out[pname][sc] = run_scenario(
                apps, factory, SCENARIOS[sc], n_mixes, cfg, seed)
    return out
